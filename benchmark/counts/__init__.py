"""Operation and byte counts behind the kernel rooflines."""
