"""The benchmark of path_tracer_torch (see README.md)."""
