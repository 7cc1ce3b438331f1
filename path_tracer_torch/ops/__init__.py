"""Elementwise ops, intersection and the CUDA kernels' wrappers."""
