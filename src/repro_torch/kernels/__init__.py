"""Kernels of the serving path: CUDA sources, their wrappers and plain versions."""
