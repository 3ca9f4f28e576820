"""Kernels of the port: each a hand-written CUDA kernel beside its plain
PyTorch version."""
