"""Fused operators: a hand-written CUDA kernel for CUDA tensors and its plain
PyTorch version for CPU tensors, side by side."""
