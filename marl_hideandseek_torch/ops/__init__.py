"""Kernel wrappers: CUDA launches for CUDA tensors, plain PyTorch for CPU."""
