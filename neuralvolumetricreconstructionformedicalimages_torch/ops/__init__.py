"""Tensor ops: hash-grid index math, the CUDA encoder kernels and their
plain PyTorch versions, ray sampling and Beer-Lambert integration."""
