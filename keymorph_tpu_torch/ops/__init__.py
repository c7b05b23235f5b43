"""Tensor operations of the port (plain PyTorch; kernels under ``ops/cuda``)."""
