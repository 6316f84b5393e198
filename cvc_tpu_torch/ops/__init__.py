"""Numeric ops of the port: plain PyTorch primitives, dispatch, and the
hand-written CUDA kernels (`ops/kernels`)."""
