"""Fused int8 conv-chain and horizontal conv kernels (CUDA, ``csrc/``)."""
