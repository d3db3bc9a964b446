"""Hand-written CUDA kernels (``csrc/``) with their launchers and plain
PyTorch versions."""
