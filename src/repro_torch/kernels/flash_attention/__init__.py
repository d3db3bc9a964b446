"""Causal GQA flash attention (CUDA, ``csrc/``)."""
