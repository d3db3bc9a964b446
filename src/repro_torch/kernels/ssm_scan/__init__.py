"""Chunked linear-recurrence scan (CUDA, ``csrc/``)."""
