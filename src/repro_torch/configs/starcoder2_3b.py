# Copied from src/repro/configs/starcoder2_3b.py; imports point at repro_torch.
"""starcoder2-3b [dense] — GQA, RoPE [arXiv:2402.19173; hf].

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab=49152, act="gelu", rope_theta=1e5,
    tie_embeddings=True,
    notes="StarCoder2 uses a plain (non-gated) GELU MLP; kv=2.",
)
