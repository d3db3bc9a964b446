# Copied from src/repro/configs/mixtral_8x7b.py; imports point at repro_torch.
"""mixtral-8x7b [moe] — 8 experts top-2, SWA [arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000."""
from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, moe=MoECfg(8, 2), window=4096,
    rope_theta=1e6, tie_embeddings=False,
)
