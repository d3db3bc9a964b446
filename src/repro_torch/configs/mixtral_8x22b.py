# Copied from src/repro/configs/mixtral_8x22b.py; imports point at repro_torch.
"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088; hf].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768."""
from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768, moe=MoECfg(8, 2), window=4096,
    rope_theta=1e6, tie_embeddings=False,
    notes="SWA window 4096 => long_500k runs with a rolling KV cache. "
          "8 experts < 16-way model axis: TP inside experts (DESIGN.md §5).",
)
