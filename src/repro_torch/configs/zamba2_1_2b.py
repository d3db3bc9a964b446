# Copied from src/repro/configs/zamba2_1_2b.py; imports point at repro_torch.
"""zamba2-1.2b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242; hf].

38L d_model=2048 32H (kv=32 => MHA) d_ff=8192 vocab=32000, ssm_state=64.
38 mamba2 blocks with ONE shared-weight attention+MLP block applied every
6th layer (distinct per-application LayerNorm + rank-64 LoRA on the shared
projections, following the Zamba2 paper's shared-block design)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, ssm_state=64,
    shared_attn_every=6, shared_attn_lora_rank=64,
)
