# Copied from src/repro/configs/qwen2_vl_7b.py; imports point at repro_torch.
"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.  Backbone only:
the ViT frontend is a stub; input_specs() supplies precomputed patch
embeddings occupying the first n_patches positions, with 3-section M-RoPE
(temporal/height/width) position ids."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064, mrope=True, rope_theta=1e6,
    n_patches=1024, tie_embeddings=False,
)
