# Copied from src/repro/configs/seamless_m4t_large_v2.py; imports point at repro_torch.
"""seamless-m4t-large-v2 [audio] — enc-dec multimodal [arXiv:2308.11596; hf].

24L d_model=1024 16H (kv=16 => MHA) d_ff=8192 vocab=256206.  Speech frontend
is a stub: input_specs() supplies precomputed frame embeddings (B, S_enc,
1024).  24 encoder + 24 decoder layers (per-stack depth; DESIGN.md §5).
Shape mapping: train_4k = enc 2048 frames + dec 2048 tokens; prefill_32k =
enc 28672 + dec 4096; decode_32k = decoder KV 32768, cross-attn to 4096
encoder frames."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, enc_layers=24, act="gelu",
    tie_embeddings=False,
)
