# Copied from src/repro/configs/llama3_405b.py; imports point at repro_torch.
"""llama3-405b [dense] — GQA, 128k vocab [arXiv:2407.21783; unverified].

126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab=128256, rope_theta=5e5, tie_embeddings=False,
    remat_policy="full",  # dots-saveable holds 53k-wide hiddens: 894 GiB temp
                          # vs 46 GiB with full remat (§Perf, per-arch knob)
    notes="Training on one 256-chip v5e pod requires ZeRO-1 + bf16 optimizer "
          "moments + grad accumulation (EXPERIMENTS.md §Dry-run).",
)
