# Copied from src/repro/configs/smollm_360m.py; imports point at repro_torch.
"""smollm-360m [dense] — llama-arch small [hf:HuggingFaceTB/SmolLM; hf].

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152, rope_theta=1e4,
    notes="15 heads are not divisible by the 16-way model axis: attention "
          "weights replicate, FFN/vocab still TP-shard (DESIGN.md §5).",
)
