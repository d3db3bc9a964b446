# Copied from src/repro/configs/xlstm_1_3b.py; imports point at repro_torch.
"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304.  d_ff=0: the mLSTM block
carries its own 2x up-projection.  An sLSTM block every 8th layer ([7:1]
flavor); mLSTM uses the chunked-parallel linear-recurrence form, sigmoid
gating (exponential-gating stabilizer omitted — DESIGN.md §5)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, slstm_every=8, tie_embeddings=True,
)
