# Ported from src/repro/optim/__init__.py (imports point at repro_torch).
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
