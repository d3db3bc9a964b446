# Copied from src/repro/models/__init__.py (the ported names only).
from repro_torch.models.api import (  # noqa: F401
    decode_step, init_cache, init_params,
)
