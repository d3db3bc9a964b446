# Copied from src/repro/zoo/__init__.py; imports point at repro_torch.
"""Content-addressed on-disk store of compiled model artifacts."""
from repro_torch.zoo.store import ModelZoo

__all__ = ["ModelZoo"]
