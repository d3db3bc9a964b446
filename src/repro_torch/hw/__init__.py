# Copied from src/repro/hw/__init__.py; imports point at repro_torch.
"""Device models: the hardware parameters that drive tiling, fusion-capacity
checks and the cycle simulator.

The paper's accelerator (Angel-Eye-derived, ZU2/ZU9) and the other targets are
described by the same small set of numbers, so the whole compiler stack is
hardware-parameterized (DESIGN.md §2).
"""
from repro_torch.hw.device import (H100, TPU_V5E, ZU2, ZU9, DeviceModel,
                                   get_device)

__all__ = ["DeviceModel", "ZU2", "ZU9", "TPU_V5E", "H100", "get_device"]
