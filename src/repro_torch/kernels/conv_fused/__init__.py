"""Fused int8 conv-chain and horizontal conv kernels (CUDA, ``csrc/``)."""
from repro_torch.kernels.conv_fused.ops import (  # noqa: F401
    fused_conv_block, supports)
