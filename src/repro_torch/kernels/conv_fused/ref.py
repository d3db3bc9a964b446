"""Plain oracle for a single fused conv block (port of
``src/repro/kernels/conv_fused/ref.py``).

Composes the ``int8_ops`` semantics exactly as the unfused executor would.
"""
from __future__ import annotations

from repro_torch.core import int8_ops


def fused_conv_ref(x, w, b, *, stride, pad, shift, relu,
                   pool=None, eltwise=None):
    """x (N,H,W,IC) int8 unpadded; w (KH,KW,IC,OC) int8; b (OC,) int32.

    pool:    None | (kp, sp)  fused maxpool (VALID, no ceil extension).
    eltwise: None | (side int8 at OH/OW/OC, s_conv, s_side, relu_out).
    """
    y = int8_ops.conv2d(x, w, b, stride=stride, pad=pad, shift=shift,
                        relu=relu)
    if pool is not None:
        kp, sp = pool
        y = int8_ops.maxpool(y, kernel=(kp, kp), stride=(sp, sp), pad=(0, 0),
                             ceil_mode=False)
    if eltwise is not None:
        side, s_conv, s_side, relu_out = eltwise
        acc = (int8_ops.round_shift(y, s_conv)
               + int8_ops.round_shift(side, s_side))
        if relu_out:
            acc = acc.clamp(min=0)
        y = int8_ops.sat8(acc)
    return y
