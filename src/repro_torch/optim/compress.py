# Ported from src/repro/optim/compress.py (jax -> torch).
"""Int8 gradient compression with error feedback.

* ``quantize_ef`` — the pure transform: int8-quantize (per-leaf scale) with
  an error-feedback accumulator so the quantization error is re-injected
  next step.
* ``compressed_psum`` — the reference's collective building block (a shared
  scale by one max-reduction, then the int8 payload summed in int32).  It
  needs a process group and waits for the multi-device slice (ROADMAP,
  Queue 1 item 8b); here it raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map, unzip


def _q(x, scale):
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_ef(grads, err):
    """(grads, err) -> (dequantized grads, new err).  err is a dictionary
    like grads, fp32."""
    def one(g, e):
        g32 = g.float() + e
        scale = torch.clamp(torch.max(torch.abs(g32)) / 127.0, min=1e-12)
        deq = _q(g32, scale).float() * scale
        return deq.to(g.dtype), g32 - deq

    return unzip(tree_map(one, grads, err), 2)


def init_error(grads_like):
    """Zero fp32 error accumulators shaped like ``grads_like``, on its
    tensors' devices."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def compressed_psum(g, axis_name: str, err):
    raise NotImplementedError(
        "compressed_psum needs a process group: it waits for the "
        "multi-device slice (ROADMAP, Queue 1 item 8b)")
