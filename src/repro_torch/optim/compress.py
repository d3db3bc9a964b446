# Ported from src/repro/optim/compress.py (jax -> torch).
"""Int8 gradient compression with error feedback.

* ``quantize_ef`` — the pure transform: int8-quantize (per-leaf scale) with
  an error-feedback accumulator so the quantization error is re-injected
  next step.
* ``compressed_psum`` — the collective building block on a process group:
  quantize local grads against a shared scale, all-reduce the int8 payload
  in int32, dequantize.  4x less traffic than an fp32 all-reduce where the
  wire carries int8 (plus one scalar).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as fc

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


def compressed_psum(g, group, err):
    """The int8 all-reduce of one local gradient tensor with error feedback
    over ``group`` (a process group: the reference's ``axis_name``).
    Returns (mean gradient in ``g``'s dtype, new fp32 error).

    Every rank must quantize against a SHARED scale or the int8 sum is
    meaningless: one max all-reduce fixes the codebook, then the int8
    payload reduces in int32 — the reference's arithmetic, in its order."""
    g32 = g.float() + err
    scale = fc.all_reduce(
        torch.clamp(torch.max(torch.abs(g32)) / 127.0, min=1e-12), "max",
        group)
    q = _q(g32, scale)
    new_err = g32 - q.float() * scale
    total = fc.all_reduce(q.to(torch.int32), "sum", group).float()
    mean = total * scale / float(dist.get_world_size(group))
    return mean.to(g.dtype), new_err
