# Ported from src/repro/optim/adamw.py (jax -> torch).
"""AdamW with configurable moment storage dtype, as a function over the
parameter dictionary (not ``torch.optim.AdamW``, whose update differs).

As in the reference: moments stored in ``moment_dtype`` (bf16 by default)
and promoted to fp32 for the update; ``m / sqrt(v)`` as ``m * rsqrt(v +
eps^2)``; weight decay inside ``lr * (...)``; a linear warmup; an int32
``step`` and the bias corrections ``1 - b^step`` taken in fp32.

On DTensors with ZeRO-1 moments (``shard.moment_specs``: one more dim
sharded over "data") each rank updates only its moments' slice: gradient
and param are cut to the moments' placements (no traffic: both are
replicated over "data"), and the new param is gathered back to its own.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.tree import leaves, tree_map, unzip


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "bfloat16"
    warmup_steps: int = 100


def adamw_init(params, cfg: AdamWConfig = AdamWConfig()):
    return init_moments(params, cfg)


def init_moments(params, cfg: AdamWConfig):
    dt = getattr(torch, cfg.moment_dtype)
    some = leaves(params)[0]

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=some.device)}


def _schedule(cfg: AdamWConfig, step):
    warm = torch.clamp((step + 1).float() / cfg.warmup_steps, max=1.0)
    return cfg.lr * warm


def adamw_update(params, grads, opt_state, cfg: AdamWConfig):
    """One AdamW step.  Returns (new params, new optimizer state); the
    inputs are left as they were."""
    step = opt_state["step"] + 1
    lr = _schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    bc1 = 1.0 - torch.pow(_scalar(b1, stepf), stepf)
    bc2 = 1.0 - torch.pow(_scalar(b2, stepf), stepf)
    dt = getattr(torch, cfg.moment_dtype)

    def upd(p, g, m, v):
        g32 = _placed(g.float(), m)
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
        mh, vh = m32 / bc1, v32 / bc2
        step_ = mh * torch.rsqrt(vh + cfg.eps * cfg.eps)   # ~m/(sqrt(v)+eps)
        p32 = _placed(p.float(), m)
        p_new = p32 - lr * (step_ + cfg.weight_decay * p32)
        return _placed(p_new.to(p.dtype), p), m32.to(dt), v32.to(dt)

    new_p, new_m, new_v = unzip(tree_map(upd, params, grads, opt_state["m"],
                                         opt_state["v"]), 3)
    return new_p, {"m": new_m, "v": new_v, "step": step}


def _scalar(x: float, like):
    t = torch.tensor(x, dtype=torch.float32, device=like.device)
    if isinstance(like, DTensor):
        t = DTensor.from_local(t, like.device_mesh, like.placements,
                               run_check=False)
    return t


def _placed(t, ref):
    """``t`` with ``ref``'s placements where both are DTensors."""
    if not isinstance(t, DTensor) or t.placements == ref.placements:
        return t
    return t.redistribute(ref.device_mesh, ref.placements)
