# Ported from src/repro/nn/layers.py (jax.numpy -> torch).
"""Common layers: norms, rotary embeddings (incl. M-RoPE), MLPs, MoE.

The reference's sharding helpers (``constrain``, ``_mesh_dims``) are left
out: the port runs on one card, and the distributed item of the ROADMAP
brings them back on ``torch.distributed``.  ``remat`` is the port's
``jax.remat``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

# the products the "dots" remat policy keeps (the reference's
# ``dots_saveable``): what ``@``, ``einsum`` and ``F.linear`` dispatch to
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def remat(body, *, dots: bool = False):
    """``body`` under activation checkpointing (non-reentrant): in backward
    its forward runs again instead of keeping its activations; with
    ``dots`` the matmul outputs are kept and only the rest recomputed.
    Where grad mode is off (serving) ``body`` runs as it is.  The values
    are the same either way."""
    context_fn = (functools.partial(ckpt.create_selective_checkpoint_contexts,
                                    _save_dots) if dots
                  else ckpt.noop_context_fn)

    def run(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        return ckpt.checkpoint(body, *args, use_reentrant=False,
                               context_fn=context_fn)

    return run


def rms_norm(x, gamma, eps: float = 1e-6):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * gamma.to(x.dtype)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y.to(x.dtype) * gamma.to(x.dtype)) + beta.to(x.dtype)


# ---------------------------------------------------------------- rotary
def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def _rotate(x, ang):
    cos = torch.cos(ang)[..., None, :]             # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float = 1e6):
    """x (..., S, H, D); positions (..., S) int."""
    inv = rope_freqs(x.shape[-1], theta, x.device)     # (D/2,)
    ang = positions[..., None].float() * inv           # (..., S, D/2)
    return _rotate(x, ang)


def apply_mrope(x, positions3, theta: float = 1e6, sections=(1, 1, 2)):
    """M-RoPE (Qwen2-VL): the head_dim/2 frequency bands are split into
    temporal/height/width sections, each rotated by its own position id.

    x (..., S, H, D); positions3 (3, ..., S)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)     # (D/2,)
    n = inv.shape[0]
    w = torch.tensor(sections, dtype=torch.float32, device=x.device)
    bounds = torch.cumsum(w, 0) / torch.sum(w) * n
    idx = torch.arange(n, device=x.device)
    sec = (idx[None, :] < bounds[:, None]).float()
    sec[1:] = sec[1:] - sec[:-1]           # one-hot per section (3, D/2)
    pos = positions3[..., None].float()                # (3, ..., S, 1)
    ang = torch.einsum("k...sf,kf->...sf", pos * inv, sec)  # mix per section
    return _rotate(x, ang)


# ------------------------------------------------------------------- MLPs
def mlp(x, p, act: str):
    if act == "silu_gated":
        h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    else:
        h = F.gelu(x @ p["w1"], approximate="tanh")   # jax.nn.gelu's default
    return h @ p["w2"]


def moe_mlp(x, p, act: str, top_k: int = 2):
    """Dense-dispatch top-k MoE: every expert sees every token, weighted by
    the (zeroed for non-selected) router probabilities."""
    b, s, d = x.shape
    e = p["w1"].shape[0]
    logits = x @ p["router"]                                # (B,S,E)
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idxs = torch.topk(probs, top_k, dim=-1)           # (B,S,k)
    vals = vals / torch.sum(vals, dim=-1, keepdim=True)
    gate = torch.zeros((b, s, e), dtype=x.dtype, device=x.device)
    gate.scatter_(-1, idxs, vals.to(x.dtype))
    h1 = torch.einsum("bsd,edf->bsef", x, p["w1"])
    if act == "silu_gated":
        h = F.silu(h1) * torch.einsum("bsd,edf->bsef", x, p["w3"])
    else:
        h = F.gelu(h1, approximate="tanh")
    y = torch.einsum("bsef,efd->bsed", h, p["w2"])
    out = torch.einsum("bsed,bse->bsd", y, gate)
    aux = _load_balance_loss(probs, idxs, e)
    return out, aux


def _load_balance_loss(probs, idxs, n_experts: int):
    """Switch-style auxiliary load-balancing loss."""
    me = torch.mean(probs, dim=(0, 1))                      # (E,)
    ce = torch.mean(F.one_hot(idxs[..., 0], n_experts).float(), dim=(0, 1))
    return n_experts * torch.sum(me * ce)
