# Ported from src/repro/nn/layers.py (jax.numpy -> torch).
"""Common layers: norms, rotary embeddings (incl. M-RoPE), MLPs, MoE, the
activation sharding constraint (``constrain``) and ``remat`` (the port's
``jax.remat``).

Under ``distributed.mesh_state.mesh_context`` with DTensor parameters the
same code runs tensor-parallel: DTensor propagates the placements through
each op and ``constrain`` pins the ones the reference pins.  Outside a mesh
every helper here is the identity on plain tensors.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
import torch.distributed._functional_collectives as fc
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils import checkpoint as ckpt

from repro_torch.distributed.mesh_state import (P, current_mesh,
                                                mesh_context, mesh_dims,
                                                placements)

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
        # the recomputation runs in autograd's thread (on the card not the
        # caller's), so it re-enters the caller's mesh: its layouts, and
        # so the local shapes the checkpoint saved, are the forward's
        mesh = current_mesh()

        def in_mesh(*a):
            with mesh_context(mesh):
                return body(*a)

        return ckpt.checkpoint(in_mesh, *args, use_reentrant=False,
                               context_fn=context_fn)

    return run


def _mesh_dims():
    """{axis name: size} of the mesh in effect, or None."""
    mesh = current_mesh()
    return None if mesh is None else mesh_dims(mesh)


def constrain(x, *logical):
    """Megatron-style activation sharding constraint.

    ``logical`` entries: "dp" (batch over the pod and data axes), "tp" (the
    model axis), None.  For a DTensor under a mesh context it becomes
    ``x.redistribute`` to those placements (a Partial sum after a
    row-parallel product is all-reduced here); the identity outside a mesh
    context, on a plain tensor, or when no dim divides — so the same model
    code runs on one card and on a mesh."""
    dims = _mesh_dims()
    if dims is None or not isinstance(x, DTensor):
        return x
    spec = []
    for d, s in zip(x.shape, logical):
        if s == "dp":
            axes = tuple(a for a in ("pod", "data") if a in dims)
            size = 1
            for a in axes:
                size *= dims[a]
            spec.append(axes if axes and d % size == 0 and d >= size else None)
        elif s == "tp":
            ok = "model" in dims and d % dims["model"] == 0 \
                and d >= dims["model"]
            spec.append("model" if ok else None)
        else:
            spec.append(None)
    if all(s is None for s in spec):
        return x
    return x.redistribute(x.device_mesh, placements(P(*spec), x.device_mesh))


def residual(y):
    """A block's output as the residual stream is laid out: batch over the
    data axes, whole on the model axis (a row-parallel product's partial
    sums are all-reduced here, on a mesh without data axes too)."""
    y = constrain(y, "dp", None, None)
    if isinstance(y, DTensor) and any(isinstance(p, Partial)
                                      for p in y.placements):
        y = y.redistribute(y.device_mesh, [
            Replicate() if isinstance(p, Partial) else p
            for p in y.placements])
    return y


def gather_dim(x, dim: int):
    """A DTensor whole along ``dim`` (the mesh dims that shard it
    replicate; the others keep their placements); a plain tensor as it
    is."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in x.placements]
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def replicate_like(t, x):
    """``t`` (a plain tensor made inside the model: positions, masks,
    frequencies) as a replicated DTensor on ``x``'s mesh where ``x`` is a
    DTensor, so the two can meet in one op; else ``t`` itself."""
    if not isinstance(x, DTensor) or isinstance(t, DTensor):
        return t
    mesh = x.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def laid_out(t, x, placements):
    """``t`` as a DTensor on DTensor ``x``'s mesh in ``placements`` (a
    plain ``t`` replicated first; redistributed only where it differs)."""
    t = replicate_like(t, x)
    want = tuple(placements)
    if tuple(t.placements) == want:
        return t
    return t.redistribute(x.device_mesh, want)


def placed_like(t, x):
    """``t`` in ``x``'s placements where ``x`` is a DTensor, so that the
    two can be concatenated; else ``t``."""
    if not isinstance(x, DTensor):
        return t
    return laid_out(t, x, x.placements)


def embed(tokens, table):
    """``table[tokens]``: vocab-parallel (``vocab_parallel_embedding``)
    where the table is a DTensor, so a vocab-sharded table is never
    gathered."""
    if isinstance(table, DTensor):
        return vocab_parallel_embedding(tokens, table)
    return table[tokens]


class ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands on a contiguous gradient: local
    gradients leave ``local_map`` (``per_shard``: attention's q, k and v,
    the scan's) into the DTensor reshape of the heads, whose backward is a
    ``view`` of the local shard."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def summed(placements) -> tuple:
    """``placements`` with each partial sum replaced by ``Replicate()``."""
    return tuple(Replicate() if isinstance(p, Partial) else p
                 for p in placements)


def per_shard(fn, args, placements, out_placements, grad_placements=None):
    """``fn`` on each rank's local shards through ``local_map``.  ``args``
    (DTensors, or plain tensors, replicated on the first DTensor's mesh)
    are laid out in ``placements`` first, so no partial sum reaches
    ``fn``, which need not be linear.  The local gradients of the inputs
    leave contiguous (``ContiguousGrad``).  The output takes
    ``out_placements``, the inputs' gradients ``grad_placements`` (default
    ``placements``)."""
    x = next(t for t in args if isinstance(t, DTensor))
    placements = tuple(tuple(pl) for pl in placements)
    args = [laid_out(t, x, pl) for t, pl in zip(args, placements)]

    def local(*ts):
        if torch.is_grad_enabled():
            ts = [ContiguousGrad.apply(t) if t.is_floating_point() else t
                  for t in ts]
        return fn(*ts)

    return local_map(local, out_placements=out_placements,
                     in_placements=placements,
                     in_grad_placements=grad_placements,
                     device_mesh=x.device_mesh)(*args)


class _GradAsForward(torch.autograd.Function):
    """The identity, whose backward lays the gradient out as the forward
    value was (a DTensor's placements)."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) == ctx.placements:
            return g
        return g.redistribute(ctx.mesh, ctx.placements)


def grad_as_forward(x):
    """``x``; where it is a DTensor (with autograd on), its gradient comes
    back in ``x``'s own placements.  Put after a reshape whose backward
    cannot take any layout: heads flattened that do not divide the model
    axis take no sharded gradient."""
    if isinstance(x, DTensor) and torch.is_grad_enabled():
        return _GradAsForward.apply(x)
    return x


class _SumOverGroup(torch.autograd.Function):
    """Forward: the all-reduce (sum) of the ranks' partial lookups over the
    vocab-sharded group; backward: the identity (each rank's partial
    feeds the sum with weight one) — Megatron's reduce-from-TP region."""

    @staticmethod
    def forward(ctx, y, group):
        return fc.all_reduce(y, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def vocab_parallel_embedding(tokens, table):
    """``F.embedding(tokens, table)`` for a DTensor table sharded on its
    vocab dim over one mesh dim: each rank looks its tokens up in its own
    rows (zeros elsewhere) and one all-reduce over that dim sums them, so
    the table is never gathered.  The output is replicated over the vocab
    dim's mesh dim and takes the tokens' placements on the others; the
    table's gradient is partial over the mesh dims that shard the rows of
    ``tokens``."""
    mesh = table.device_mesh
    tokens = replicate_like(tokens, table)
    vdim = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    if len(vdim) != 1:            # a whole table: index it as one card does
        return table[tokens]
    vdim = vdim[0]
    group = mesh.get_group(vdim)
    rows = table.to_local().shape[0]
    start = mesh.get_local_rank(vdim) * rows

    def local(tok, tab):
        off = tok - start
        miss = (off < 0) | (off >= rows)
        y = F.embedding(off.masked_fill(miss, 0), tab)
        return _SumOverGroup.apply(y.masked_fill(miss[..., None], 0), group)

    out_pl = [Replicate() if i == vdim else p
              for i, p in enumerate(tokens.placements)]
    grad_pl = [p if i == vdim else (Partial() if isinstance(
        tokens.placements[i], Shard) else Replicate())
        for i, p in enumerate(table.placements)]
    return local_map(local, out_placements=out_pl,
                     in_placements=(tokens.placements, table.placements),
                     in_grad_placements=(tokens.placements, grad_pl),
                     device_mesh=mesh)(tokens, table)


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
    inv = replicate_like(rope_freqs(x.shape[-1], theta, x.device), x)
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
    inv, sec = replicate_like(inv, x), replicate_like(sec, x)
    pos = replicate_like(positions3, x)[..., None].float()  # (3, ..., S, 1)
    ang = torch.einsum("k...sf,kf->...sf", pos * inv, sec)  # mix per section
    return _rotate(x, ang)


# ------------------------------------------------------------------- MLPs
def mlp(x, p, act: str):
    if act == "silu_gated":
        h = F.silu(x @ p["w1"]) * (x @ p["w3"])
    else:
        h = F.gelu(x @ p["w1"], approximate="tanh")   # jax.nn.gelu's default
    h = constrain(h, "dp", None, "tp")      # keep hidden model-sharded
    return constrain(h @ p["w2"], "dp", None, None)


def moe_mlp(x, p, act: str, top_k: int = 2):
    """Dense-dispatch top-k MoE: every expert sees every token, weighted by
    the (zeroed for non-selected) router probabilities."""
    e = p["w1"].shape[0]
    logits = x @ p["router"]                                # (B,S,E)
    probs = torch.softmax(logits.float(), dim=-1)
    gate, idxs = _route(probs, top_k, e, x.dtype)
    ws = [p["w1"], p["w2"]] + ([p["w3"]] if act == "silu_gated" else [])
    if isinstance(x, DTensor):
        out = _experts_per_shard(x, gate, ws, act)
    else:
        out = _experts(x, gate, act, *ws)
    out = constrain(out, "dp", None, None)
    aux = _load_balance_loss(probs, idxs, e)
    return out, aux


def _route(probs, top_k: int, e: int, dtype):
    """The top-k experts of each token and their renormalized weights
    scattered onto the experts: (gate (B,S,E), idxs (B,S,k)).  DTensor
    probabilities are routed on each rank's own rows through
    ``local_map``, the experts whole: top-k's backward and the scatter have
    no DTensor rule in every torch release."""
    if isinstance(probs, DTensor):
        rows = [pl if pl == Shard(0) else Replicate()
                for pl in probs.placements]
        return per_shard(lambda pr: _route(pr, top_k, e, dtype), (probs,),
                         (rows,), (rows, rows))
    vals, idxs = torch.topk(probs, top_k, dim=-1)           # (B,S,k)
    vals = vals / torch.sum(vals, dim=-1, keepdim=True)
    gate = torch.zeros((*probs.shape[:-1], e), dtype=dtype,
                       device=probs.device)
    gate.scatter_(-1, idxs, vals.to(dtype))
    return gate, idxs


def _experts(x, gate, act: str, w1, w2, w3=None):
    """Every expert on every token, summed with the gate's weights (the
    reference's einsums; its constraint on the hidden dim is the f split
    of ``_experts_per_shard``)."""
    h1 = torch.einsum("bsd,edf->bsef", x, w1)
    if act == "silu_gated":
        h = F.silu(h1) * torch.einsum("bsd,edf->bsef", x, w3)
    else:
        h = F.gelu(h1, approximate="tanh")
    y = torch.einsum("bsef,efd->bsed", h, w2)
    return torch.einsum("bsed,bse->bsd", y, gate)


def _experts_per_shard(x, gate, ws, act: str):
    """``_experts`` on DTensors through ``local_map``, Megatron's MLP split
    for every expert at once: on each mesh dim that shards the experts'
    hidden dim f (w1 and w3 on their dim 2, w2 on its dim 1, as
    ``param_specs`` places them) each rank runs its slice of f and its
    output is a partial sum; the tokens and the gate keep their batch
    shards and are whole elsewhere.  (DTensor's own einsum rules cannot
    flatten a sharded f in every torch release.)"""
    f_sharded = [pl == Shard(2) for pl in ws[0].placements]
    rows = tuple(pl if pl == Shard(0) else Replicate() for pl in x.placements)

    def on_f(dim):
        return tuple(Shard(dim) if f else Replicate() for f in f_sharded)

    w_pl = [on_f(2), on_f(1)] + [on_f(2)] * (len(ws) - 2)
    # gradients: the tokens' and the gate's sum the f shards' parts; the
    # weights' sum the batch shards' parts
    part = tuple(Partial() if f else r for f, r in zip(f_sharded, rows))
    w_grad = [tuple(Partial() if r == Shard(0) else w
                    for r, w in zip(rows, pl)) for pl in w_pl]
    return per_shard(lambda x, g, *w: _experts(x, g, act, *w),
                     [x, gate] + ws, [rows, rows] + w_pl, list(part),
                     tuple([part, part] + w_grad))


def _load_balance_loss(probs, idxs, n_experts: int):
    """Switch-style auxiliary load-balancing loss.  The one-hot rows of
    the first choices are a comparison, which DTensor indices meet."""
    me = torch.mean(probs, dim=(0, 1))                      # (E,)
    ids = replicate_like(torch.arange(n_experts, device=idxs.device), idxs)
    ce = torch.mean((idxs[..., :1] == ids).float(), dim=(0, 1))
    return n_experts * torch.sum(me * ce)
