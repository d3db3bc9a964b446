"""Launcher, plain versions and launch count of the chunked linear-scan
kernels.

Port of ``src/repro/kernels/ssm_scan/{ops,ssm_scan,ref}.py``.  ``ssm_scan``
evaluates the recurrence ``S_t = a_t S_{t-1} + k_t v_t^T``, ``y_t = S_t^T
q_t`` (``a_t = exp(log_a_t)``, the state S fp32 (K x V) per head) in the JAX
layout: q, k ``(B, S, H, K)``, v ``(B, S, H, V)``, log_a ``(B, S, H)`` fp32.
The output y ``(B, S, H, V)`` has v's dtype.

On a CUDA tensor the wrapper launches the kernels of ``csrc/ssm_scan.cu`` or
raises; the route follows the dtype (``ROUTES``).  bf16 goes to the tensor
cores: ``scan_intra_kernel`` (P = q k^T masked and decayed, once per (batch,
head, 64-step chunk), as bf16 hi and lo halves in a scratch) then
``scan_state_kernel`` (the state S^T of a column slab in mma registers
across the chunks, fp32 operands split into bf16 hi and lo halves).  fp32
and fp16 go to ``ssm_scan_kernel`` (CUDA cores, fp32).  On a CPU tensor the
wrapper takes the plain version, ``nn.recurrent.chunked_linear_scan`` (the
oracle the model layers call in the reference).  ``LAUNCHES`` counts calls
that launched the kernels (one per call, whatever the route) and
``PLAIN_CALLS`` the CPU branch.  Beside it: ``sequential_ref`` (the
step-by-step recurrence) and ``scan_fp32`` (the plain version on inputs
upcast to fp32), against which the card holds the bf16 and fp16 routes at
``OUT_REL_TOL`` (``row_rel_err``).

q, k and v may be strided views (Zamba2's q and k are broadcast over the
heads with stride 0): the kernels read the (batch, seq, head) strides, and
the wrapper copies only a tensor whose last dimension is not contiguous.

Gradients.  The kernels launch through ``ctypes``, so on the card the
wrapper runs them inside ``ScanFunction`` (a ``torch.autograd.Function``)
whose backward is ``kernel_backward``: the kernels of
``csrc/ssm_scan_bw.cu``, written for the backward (the TPU kernel had none;
the reference differentiates its scan through plain ``jnp``).  One pass
forward in time gives dq and the row dots u_t = q_t . dq_t, reverse passes
give dv and dk and w_t = k_t . dk_t, and a last kernel sums d log_a_t =
sum_{r>=t} (u_r - w_r) in fp32; nothing is flipped or copied, and dq, dk,
dv are written once in the inputs' dtypes (the design and its bound are in
the source's note).  It replaced the forward kernels run three more times
on time-reversed copies with torch glue around them.  ``plain_backward`` is
the same passes in plain PyTorch, fp32, against which the card holds the
kernels; ``meta_backward`` gives the dry run shapes.
``LAUNCHES["ssm_scan"]`` counts the forward's launches and
``LAUNCHES["ssm_scan_backward"]`` the backward's (one per backward call:
its two intra-chunk, three state and one d log_a kernels).  On the CPU the
wrapper's autograd runs through the plain scan itself.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.autograd.function import once_differentiable
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ops import row_rel_err  # noqa: F401
from repro_torch.nn.layers import per_shard
from repro_torch.nn.recurrent import chunk_for, chunked_linear_scan

# the kernels of each dtype's route, and the column slab widths of S each
# takes (the fp32/fp16 route's slab lives in shared memory, the bf16
# route's in registers)
ROUTES = {torch.bfloat16: ("scan_intra_kernel", "scan_state_kernel"),
          torch.float32: ("ssm_scan_kernel",),
          torch.float16: ("ssm_scan_kernel",)}
SLABS = {torch.bfloat16: (128, 32), torch.float32: (64, 32),
         torch.float16: (64, 32)}
MAX_SMEM = 232448              # opt-in shared memory per block on Hopper
DTYPES = {torch.float32: 0, torch.float16: 2}   # the fp32/fp16 route's codes
CHUNK = 64                     # steps per chunk of the bf16 route
COEF = 2 * CHUNK + 4           # floats of its coefficient record

# bf16/fp16 kernel output against ``scan_fp32``: two unit roundoffs of the
# output dtype (2^-8 and 2^-11), relative to each (b, t, h) row's largest
# value; the kernel differs from it by its final rounding and fp32 order
OUT_REL_TOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
# bf16 route on bf16 inputs: at most this share of its output elements may
# differ from ``scan_fp32`` rounded to bf16 (``round_mismatch``).  Its
# products carry about 16 bits beyond bf16, so only values that close to a
# rounding boundary differ (about 0.2% in the plain-torch model of the
# route); bf16 operands without their low halves differ in about a third,
# yet stay inside ``OUT_REL_TOL``
ROUND_SHARE_TOL = 2.0 ** -6

LAUNCHES = {"ssm_scan": 0, "ssm_scan_backward": 0}
PLAIN_CALLS = {"ssm_scan": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.repro_ssm_scan.argtypes = [ci, ci, vp, vp, vp, vp, vp, vp, vp]
    lib.repro_ssm_scan.restype = ci
    lib.repro_ssm_scan_smem.argtypes = [ctypes.c_int64, ci]
    lib.repro_ssm_scan_smem.restype = ctypes.c_int64
    lib.repro_ssm_scan_bf16.argtypes = [ci, ci] + [vp] * 9
    lib.repro_ssm_scan_bf16.restype = ci
    lib.repro_ssm_scan_bf16_smem.argtypes = [ci, ctypes.c_int64]
    lib.repro_ssm_scan_bf16_smem.restype = ctypes.c_int64
    lib.repro_ssm_scan_bf16_geometry.argtypes = [ci]
    lib.repro_ssm_scan_bf16_geometry.restype = ci
    geometry = tuple(lib.repro_ssm_scan_bf16_geometry(i) for i in (0, 1))
    if geometry != (CHUNK, COEF):
        raise RuntimeError(f"ssm_scan library's chunk and coefficient record "
                           f"{geometry}, the wrapper's {(CHUNK, COEF)}")


def library():
    """The ssm_scan CUDA library, built at first use."""
    return build.library("ssm_scan", _bind)


def _bind_bw(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.repro_ssm_scan_bw.argtypes = [ci] + [vp] * 13
    lib.repro_ssm_scan_bw.restype = ci
    lib.repro_ssm_scan_bw_bf16.argtypes = [vp, ci] + [vp] * 15
    lib.repro_ssm_scan_bw_bf16.restype = ci


def bw_library():
    """The backward's CUDA library (``csrc/ssm_scan_bw.cu``), built at first
    use."""
    return build.library("ssm_scan_bw", _bind_bw)


# ------------------------------------------------------------ plain versions
def sequential_ref(q, k, v, log_a):
    """Step-by-step recurrence (``ref.py``): S_t = a_t S_{t-1} + k_t v_t^T;
    y_t = S_t^T q_t, in fp32, y cast to v's dtype."""
    b, s, h, dk = q.shape
    S = torch.zeros((b, h, dk, v.shape[-1]), dtype=torch.float32,
                    device=q.device)
    ys = []
    for t in range(s):
        a = torch.exp(log_a[:, t].float())[..., None, None]
        S = a * S + torch.einsum("bhk,bhv->bhkv", k[:, t].float(),
                                 v[:, t].float())
        ys.append(torch.einsum("bhk,bhkv->bhv", q[:, t].float(), S))
    return torch.stack(ys, 1).to(v.dtype)


def scan_fp32(q, k, v, log_a):
    """The kernel's arithmetic left in fp32: the plain version on inputs
    upcast to fp32, at the reference's chunk.  The kernel's output differs
    from it by its rounding to the output dtype and by the order of its
    fp32 sums (its own 64-step sub-chunks among them)."""
    return chunked_linear_scan(q.float(), k.float(), v.float(), log_a,
                               chunk=chunk_for(q.shape[1]))[0]


def round_mismatch(got, want) -> float:
    """Share of the elements of ``got`` that differ from ``want`` (fp32)
    rounded to ``got``'s dtype."""
    return float((got != want.to(got.dtype)).float().mean())


# ------------------------------------------------------------------ wrapper
def _check(q, k, v, log_a, chunk: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or log_a.dim() != 3:
        raise ValueError("q, k must be (B, S, H, K), v (B, S, H, V), log_a "
                         "(B, S, H)")
    b, s, h, dk = q.shape
    if k.shape != q.shape or v.shape[:3] != (b, s, h) or \
            log_a.shape != (b, s, h):
        raise ValueError(f"shapes do not match: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, log_a "
                         f"{tuple(log_a.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if log_a.dtype != torch.float32:
        raise ValueError(f"log_a must be float32, not {log_a.dtype}")
    if not (q.device == k.device == v.device == log_a.device):
        raise ValueError("q, k, v, log_a lie on different devices")
    if chunk < 1 or s % min(chunk, s or 1):
        raise ValueError(f"seq {s} not divisible by chunk {min(chunk, s)}")


def slab_smem(dtype, dk: int, vt: int) -> int:
    """Shared memory in bytes a block of ``dtype``'s route needs at head dim
    ``dk`` and slab width ``vt``; -1 where the route does not take them."""
    lib = library()
    if dtype == torch.bfloat16:
        return lib.repro_ssm_scan_bf16_smem(vt, dk)
    return lib.repro_ssm_scan_smem(dk, vt) if vt in SLABS[dtype] else -1


def slabs(dtype, dk: int) -> tuple:
    """The slab widths ``dtype``'s route takes at head dim ``dk``."""
    return tuple(vt for vt in SLABS[dtype]
                 if 0 < slab_smem(dtype, dk, vt) <= MAX_SMEM)


def pick_slab(widths, b: int, h: int, dv: int, n_sm: int,
              dtype=torch.bfloat16) -> int:
    """Columns of S per block.  bf16: the widest width no wider than V
    (the narrowest where none is); fp32/fp16: 64 where the grid still has
    a block for every SM, else 32."""
    if dtype != torch.bfloat16:
        return 64 if 64 in widths and dv > 32 and \
            b * h * -(-dv // 64) >= n_sm else min(widths)
    return max((vt for vt in widths if vt <= dv), default=min(widths))


def slab_width(b: int, h: int, dk: int, dv: int, n_sm: int,
               dtype=torch.bfloat16) -> int:
    """The slab width the wrapper launches ``dtype``'s route with."""
    widths = slabs(dtype, dk)
    if not widths:
        raise ValueError(f"ssm_scan: head dim K={dk} is too large for the "
                         f"{dtype} route")
    return pick_slab(widths, b, h, dv, n_sm, dtype)


def ssm_scan(q, k, v, log_a, *, chunk: int = 128):
    """q,k (B,S,H,K); v (B,S,H,V); log_a (B,S,H) fp32.  Returns y (B,S,H,V)
    in v's dtype.  ``chunk`` is the plain version's chunk length (S must be
    a multiple of min(chunk, S)); the kernels' chunks are their own.

    q and k may both carry one head (B,S,1,K) shared by all of v's H
    heads: they are expanded over the heads with stride 0, never copied.
    DTensors run through ``_scan_per_head`` on each rank's local heads;
    ``meta`` tensors (the dry run) take a shape-only route that counts
    nothing."""
    if isinstance(v, DTensor):
        return _scan_per_head(q, k, v, log_a, chunk)
    q, k = expand_heads(q, k, v)
    _check(q, k, v, log_a, chunk)
    if q.device.type == "meta":
        return ScanFunction.apply(q, k, v, log_a, meta_scan)
    if q.device.type == "cpu":
        PLAIN_CALLS["ssm_scan"] += 1
        return chunked_linear_scan(q, k, v, log_a, chunk=chunk)[0]
    if q.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on CUDA or the CPU, not {q.device}")
    if q.dtype not in ROUTES:
        raise ValueError(f"ssm_scan takes {list(ROUTES)}, not {q.dtype}")
    return ScanFunction.apply(q, k, v, log_a, kernel_scan)


def _one_head(q, k, v) -> bool:
    """Whether q and k both carry one head (B,S,1,K) for v's many."""
    return (q.dim() == k.dim() == v.dim() == 4 and q.shape[2] == k.shape[2]
            == 1 and v.shape[2] > 1)


def expand_heads(q, k, v):
    """q and k expanded over v's heads with stride 0 where both carry one
    head (B,S,1,K); else as they are."""
    if _one_head(q, k, v):
        return tuple(t.expand(-1, -1, v.shape[2], -1) for t in (q, k))
    return q, k


def meta_scan(q, k, v, log_a):
    """The scan's output on the ``meta`` device: its shape and dtype only
    (the dry run's route; ``ScanFunction`` gives it ``meta_backward``)."""
    return torch.empty(v.shape, dtype=v.dtype, device="meta")


def _scan_placements(v):
    """The layout the scan runs in on each rank: on each mesh dim, v's
    batch or head shard where it has one, else replicated (a sequence or
    feature shard is gathered: each rank's scan needs the whole of both)."""
    return tuple(p if isinstance(p, Shard) and p.dim in (0, 2)
                 else Replicate() for p in v.placements)


def _scan_per_head(q, k, v, log_a, chunk: int):
    """``ssm_scan`` on each rank's local rows and heads (``per_shard``): the
    kernel (inside ``ScanFunction``, so its backward runs per rank too) on
    the card, the plain version on the CPU.  The output takes the layout ``_scan_placements`` picks.  One-head q and k
    (B,S,1,K) stay whole over the head shards and are expanded to the
    rank's local heads inside, with stride 0; their gradients leave as
    partial sums over the mesh dims that shard the heads."""
    pl = _scan_placements(v)
    qk, qk_grad = pl, pl
    if _one_head(q, k, v):
        # a shared head stays whole where v's heads are sharded; its
        # gradient there is a sum of the ranks' local heads'
        qk = tuple(Replicate() if p == Shard(2) else p for p in pl)
        qk_grad = tuple(Partial() if p == Shard(2) else p for p in pl)
    return per_shard(lambda *t: ssm_scan(*t, chunk=chunk),
                     (q, k, v, log_a), (qk, qk, pl, pl), list(pl),
                     (qk_grad, qk_grad, pl, pl))


def kernel_scan(q, k, v, log_a):
    """One launch of ``q.dtype``'s route at the slab width ``slab_width``
    picks for these shapes; y in v's dtype."""
    b, _, h, dk = q.shape
    return launch(q, k, v, log_a, slab_width(b, h, dk, v.shape[-1], _n_sm(q),
                                             q.dtype))


def _n_sm(t) -> int:
    return torch.cuda.get_device_properties(t.device).multi_processor_count


# ----------------------------------------------------------------- backward
def _decay(cum):
    """(B, T, T, H): e^{cum_t - cum_s} for t >= s, else 0 (exp of the
    masked difference, so nothing overflows)."""
    n = cum.shape[1]
    tri = torch.ones((n, n), dtype=torch.bool, device=cum.device).tril()
    diff = cum[:, :, None] - cum[:, None, :]
    return torch.where(tri[None, :, :, None], diff, float("-inf")).exp()


def plain_backward(q, k, v, log_a, dy):
    """Gradients (dq, dk, dv, d log_a) of ``y = ssm_scan(q, k, v, log_a)``
    for the upstream gradient ``dy``: the kernels' passes in plain PyTorch,
    fp32 (inputs upcast), in the kernels' chunks of ``CHUNK`` steps.

    With cum the in-chunk cumsum of log_a, cum_T its last value, and, for
    t >= s, P[t,s] = (q_t . k_s) e^{cum_t - cum_s} and D[t,s] = (dy_t . v_s)
    e^{cum_t - cum_s}: (1) forward in time, dq_t = sum_s D[t,s] k_s +
    e^{cum_t} S dy_t with the forward state S <- e^{cum_T} S + sum_s
    e^{cum_T - cum_s} k_s v_s^T, and u_t = q_t . dq_t; (2) reverse in time,
    dk_s = sum_t D[t,s] q_t + e^{cum_T - cum_s} G v_s, dv_s = sum_t P[t,s]
    dy_t + e^{cum_T - cum_s} G^T k_s with G <- e^{cum_T} G + sum_t e^{cum_t}
    q_t dy_t^T, and w_t = k_t . dk_t; (3) d log_a_t = sum_{r>=t} (u_r -
    w_r).  u and w come from the fp32 dq and dk, so their diagonal terms
    cancel.  dq, dk, dv in q's, k's, v's dtypes; d log_a fp32."""
    f = torch.float32
    q32, k32, v32, g32 = (t.to(f) for t in (q, k, v, dy))
    b, s, h, dk_ = q.shape
    dq = torch.empty((b, s, h, dk_), dtype=f, device=q.device)
    dk, dv = torch.empty_like(dq), torch.empty_like(v32)
    u = torch.empty((b, s, h), dtype=f, device=q.device)
    w = torch.empty_like(u)
    spans = [(t0, min(t0 + CHUNK, s)) for t0 in range(0, s, CHUNK)]
    state = torch.zeros((b, h, dk_, v.shape[-1]), dtype=f, device=q.device)
    for t0, t1 in spans:                                 # (1) forward
        qc, kc, vc, gc = (t[:, t0:t1] for t in (q32, k32, v32, g32))
        cum = torch.cumsum(log_a[:, t0:t1].to(f), 1)
        tot = cum[:, -1]
        dmat = torch.einsum("bthv,bshv->btsh", gc, vc) * _decay(cum)
        dqc = torch.einsum("btsh,bshk->bthk", dmat, kc) + cum.exp()[
            ..., None] * torch.einsum("bhkv,bthv->bthk", state, gc)
        dq[:, t0:t1], u[:, t0:t1] = dqc, (qc * dqc).sum(-1)
        state = tot.exp()[..., None, None] * state + torch.einsum(
            "bsh,bshk,bshv->bhkv", (tot[:, None] - cum).exp(), kc, vc)
    state.zero_()
    for t0, t1 in reversed(spans):                       # (2) reverse
        qc, kc, vc, gc = (t[:, t0:t1] for t in (q32, k32, v32, g32))
        cum = torch.cumsum(log_a[:, t0:t1].to(f), 1)
        tot = cum[:, -1]
        decay = _decay(cum)
        wgt = (tot[:, None] - cum).exp()[..., None]
        pmat = torch.einsum("bthk,bshk->btsh", qc, kc) * decay
        dmat = torch.einsum("bthv,bshv->btsh", gc, vc) * decay
        dkc = torch.einsum("btsh,bthk->bshk", dmat, qc) + wgt * torch.einsum(
            "bhkv,bshv->bshk", state, vc)
        dv[:, t0:t1] = torch.einsum("btsh,bthv->bshv", pmat, gc) + \
            wgt * torch.einsum("bhkv,bshk->bshv", state, kc)
        dk[:, t0:t1], w[:, t0:t1] = dkc, (kc * dkc).sum(-1)
        state = tot.exp()[..., None, None] * state + torch.einsum(
            "bth,bthk,bthv->bhkv", cum.exp(), qc, gc)
    dla = (u - w).flip(1).cumsum(1).flip(1)              # (3) d log_a
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dla


def meta_backward(q, k, v, log_a, dy):
    """``plain_backward``'s outputs on the ``meta`` device: shapes and
    dtypes only."""
    return tuple(torch.empty(t.shape, dtype=t.dtype, device="meta")
                 for t in (q, k, v, log_a))


def bw_slabs(b: int, h: int, dk: int, dv: int, n_sm: int, dtype) -> tuple:
    """The slab widths of the backward's dq, dv and dk passes: dq and dk
    contract over V and slice K, dv contracts over K and slices V."""
    return (slab_width(b, h, dv, dk, n_sm, dtype),
            slab_width(b, h, dk, dv, n_sm, dtype),
            slab_width(b, h, dv, dk, n_sm, dtype))


def kernel_backward(q, k, v, log_a, dy):
    """``plain_backward`` on the card: the kernels of ``csrc/ssm_scan_bw.cu``
    (one library call; see the module note), counted once per call in
    ``LAUNCHES["ssm_scan_backward"]``.  q, k (stride 0 over the heads where
    broadcast), v and dy are read through their strides; dq, dk (B,S,H,K)
    in q's and k's dtype, dv (B,S,H,V) in v's, d log_a (B,S,H) fp32."""
    if q.dtype not in ROUTES:
        raise ValueError(f"ssm_scan backward takes {list(ROUTES)}, not "
                         f"{q.dtype}")
    b, s, h, dk_ = q.shape
    dv_ = v.shape[-1]
    dy = dy.to(v.dtype)
    q, k, v, dy = _rows(q), _rows(k), _rows(v), _rows(dy)
    dq = torch.empty((b, s, h, dk_), dtype=q.dtype, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty((b, s, h, dv_), dtype=v.dtype, device=q.device)
    dla = torch.empty((b, s, h), dtype=torch.float32, device=q.device)
    if dq.numel() == 0 or dv.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_(), dla.zero_()
    if b * h > 65535:
        raise ValueError(f"ssm_scan backward: {b * h} (batch, head) pairs > "
                         f"65535")
    vts = bw_slabs(b, h, dk_, dv_, _n_sm(q), q.dtype)
    n_part = -(-dk_ // vts[0]) + -(-dk_ // vts[2])
    part = torch.empty((n_part, b, h, s), dtype=torch.float32,
                       device=q.device)
    dims = np.array([b, s, h, dk_, dv_, *q.stride()[:3], *k.stride()[:3],
                     *v.stride()[:3], *log_a.stride(), *dy.stride()[:3]],
                    np.int64)
    c_vts = (ctypes.c_int * 3)(*vts)
    ptrs = [ctypes.c_void_p(t.data_ptr())
            for t in (q, k, v, log_a, dy, dq, dk, dv, dla, part)]
    lib = bw_library()
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    if q.dtype == torch.bfloat16:
        n_rec = b * h * -(-s // CHUNK)
        scratch = [torch.empty((n_rec, CHUNK * CHUNK), dtype=torch.int32,
                               device=q.device) for _ in range(2)]
        scratch.append(torch.empty((n_rec, COEF), dtype=torch.float32,
                                   device=q.device))
        rc = lib.repro_ssm_scan_bw_bf16(
            c_vts, ctypes.c_int(int(_vec(q, k, v, dy))), *ptrs,
            *(ctypes.c_void_p(t.data_ptr()) for t in scratch),
            dims.ctypes.data_as(ctypes.c_void_p), stream)
    else:
        rc = lib.repro_ssm_scan_bw(
            ctypes.c_int(DTYPES[q.dtype]), c_vts, *ptrs,
            dims.ctypes.data_as(ctypes.c_void_p), stream)
    if rc != 0:
        raise RuntimeError(f"ssm_scan backward launch failed: "
                           f"{build.error(lib, rc)}")
    LAUNCHES["ssm_scan_backward"] += 1
    return dq, dk, dv, dla


class ScanFunction(torch.autograd.Function):
    """``scan(q, k, v, log_a)`` under autograd.  Its backward follows the
    inputs and the scan: ``meta_backward`` on ``meta`` tensors,
    ``kernel_backward`` after ``kernel_scan`` (the wrapper's), else
    ``plain_backward`` (a test's plain scan)."""

    @staticmethod
    def forward(ctx, q, k, v, log_a, scan):
        ctx.on_kernels = scan is kernel_scan
        ctx.save_for_backward(q, k, v, log_a)
        return scan(q, k, v, log_a)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        q, k, v, log_a = ctx.saved_tensors
        if q.device.type == "meta":
            grads = meta_backward(q, k, v, log_a, dy)
        elif ctx.on_kernels:
            grads = kernel_backward(q, k, v, log_a, dy)
        else:
            grads = plain_backward(q, k, v, log_a, dy)
        return (*grads, None)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with a contiguous last dimension (strides elsewhere kept)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _vec(*ts) -> bool:
    """Whether the bf16 route may copy rows of these tensors in 16 bytes:
    last dimension and (batch, seq, head) strides multiples of 8 elements,
    pointers 16-byte aligned."""
    return all(t.shape[-1] % 8 == 0 and t.data_ptr() % 16 == 0
               and all(st % 8 == 0 for st in t.stride()[:3]) for t in ts)


def launch(q, k, v, log_a, vt: int):
    """Launch ``q.dtype``'s route with column slabs of ``vt`` columns of S
    (one of ``slabs(q.dtype, K)``); ``ssm_scan`` picks the width with
    ``slab_width``.  y has v's dtype."""
    if q.dtype not in ROUTES:
        raise ValueError(f"ssm_scan takes {list(ROUTES)}, not {q.dtype}")
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    smem = slab_smem(q.dtype, dk, vt)
    if not 0 < smem <= MAX_SMEM:
        raise ValueError(f"ssm_scan: the {q.dtype} route does not take head "
                         f"dim K={dk} at slab {vt} ({smem} bytes of shared "
                         f"memory, at most {MAX_SMEM})")
    if b * h > 65535:
        raise ValueError(f"ssm_scan: {b * h} (batch, head) pairs > 65535")
    out = torch.empty((b, s, h, dv), dtype=v.dtype, device=v.device)
    if out.numel() == 0 or dk == 0:
        return out.zero_()
    q, k, v = _rows(q), _rows(k), _rows(v)
    dims = np.array([b, s, h, dk, dv, *q.stride()[:3], *k.stride()[:3],
                     *v.stride()[:3], *log_a.stride()], np.int64)
    lib = library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, log_a, out)]
    if q.dtype == torch.bfloat16:
        n_chunks = -(-s // CHUNK)
        pbuf = torch.empty((b * h * n_chunks, CHUNK * CHUNK),
                           dtype=torch.int32, device=q.device)
        coef = torch.empty((b * h * n_chunks, COEF), dtype=torch.float32,
                           device=q.device)
        rc = lib.repro_ssm_scan_bf16(
            ctypes.c_int(vt), ctypes.c_int(int(_vec(q, k, v))), *ptrs,
            ctypes.c_void_p(pbuf.data_ptr()),
            ctypes.c_void_p(coef.data_ptr()),
            dims.ctypes.data_as(ctypes.c_void_p), ctypes.c_void_p(stream))
    else:
        rc = lib.repro_ssm_scan(
            ctypes.c_int(DTYPES[q.dtype]), ctypes.c_int(vt), *ptrs,
            dims.ctypes.data_as(ctypes.c_void_p), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"ssm_scan launch failed: {build.error(lib, rc)}")
    LAUNCHES["ssm_scan"] += 1
    return out
