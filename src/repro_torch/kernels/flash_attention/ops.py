"""Launcher, plain version and launch count of the flash-attention kernel.

Port of ``src/repro/kernels/flash_attention/{ops,flash_attention,ref}.py``.
``flash_attention`` computes ``softmax(Q K^T / sqrt(d)) V`` for causal (or
full) GQA attention in the JAX layout: q ``(B, Sq, H, D)``, k and v
``(B, Sk, KV, D)`` with ``H % KV == 0``, query head ``h`` reading kv head
``h // (H // KV)``, and ``q_offset`` the absolute position of ``q[:, 0]``.
The output has q's shape and dtype.

On a CUDA tensor the wrapper launches the kernel of
``csrc/flash_attention.cu`` (fp32 products and statistics, q scaled in the
input dtype as the TPU kernel does; ``tile_plan`` names the kernel and its
tile) or raises; on a CPU tensor it takes the
plain version ``attention_ref`` (the unfused oracle: the S x S fp32 score
matrix materialised).  ``LAUNCHES`` counts kernel launches and
``PLAIN_CALLS`` the CPU branch.  ``attention_fp32`` is the kernel's own
arithmetic, unfused and in fp32: the card holds the bf16 and fp16 kernel
against it at ``OUT_REL_TOL`` (``row_rel_err``).  The TPU kernel's
``blk_q``/``blk_k`` and ``interpret`` do not carry over: the tiles are the
kernel's own, and it masks its ragged edge itself.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, refuse_autograd

NEG = -1e30
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# bf16/fp16 kernel output against ``attention_fp32``: two unit roundoffs
# of the output dtype (2^-8 and 2^-11), relative to each row's largest value
OUT_REL_TOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}

# query rows and keys of one block's tile: the tensor-core kernel (bf16 and
# fp16 at d 64 and 128, wgmma fed by TMA) and the CUDA-core one
TC_TILE = (128, 128)
FP32_TILE = (64, 64)

LAUNCHES = {"flash_attention": 0}
PLAIN_CALLS = {"flash_attention": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.repro_flash_attention.argtypes = [ci, ci, vp, vp, vp, vp, vp,
                                          ctypes.c_float, vp]
    lib.repro_flash_attention.restype = ci


def library():
    """The flash_attention CUDA library, built at first use."""
    return build.library("flash_attention", _bind)


def _scale(dtype, d: int) -> float:
    """1/sqrt(d) rounded to ``dtype``: the TPU kernel multiplies q by it in
    the input dtype."""
    return float(torch.tensor(1.0 / d ** 0.5, dtype=dtype))


def _masked(s, q_offset: int, causal: bool):
    """Scores (..., Sq, Sk) with keys after each query's position at -1e30."""
    if not causal:
        return s
    sq, sk = s.shape[-2:]
    qpos = torch.arange(sq, device=s.device) + q_offset
    kpos = torch.arange(sk, device=s.device)
    return s.masked_fill(kpos[None, :] > qpos[:, None], NEG)


def attention_ref(q, k, v, *, q_offset: int = 0, causal: bool = True):
    """Unfused attention (``ref.py``): scores in the input dtype, then fp32
    scaling, -1e30 masking and softmax; weights cast back to the input
    dtype for the value product."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, d)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    s = _masked(s * (1.0 / d ** 0.5), q_offset, causal)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return o.reshape(b, sq, h, d)


def attention_fp32(q, k, v, *, q_offset: int = 0, causal: bool = True):
    """The kernel's arithmetic, unfused and left in fp32: q multiplied by
    1/sqrt(d) in its own dtype (as the TPU kernel does), then fp32 scores,
    -1e30 masking, softmax and value product.  The kernel's bf16 or fp16
    output differs from it by the final rounding to that dtype (at most
    one unit roundoff of each value) and fp32 reordering."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    qg = (q * _scale(q.dtype, d)).float().reshape(b, sq, kv, h // kv, d)
    s = _masked(torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()), q_offset,
                causal)
    o = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, dim=-1), v.float())
    return o.reshape(b, sq, h, d)


def row_rel_err(got, want) -> float:
    """max |got - want| over each output row (one query, one head), divided
    by that row's largest |want|: the unit in which a rounding of the
    output shows, whatever the size of the row's values."""
    scale = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return float(((got.float() - want.float()).abs() / scale).max())


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, heads, D)")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads over {k.shape[2]} kv heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` with a unit last stride, other strides a multiple of 8 and a
    16-byte aligned start (the kernels load 16-byte chunks of a row)."""
    if (t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0):
        return t
    return t.clone(memory_format=torch.contiguous_format)   # a fresh buffer


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` (B, S, heads, D) as the tensor-core kernel's TMA maps read it:
    aligned, with strides that nest (head inside key inside batch, no
    overlap); otherwise a contiguous copy."""
    t = _aligned(t)
    b, s, h, d = t.shape
    sb, ss, sh, _ = t.stride()
    if (sh >= d or h == 1) and (ss >= h * sh or s == 1) and (
            sb >= s * ss or b == 1):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def tile_plan(b: int, sq: int, sk: int, h: int, kv: int, d: int, dtype,
              q_offset: int = 0, causal: bool = True) -> dict:
    """The work the kernel does for one call: which kernel, its tile (query
    rows ``bm``, keys ``bn``), its work items (row tiles x batch·kv heads;
    the CUDA-core kernel's grid, the tensor-core kernel's persistent blocks
    walk them in order), and for each row tile, heaviest first, its first
    row and the number of kv tiles it walks.  Row r of kv head j is
    position r // g of query head j * g + r % g; rows past Sq * g are
    computed and never stored."""
    tc = dtype in (torch.bfloat16, torch.float16) and d in (64, 128)
    bm, bn = TC_TILE if tc else FP32_TILE
    g = h // kv
    rows = sq * g
    n_rt = -(-rows // bm)
    n_kt = -(-sk // bn)
    tiles = []
    for i in range(n_rt):
        r0 = (n_rt - 1 - i) * bm
        last = n_kt
        if causal:
            qmax = (min(r0 + bm, rows) - 1) // g + q_offset
            last = min(n_kt, qmax // bn + 1)
        tiles.append((r0, last))
    return {"kernel": "wgmma" if tc else "cuda_core", "bm": bm, "bn": bn,
            "g": g, "rows": rows, "items": (n_rt, b * kv), "tiles": tiles}


def flash_attention(q, k, v, *, q_offset: int = 0, causal: bool = True):
    """q (B,Sq,H,D); k/v (B,Sk,KV,D), H % KV == 0.  Returns (B,Sq,H,D).
    Not differentiable: under autograd it raises on either device
    (``refuse_autograd``)."""
    _check(q, k, v)
    refuse_autograd("flash_attention", q, k, v)
    if q.device.type == "cpu":
        PLAIN_CALLS["flash_attention"] += 1
        return attention_ref(q, k, v, q_offset=q_offset, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not "
                         f"{q.device}")
    return _launch(q, k, v, int(q_offset), bool(causal))


def _launch(q, k, v, q_offset: int, causal: bool):
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention takes {list(DTYPES)}, not "
                         f"{q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes head_dim in {HEAD_DIMS}, "
                         f"not {d}")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    plan = tile_plan(b, sq, sk, h, kv, d, q.dtype, q_offset, causal)
    q = _aligned(q)
    k, v = ((_tma_ready(k), _tma_ready(v)) if plan["kernel"] == "wgmma"
            else (_aligned(k), _aligned(v)))
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0 or sk == 0:
        return out.zero_()
    scale = _scale(q.dtype, d)
    dims = np.array([b, sq, sk, h, kv, q_offset, int(causal),
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     plan["bm"], plan["bn"]],
                    np.int64)
    lib = library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.repro_flash_attention(
        ctypes.c_int(DTYPES[q.dtype]), ctypes.c_int(d),
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        dims.ctypes.data_as(ctypes.c_void_p), ctypes.c_float(scale),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{build.error(lib, rc)}")
    LAUNCHES["flash_attention"] += 1
    return out
