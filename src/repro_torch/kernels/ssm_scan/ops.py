"""Launcher, plain versions and launch count of the chunked linear-scan
kernel.

Port of ``src/repro/kernels/ssm_scan/{ops,ssm_scan,ref}.py``.  ``ssm_scan``
evaluates the recurrence ``S_t = a_t S_{t-1} + k_t v_t^T``, ``y_t = S_t^T
q_t`` (``a_t = exp(log_a_t)``, the state S fp32 (K x V) per head) in the JAX
layout: q, k ``(B, S, H, K)``, v ``(B, S, H, V)``, log_a ``(B, S, H)`` fp32.
The output y ``(B, S, H, V)`` has v's dtype.

On a CUDA tensor the wrapper launches the kernel of ``csrc/ssm_scan.cu``
(inputs upcast to fp32, fp32 arithmetic throughout, 64-step sub-chunks with
a masked ragged tail, one block per (head, column slab of S)) or raises; on
a CPU tensor it takes the plain version, ``nn.recurrent.chunked_linear_scan``
(the oracle the model layers call in the reference).  ``LAUNCHES`` counts
kernel launches and ``PLAIN_CALLS`` the CPU branch.  Beside it:
``sequential_ref`` (the step-by-step recurrence) and ``scan_fp32`` (the
plain version on inputs upcast to fp32), against which the card holds the
bf16 and fp16 kernel at ``OUT_REL_TOL`` (``row_rel_err``).

q, k and v may be strided views (Zamba2's q and k are broadcast over the
heads with stride 0): the kernel reads the (batch, seq, head) strides, and
the wrapper copies only a tensor whose last dimension is not contiguous.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ops import row_rel_err  # noqa: F401
from repro_torch.nn.recurrent import chunk_for, chunked_linear_scan

SLABS = (64, 32)               # column slab widths of S the kernel takes
MAX_SMEM = 232448              # opt-in shared memory per block on Hopper
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# bf16/fp16 kernel output against ``scan_fp32``: two unit roundoffs of the
# output dtype (2^-8 and 2^-11), relative to each (b, t, h) row's largest
# value; the kernel differs from it by its final rounding and fp32 order
OUT_REL_TOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}

LAUNCHES = {"ssm_scan": 0}
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


def library():
    """The ssm_scan CUDA library, built at first use."""
    return build.library("ssm_scan", _bind)


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


def slab_width(b: int, h: int, dk: int, dv: int, n_sm: int) -> int:
    """Columns of S per block: 64 where its slab fits in shared memory and
    the grid still has a block for every SM, else 32."""
    lib = library()
    if dv > 32 and lib.repro_ssm_scan_smem(dk, 64) <= MAX_SMEM \
            and b * h * -(-dv // 64) >= n_sm:
        return 64
    return 32


def ssm_scan(q, k, v, log_a, *, chunk: int = 128):
    """q,k (B,S,H,K); v (B,S,H,V); log_a (B,S,H) fp32.  Returns y (B,S,H,V)
    in v's dtype.  ``chunk`` is the plain version's chunk length (S must be
    a multiple of min(chunk, S)); the kernel's sub-chunks are its own."""
    _check(q, k, v, log_a, chunk)
    if q.device.type == "cpu":
        PLAIN_CALLS["ssm_scan"] += 1
        return chunked_linear_scan(q, k, v, log_a, chunk=chunk)[0]
    if q.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on CUDA or the CPU, not {q.device}")
    b, _, h, dk = q.shape
    n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
    return launch(q, k, v, log_a, slab_width(b, h, dk, v.shape[-1], n_sm))


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` with a contiguous last dimension (strides elsewhere kept)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def launch(q, k, v, log_a, vt: int):
    """Launch the kernel with column slabs of ``vt`` columns of S (one of
    ``SLABS``); ``ssm_scan`` picks the width with ``slab_width``."""
    if q.dtype not in DTYPES:
        raise ValueError(f"ssm_scan takes {list(DTYPES)}, not {q.dtype}")
    if vt not in SLABS:
        raise ValueError(f"slab width {vt} not in {SLABS}")
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    lib = library()
    smem = lib.repro_ssm_scan_smem(dk, vt)
    if smem > MAX_SMEM:
        raise ValueError(f"ssm_scan: head dim K={dk} needs {smem} bytes of "
                         f"shared memory at slab {vt} (at most {MAX_SMEM})")
    if b * h > 65535:
        raise ValueError(f"ssm_scan: {b * h} (batch, head) pairs > 65535")
    out = torch.empty((b, s, h, dv), dtype=v.dtype, device=v.device)
    if out.numel() == 0 or dk == 0:
        return out.zero_()
    q, k, v = _rows(q), _rows(k), _rows(v)
    dims = np.array([b, s, h, dk, dv, *q.stride()[:3], *k.stride()[:3],
                     *v.stride()[:3], *log_a.stride()], np.int64)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.repro_ssm_scan(
        ctypes.c_int(DTYPES[q.dtype]), ctypes.c_int(vt),
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(log_a.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), dims.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"ssm_scan launch failed: {build.error(lib, rc)}")
    LAUNCHES["ssm_scan"] += 1
    return out
