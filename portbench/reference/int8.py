"""DNNVM's fixed-point arithmetic and calibration, in plain PyTorch.

The benchmark's own statement of the semantics the port serves: per-tensor
radix points chosen by enumerating neighbouring positions and keeping the
lowest quantization MSE, int32 accumulators that wrap, requantization by a
shift that rounds half away from zero (with the reference's rules for shifts
of 32 and more), saturation to the type's range.  It imports nothing of the
program: the weights it quantizes and the fractions it uses are worked out
here again from the float weights and the calibration image.

``bits`` is the precision of weights and activations: 8 for the reference,
4 for the lower-precision control.  Biases stay int32.
"""
from __future__ import annotations

import math

import torch

F_MIN, F_MAX = -12, 24
_M32 = (1 << 32) - 1


def qrange(bits: int) -> tuple[int, int]:
    return -(1 << (bits - 1)), (1 << (bits - 1)) - 1


def best_fraction(t: torch.Tensor, bits: int = 8, search: int = 1) -> int:
    """Radix position in [f0 - search, f0 + search] with the lowest
    quantization MSE, f0 the finest position that does not clip the
    largest |value|; clipped to [F_MIN, F_MAX]."""
    amax = float(t.abs().max()) or 1e-9
    lo, hi = qrange(bits)
    f0 = math.floor(math.log2(hi / amax))
    d = t.to(torch.float64)
    best_f, best_err = f0, None
    for f in range(f0 - search, f0 + search + 1):
        q = torch.clamp(torch.round(d * 2.0 ** f), lo, hi)
        err = float(((q * 2.0 ** -f - d) ** 2).mean())
        if best_err is None or err < best_err:
            best_f, best_err = f, err
    return int(min(max(best_f, F_MIN), F_MAX))


def quantize(t: torch.Tensor, f: int, bits: int) -> torch.Tensor:
    """round(t * 2^f) saturated to ``bits``, as int64 values."""
    lo, hi = qrange(bits)
    return torch.clamp(torch.round(t.to(torch.float64) * 2.0 ** f),
                       lo, hi).to(torch.int64)


def wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values -> the int32 value with the same low 32 bits."""
    return ((v + (1 << 31)) & _M32) - (1 << 31)


def round_shift(x: torch.Tensor, s: int) -> torch.Tensor:
    """x * 2^-s rounded half away from zero, on int32 values held in int64:
    |-2^31| stays -2^31 and |x| + 2^(s-1) wraps to 32 bits; a left shift of
    32 or more gives 0, a right shift of 32 or more fills with the sign."""
    if s <= 0:
        return wrap32(x << -s) if s > -32 else torch.zeros_like(x)
    half = 1 << (s - 1) if s <= 32 else 0
    return torch.sign(x) * (wrap32(x.abs() + half) >> min(s, 31))


def saturate(x: torch.Tensor, bits: int) -> torch.Tensor:
    lo, hi = qrange(bits)
    return x.clamp(lo, hi)


def int_conv(x: torch.Tensor, w: torch.Tensor, stride, pad) -> torch.Tensor:
    """Exact integer convolution: x (N,H,W,IC), w (KH,KW,IC,OC) integer
    tensors -> (N,OH,OW,OC) int64.  Runs in float64, where every partial sum
    of int8 products over these widths is an integer below 2^53."""
    n, h, wd, _ = x.shape
    kh, kw, ic, oc = w.shape
    oh = (h + 2 * pad[0] - kh) // stride[0] + 1
    ow = (wd + 2 * pad[1] - kw) // stride[1] + 1
    cols = torch.nn.functional.unfold(
        x.permute(0, 3, 1, 2).to(torch.float64), (kh, kw), padding=pad,
        stride=stride)                                   # (N, IC*KH*KW, L)
    wm = w.permute(3, 2, 0, 1).reshape(oc, ic * kh * kw).to(torch.float64)
    acc = torch.matmul(wm, cols)                         # (N, OC, L)
    return acc.reshape(n, oc, oh, ow).permute(0, 2, 3, 1).to(torch.int64)


def int_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact integer product (N,K) x (K,OC) -> int64, in float64."""
    return torch.matmul(x.to(torch.float64), w.to(torch.float64)).to(
        torch.int64)


def requantize(acc: torch.Tensor, bias: torch.Tensor, shift: int, relu: bool,
               bits: int) -> torch.Tensor:
    """int32 accumulator plus int32 bias (wrapping), shifted, ReLU,
    saturated."""
    y = round_shift(wrap32(acc + bias), shift)
    if relu:
        y = y.clamp(min=0)
    return saturate(y, bits)


def rounded_div(s: torch.Tensor, cnt: int) -> torch.Tensor:
    """sign(s) * ((|s| + cnt // 2) // cnt)."""
    return torch.sign(s) * ((s.abs() + cnt // 2) // cnt)


def ceil_pads(h: int, w: int, kernel, stride, pad) -> tuple:
    """(top, bottom, left, right) of a Caffe ceil-mode pool: the bottom and
    right pads grow until every output window is covered."""
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, pad
    oh = math.ceil((h + 2 * ph - kh) / sh) + 1
    ow = math.ceil((w + 2 * pw - kw) / sw) + 1
    eh = max(0, (oh - 1) * sh + kh - h - 2 * ph)
    ew = max(0, (ow - 1) * sw + kw - w - 2 * pw)
    return ph, ph + eh, pw, pw + ew


def max_pool(x: torch.Tensor, kernel, stride, pad, fill) -> torch.Tensor:
    """Ceil-mode max pool of NHWC ``x``, padded with ``fill``."""
    top, bottom, left, right = ceil_pads(x.shape[1], x.shape[2], kernel,
                                         stride, pad)
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2),
                                 (left, right, top, bottom), value=fill)
    dt = xp.dtype
    y = torch.nn.functional.max_pool2d(
        xp if dt.is_floating_point else xp.to(torch.float64), kernel, stride)
    return y.to(dt).permute(0, 2, 3, 1)
