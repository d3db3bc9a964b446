"""Bit-exact int8 fixed-point operator semantics on torch tensors.

Port of ``src/repro/core/int8_ops.py``.  Every tensor is NHWC int8 with a
per-tensor fraction ``f``: real ≈ q · 2^{-f}.  Accumulation is int32;
requantization uses round-half-away-from-zero and saturates to [-128, 127].

Integer convolution: on the CPU ``F.conv2d`` runs on int32 tensors (but not
dilated ones).  CUDA has no integer convolution, so there, and for a dilated
conv on the CPU, the int32 accumulator is computed exactly in float64
(``F.unfold`` + ``torch.matmul``): every partial sum is an integer below
2^53, so no rounding happens.  cuDNN's float convolution is not used,
because it may pick FFT or Winograd algorithms that round.

Pools are written as a loop over the kernel window of strided slices, so the
same code runs on int8 and int32 on every device, with explicit pad values
(-128 for max, 0 for avg) and the Caffe ceil extension.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

I8_MIN, I8_MAX = -128, 127


def ceil_extension(h: int, w: int, kernel, stride, pad) -> tuple[int, int]:
    """Caffe ceil-mode pooling: extra bottom/right padding (eh, ew) so every
    output window is covered."""
    kh, kw = kernel
    sh, sw = stride
    ph, pw = pad
    oh = math.ceil((h + 2 * ph - kh) / sh) + 1
    ow = math.ceil((w + 2 * pw - kw) / sw) + 1
    return (max(0, (oh - 1) * sh + kh - h - 2 * ph),
            max(0, (ow - 1) * sw + kw - w - 2 * pw))


_M32 = (1 << 32) - 1


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values -> the int32 value with the same low 32 bits (int64)."""
    return ((v + (1 << 31)) & _M32) - (1 << 31)


def add32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b wrapped to int32, as the reference's int32 addition wraps."""
    return _wrap32(a.to(torch.int64) + b.to(torch.int64)).to(torch.int32)


def round_shift(x: torch.Tensor, s) -> torch.Tensor:
    """x * 2^{-s} with round-half-away-from-zero; x int32, ``s`` an int or
    an integer tensor broadcast against ``x`` (negative s = left shift).

    Bit-equal to the reference's int32 arithmetic under XLA's rules: |x| of
    -2^31 is -2^31 and ``|x| + 2^(s-1)`` wraps to 32 bits (``1 << 31`` is
    -2^31), a left shift by 32 or more gives 0, and an arithmetic right
    shift by 32 or more fills with the sign bit (the same as a shift by
    31).  The steps run on int64 values, each wrapped back to int32 where
    the reference wraps; ``sign(x) * r`` cannot wrap, since a right shift
    by at least 1 leaves |r| <= 2^30."""
    x = x.to(torch.int64)
    if not torch.is_tensor(s):
        s = int(s)
        if s <= 0:
            y = _wrap32(x << -s) if s > -32 else torch.zeros_like(x)
            return y.to(torch.int32)
        half = 1 << (s - 1) if s <= 32 else 0
        r = _wrap32(x.abs() + half) >> min(s, 31)
        return (torch.sign(x) * r).to(torch.int32)
    s = s.to(device=x.device, dtype=torch.int64)
    sp = s.clamp(min=1)
    half = torch.where(sp > 32, 0, 1 << (sp - 1).clamp(max=31))
    right = torch.sign(x) * (_wrap32(x.abs() + half) >> sp.clamp(max=31))
    ls = (-s).clamp(min=0)
    left = torch.where(ls >= 32, 0, _wrap32(x << ls.clamp(max=31)))
    return torch.where(s > 0, right, left).to(torch.int32)


def sat8(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(I8_MIN, I8_MAX).to(torch.int8)


def requantize(acc: torch.Tensor, shift, relu: bool = False) -> torch.Tensor:
    """int32 accumulator -> int8 output at the target fraction."""
    y = round_shift(acc, shift)
    if relu:
        y = y.clamp(min=0)
    return sat8(y)


def rescale(q: torch.Tensor, f_from: int, f_to: int) -> torch.Tensor:
    """Change fraction of an int8 tensor (returns int32, NOT saturated)."""
    return round_shift(q, f_from - f_to)


# ----------------------------------------------------------------- operators
def conv_acc(x: torch.Tensor, w: torch.Tensor, *, stride=(1, 1), pad=(0, 0),
             dilation=(1, 1), groups: int = 1) -> torch.Tensor:
    """Exact int32 accumulator of an int8 conv: x (N,H,W,IC), w
    (KH,KW,IC/g,OC) -> (N,OH,OW,OC) int32."""
    n, h, wd, ic = x.shape
    kh, kw, icg, oc = w.shape
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1)
    if x.device.type == "cpu" and tuple(dilation) == (1, 1):
        acc = F.conv2d(xc.to(torch.int32), wc.to(torch.int32), stride=stride,
                       padding=pad, dilation=dilation, groups=groups)
        return acc.permute(0, 2, 3, 1)
    oh = (h + 2 * pad[0] - dilation[0] * (kh - 1) - 1) // stride[0] + 1
    ow = (wd + 2 * pad[1] - dilation[1] * (kw - 1) - 1) // stride[1] + 1
    cols = F.unfold(xc.to(torch.float64), (kh, kw), dilation=dilation,
                    padding=pad, stride=stride)            # (N, IC*KH*KW, L)
    cols = cols.view(n, groups, icg * kh * kw, oh * ow)
    wm = wc.to(torch.float64).reshape(groups, oc // groups, icg * kh * kw)
    acc = torch.matmul(wm.unsqueeze(0), cols)              # (N, g, OC/g, L)
    return acc.reshape(n, oc, oh, ow).permute(0, 2, 3, 1).to(torch.int32)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
           stride=(1, 1), pad=(0, 0), dilation=(1, 1), groups: int = 1,
           shift=0, relu: bool = False) -> torch.Tensor:
    """x (N,H,W,IC) int8 | w (KH,KW,IC/g,OC) int8 | b (OC,) int32 at f_x+f_w.
    Output int8 at f_y where shift = f_x + f_w - f_y."""
    acc = conv_acc(x, w, stride=tuple(stride), pad=tuple(pad),
                   dilation=tuple(dilation), groups=groups)
    return requantize(add32(acc, b), shift, relu)


def depthwise_conv2d(x, w, b, *, stride=(1, 1), pad=(0, 0), shift=0,
                     relu=False):
    c = x.shape[-1]
    return conv2d(x, w, b, stride=stride, pad=pad, groups=c, shift=shift,
                  relu=relu)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of two integer matrices (float64 on CUDA)."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.int64), b.to(torch.int64)).to(
            torch.int32)
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int32)


def fc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, shift=0,
       relu: bool = False) -> torch.Tensor:
    """x (N,H,W,C) int8 -> (N,1,1,OC); w ((H*W*C), OC)."""
    n = x.shape[0]
    acc = add32(int_matmul(x.reshape(n, -1), w), b)
    return requantize(acc, shift, relu).reshape(n, 1, 1, -1)


def pool_windows(x: torch.Tensor, kernel, stride, pads, fill: int, reduce):
    """Reduce every (kh, kw) window of x (N,H,W,C) padded by
    ``pads = (top, bottom, left, right)`` with ``fill``; ``reduce`` folds
    two window slices."""
    kh, kw = kernel
    sh, sw = stride
    top, bottom, left, right = pads
    xp = F.pad(x, (0, 0, left, right, top, bottom), value=fill)
    oh = (xp.shape[1] - kh) // sh + 1
    ow = (xp.shape[2] - kw) // sw + 1
    out = None
    for i in range(kh):
        for j in range(kw):
            win = xp[:, i:i + (oh - 1) * sh + 1:sh, j:j + (ow - 1) * sw + 1:sw]
            out = win if out is None else reduce(out, win)
    return out


def rounded_div(s: torch.Tensor, cnt: int) -> torch.Tensor:
    """sign(s) * ((|s| + cnt//2) // cnt): the reference's sign-magnitude
    rounded divide (``abs`` first, since ``//`` floors negatives)."""
    return torch.sign(s) * ((s.abs() + cnt // 2) // cnt)


def maxpool(x: torch.Tensor, *, kernel, stride, pad=(0, 0),
            ceil_mode: bool = True) -> torch.Tensor:
    h, w = x.shape[1:3]
    ph, pw = pad
    eh, ew = (ceil_extension(h, w, kernel, stride, pad) if ceil_mode
              else (0, 0))
    return pool_windows(x, kernel, stride, (ph, ph + eh, pw, pw + ew),
                        I8_MIN, torch.maximum)


def avgpool(x: torch.Tensor, *, kernel, stride, pad=(0, 0),
            ceil_mode: bool = True) -> torch.Tensor:
    h, w = x.shape[1:3]
    ph, pw = pad
    # ceil extension reads zeros; the divisor stays kh*kw (count_include_pad)
    eh, ew = (ceil_extension(h, w, kernel, stride, pad) if ceil_mode
              else (0, 0))
    s = pool_windows(x.to(torch.int32), kernel, stride,
                     (ph, ph + eh, pw, pw + ew), 0, torch.add)
    return sat8(rounded_div(s, kernel[0] * kernel[1]))


def global_avgpool(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[1:3]
    s = x.to(torch.int32).sum(dim=(1, 2), keepdim=True)
    return sat8(rounded_div(s, h * w))


def eltwise_add(xs, fs, f_out: int, relu: bool = False) -> torch.Tensor:
    acc = functools.reduce(add32, [rescale(x, f, f_out)
                                   for x, f in zip(xs, fs)])
    if relu:
        acc = acc.clamp(min=0)
    return sat8(acc)


def concat(xs, fs, f_out: int) -> torch.Tensor:
    # an input already at f_out is copied as is (a zero shift of int8 is
    # the identity)
    return torch.cat([x if f == f_out else sat8(rescale(x, f, f_out))
                      for x, f in zip(xs, fs)], dim=-1)


def upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)


def reorg(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    n, h, w, c = x.shape
    s = stride
    x = x.reshape(n, h // s, s, w // s, s, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // s, w // s, c * s * s)
