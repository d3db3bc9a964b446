"""A plain forward pass of a CNN given as a list of layers.

A layer is ``(name, op, inputs, attrs)``.  ``input`` (attrs ``shape``: H,
W, C) starts the list; every other op is an :class:`Op` of ``OPS``:
``conv`` (``oc``, ``kernel``, ``stride``, ``pad``, ``relu``), ``fc``
(``oc``, ``relu``; the input flattened in H, W, C order), ``maxpool``
(``kernel``, ``stride``, ``pad``; Caffe's ceil mode), ``gap`` (global
average pool), ``concat`` (on channels) and ``softmax``.  An op not in
``OPS`` is taken from ``ops/<op>.py`` beside this file, whose ``OP`` is its
:class:`Op`: a new layer kind is a new file.  Tensors are NHWC; conv
weights are (KH, KW, IC, OC), fc weights (IN, OC).

``float_forward`` runs the float32 model (TF32 off), which calibration
reads.  :class:`FixedPointModel` calibrates from it as DNNVM does (a
fraction per tensor from its float values, then each op's own rule, as a
concat's output at the least fraction of its inputs; weights and biases
quantized at their own fractions) and runs the fixed-point forward exactly:
int32 sums, shifts and saturation from ``int8.py``, the softmax in float64.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import math
import pathlib

import torch
import torch.nn.functional as F

from portbench.reference import int8


@dataclasses.dataclass
class Step:
    """What a fixed-point op reads besides its inputs."""
    f: int                      # the output's fraction
    f_ins: list                 # the inputs' fractions
    bits: int
    w: torch.Tensor | None = None   # quantized weights, for ops with weights
    b: torch.Tensor | None = None   # int32 bias at f_in + f_w
    shift: int = 0                  # f_in + f_w - f


class Op:
    """One layer kind.  ``ins`` are the inputs' per-image (H, W, C)."""

    def shape(self, a, ins) -> tuple:
        return ins[0]

    def weight(self, a, ins):
        """(weight shape, fan in), or None for an op without weights."""
        return None

    def fraction(self, f: int, f_ins: list) -> int:
        """The output's fraction, from its own float values' ``f``."""
        return f

    def float(self, a, xs, wb):
        raise NotImplementedError

    def fixed(self, a, xs, q: Step):
        raise NotImplementedError


class Conv(Op):
    def shape(self, a, ins):
        h, w, _ = ins[0]
        (kh, kw), (sh, sw), (ph, pw) = a["kernel"], a["stride"], a["pad"]
        return ((h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1,
                a["oc"])

    def weight(self, a, ins):
        kh, kw = a["kernel"]
        c = ins[0][2]
        return (kh, kw, c, a["oc"]), kh * kw * c

    def float(self, a, xs, wb):
        w, b = wb
        y = F.conv2d(xs[0].permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     stride=a["stride"], padding=a["pad"])
        return y.permute(0, 2, 3, 1) + b

    def fixed(self, a, xs, q):
        acc = int8.int_conv(xs[0], q.w, a["stride"], a["pad"])
        return int8.requantize(acc, q.b, q.shift, bool(a.get("relu")),
                               q.bits)


class FC(Op):
    def shape(self, a, ins):
        return (1, 1, a["oc"])

    def weight(self, a, ins):
        n = math.prod(ins[0])
        return (n, a["oc"]), n

    def float(self, a, xs, wb):
        w, b = wb
        n = xs[0].shape[0]
        return (xs[0].reshape(n, -1) @ w + b).reshape(n, 1, 1, -1)

    def fixed(self, a, xs, q):
        n = xs[0].shape[0]
        acc = int8.int_matmul(xs[0].reshape(n, -1), q.w)
        return int8.requantize(acc, q.b, q.shift, bool(a.get("relu")),
                               q.bits).reshape(n, 1, 1, -1)


class MaxPool(Op):
    def shape(self, a, ins):
        h, w, c = ins[0]
        (kh, kw), (sh, sw), (ph, pw) = a["kernel"], a["stride"], a["pad"]
        return (math.ceil((h + 2 * ph - kh) / sh) + 1,
                math.ceil((w + 2 * pw - kw) / sw) + 1, c)

    def float(self, a, xs, wb):
        return int8.max_pool(xs[0], a["kernel"], a["stride"], a["pad"],
                             float("-inf"))

    def fixed(self, a, xs, q):
        return int8.max_pool(xs[0], a["kernel"], a["stride"], a["pad"],
                             int8.qrange(8)[0])


class GlobalAvgPool(Op):
    def shape(self, a, ins):
        return (1, 1, ins[0][2])

    def float(self, a, xs, wb):
        return xs[0].mean(dim=(1, 2), keepdim=True)

    def fixed(self, a, xs, q):
        h, w = xs[0].shape[1:3]
        return int8.saturate(int8.rounded_div(
            xs[0].sum(dim=(1, 2), keepdim=True), h * w), q.bits)


class Concat(Op):
    def shape(self, a, ins):
        h, w, _ = ins[0]
        return (h, w, sum(i[2] for i in ins))

    def fraction(self, f, f_ins):
        return min([f] + list(f_ins))

    def float(self, a, xs, wb):
        return torch.cat(xs, dim=-1)

    def fixed(self, a, xs, q):
        return torch.cat([
            t if fi == q.f else int8.saturate(
                int8.round_shift(t, fi - q.f), q.bits)
            for fi, t in zip(q.f_ins, xs)], dim=-1)


class Softmax(Op):
    def float(self, a, xs, wb):
        return torch.softmax(xs[0], dim=-1)

    def fixed(self, a, xs, q):
        z = xs[0].to(torch.float64) * 2.0 ** -q.f_ins[0]
        return torch.softmax(z, dim=-1)


OPS_DIR = pathlib.Path(__file__).resolve().parent / "ops"
OPS = {"conv": Conv(), "fc": FC(), "maxpool": MaxPool(),
       "gap": GlobalAvgPool(), "concat": Concat(), "softmax": Softmax()}


def op(kind: str) -> Op:
    """The op ``kind``: from ``OPS``, else ``OP`` of ``OPS_DIR/<kind>.py``."""
    if kind not in OPS:
        path = OPS_DIR / f"{kind}.py"
        if not path.is_file():
            raise ValueError(f"unknown op {kind!r}: not in model.OPS and no "
                             f"{path}")
        spec = importlib.util.spec_from_file_location(
            f"portbench_op_{kind}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        OPS[kind] = mod.OP
    return OPS[kind]


def shapes(layers) -> dict:
    """Per-image (H, W, C) of every layer's output."""
    out: dict = {}
    for name, kind, ins, a in layers:
        out[name] = (tuple(a["shape"]) if kind == "input"
                     else op(kind).shape(a, [out[i] for i in ins]))
    return out


def param_shapes(layers) -> list:
    """(name, weight shape, fan in) of every layer with weights, in order."""
    shp = shapes(layers)
    res = []
    for name, kind, ins, a in layers:
        if kind == "input":
            continue
        wt = op(kind).weight(a, [shp[i] for i in ins])
        if wt is not None:
            res.append((name,) + wt)
    return res


def macs(layers) -> int:
    """Multiply-accumulates of one image through every layer with weights:
    each output pixel takes every weight once."""
    shp = shapes(layers)
    return sum(shp[name][0] * shp[name][1] * math.prod(wshape)
               for name, wshape, _ in param_shapes(layers))


@contextlib.contextmanager
def _exact_float32():
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def float_forward(layers, weights: dict, x: torch.Tensor) -> dict:
    """Every layer's float32 output for a float32 NHWC batch ``x``;
    ``weights`` maps a layer with weights to its (w, b)."""
    env: dict = {}
    with torch.no_grad(), _exact_float32():
        for name, kind, ins, a in layers:
            if kind == "input":
                env[name] = x
                continue
            y = op(kind).float(a, [env[i] for i in ins], weights.get(name))
            env[name] = torch.relu(y) if a.get("relu") else y
    return env


class FixedPointModel:
    """The model calibrated on one float image and run in fixed point at
    ``bits`` (8: the reference; 4: the lower-precision control)."""

    def __init__(self, layers, weights: dict, calib: torch.Tensor,
                 bits: int = 8):
        self.layers, self.bits = layers, bits
        acts = float_forward(layers, weights, calib)
        self.f = {name: int8.best_fraction(a, bits)
                  for name, a in acts.items()}
        for name, kind, ins, _ in layers:
            if kind != "input":
                self.f[name] = op(kind).fraction(self.f[name],
                                                 [self.f[i] for i in ins])
        self.w, self.b, self.shift = {}, {}, {}
        for name, (w, b) in weights.items():
            fw = int8.best_fraction(w, bits)
            f_in = self.f[self._input_of(name)]
            self.w[name] = int8.quantize(w, fw, bits)
            self.b[name] = int8.quantize(b, f_in + fw, 32)
            self.shift[name] = f_in + fw - self.f[name]
        del acts

    def _input_of(self, name: str) -> str:
        return next(ins[0] for n, _, ins, _ in self.layers if n == name)

    def forward(self, x: torch.Tensor, f_x: int) -> torch.Tensor:
        """Class probabilities (N, classes) in float64 for integer NHWC
        images ``x`` at fraction ``f_x``."""
        bits = self.bits
        last_use = {}
        for i, (_, _, ins, _) in enumerate(self.layers):
            for n in ins:
                last_use[n] = i
        env: dict = {}
        with torch.no_grad():
            for i, (name, kind, ins, a) in enumerate(self.layers):
                if kind == "input":
                    x = x.to(torch.int64)
                    if f_x != self.f[name]:
                        x = int8.saturate(
                            int8.round_shift(x, f_x - self.f[name]), bits)
                    env[name] = x
                    continue
                q = Step(self.f[name], [self.f[n] for n in ins], bits,
                         self.w.get(name), self.b.get(name),
                         self.shift.get(name, 0))
                env[name] = op(kind).fixed(a, [env[n] for n in ins], q)
                for n in ins:
                    if last_use[n] == i:
                        del env[n]
        out = env[self.layers[-1][0]]
        return out.reshape(out.shape[0], -1)
