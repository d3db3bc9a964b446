"""Execution of a compiled strategy on torch tensors (runtime support, §3.2).

Port of ``src/repro/core/executor.py``.  Three paths:

* ``run_float`` / ``build_float_fn`` — float32 reference semantics (the
  calibration and accuracy oracle); on CUDA with TF32 off, so activation
  maxima, and the fractions calibrated from them, are not shifted;
* ``Int8Executor(backend="ref")``  — per-node fixed-point ops from
  ``int8_ops`` (the validation oracle; bit-exact by definition);
* ``Int8Executor(backend="fused")`` — dispatches the compile-time lowered
  ``GroupProgram``: every ``FusedLaunch`` runs as one ``kernels.conv_fused``
  launch, every ``RefFallback`` runs its nodes through the ref ops, with no
  re-lowering at run time.  Bit-exact with "ref" by contract.

Every entry point runs on CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import int8_ops
from repro_torch.core.lower import FusedLaunch
from repro_torch.core.quantize import QuantizedModel
from repro_torch.core.xgraph import XGraph, _padding
from repro_torch.kernels.conv_fused import ops as fused_ops
from repro_torch.obs.trace import TRACER


def resolve_device(device=None) -> torch.device:
    """None means CUDA; raises where CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


@contextlib.contextmanager
def _exact_float32():
    """Full float32 in cuDNN convolutions and cuBLAS products."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


# ------------------------------------------------------------------ float ref
def _float_params(params: dict, dev: torch.device) -> dict:
    return {k: {kk: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                for kk, v in p.items()} for k, p in params.items()}


def _bias(p: dict, w: torch.Tensor) -> torch.Tensor:
    return p["b"] if "b" in p else w.new_zeros(w.shape[-1])


def _pool_pads(g: XGraph, node, x, kh, kw, sh, sw, ph, pw) -> tuple:
    """Caffe ceil extension from the node's inferred output extent."""
    oh, ow = g.shape(node.name)[1:3]
    h, w = x.shape[1:3]
    eh = max(0, (oh - 1) * sh + kh - h - 2 * ph)
    ew = max(0, (ow - 1) * sw + kw - w - 2 * pw)
    return (ph, ph + eh, pw, pw + ew)


def _conv_transpose_same(x, w, stride):
    """``jax.lax.conv_transpose(..., "SAME")`` with an HWIO kernel: dilate
    the input by the stride, pad, and correlate (kernel not flipped)."""
    n, h, wd, c = x.shape
    kh, kw = w.shape[:2]
    sh, sw = stride
    xd = x.new_zeros((n, (h - 1) * sh + 1, (wd - 1) * sw + 1, c))
    xd[:, ::sh, ::sw] = x
    pads = []
    for k, s in ((kh, sh), (kw, sw)):
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
        pads.append((pad_a, pad_len - pad_a))
    xp = F.pad(xd, (0, 0, pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
    y = F.conv2d(xp.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def _float_node(g: XGraph, node, env, params):
    a = node.attrs
    op = node.op
    xs = [env[i] for i in node.inputs]
    if op in ("conv", "dilated_conv", "depthwise_conv"):
        kh, kw = a["kernel"]
        dil = a.get("dilation", (1, 1))
        ph, pw = _padding(a.get("pad", "same"), dil[0] * (kh - 1) + 1,
                          dil[1] * (kw - 1) + 1)
        w = params[node.name]["w"]
        groups = xs[0].shape[-1] if op == "depthwise_conv" else 1
        y = F.conv2d(xs[0].permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     stride=tuple(a.get("stride", (1, 1))), padding=(ph, pw),
                     dilation=tuple(dil), groups=groups).permute(0, 2, 3, 1)
        y = y + _bias(params[node.name], w)
    elif op == "fc":
        w = params[node.name]["w"]
        n = xs[0].shape[0]
        y = (xs[0].reshape(n, -1) @ w + _bias(params[node.name], w)).reshape(
            n, 1, 1, -1)
    elif op in ("maxpool", "avgpool"):
        kh, kw = a["kernel"]
        sh, sw = a.get("stride", a["kernel"])
        ph, pw = _padding(a.get("pad", "valid"), kh, kw)
        pads = _pool_pads(g, node, xs[0], kh, kw, sh, sw, ph, pw)
        if op == "maxpool":
            y = int8_ops.pool_windows(xs[0], (kh, kw), (sh, sw), pads,
                                      float("-inf"), torch.maximum)
        else:
            y = int8_ops.pool_windows(xs[0], (kh, kw), (sh, sw), pads, 0.0,
                                      torch.add) / (kh * kw)
    elif op == "global_avgpool":
        y = xs[0].mean(dim=(1, 2), keepdim=True)
    elif op == "eltwise_add":
        y = sum(xs)
    elif op == "concat":
        y = torch.cat(xs, dim=-1)
    elif op == "upsample":
        y = int8_ops.upsample(xs[0], a.get("factor", 2))
    elif op == "reorg":
        y = int8_ops.reorg(xs[0], a.get("stride", 2))
    elif op == "softmax":
        y = torch.softmax(xs[0], dim=-1)
    elif op == "deconv":
        w = params[node.name]["w"]
        y = _conv_transpose_same(xs[0], w, a.get("stride", (2, 2)))
        y = y + _bias(params[node.name], w)
    else:
        raise ValueError(f"float executor: unknown op {op}")
    if a.get("relu"):
        y = torch.relu(y)
    return y


def _run_float_env(g: XGraph, params: dict, x, dev) -> dict:
    env = {}
    with torch.no_grad(), _exact_float32():
        xt = torch.as_tensor(np.asarray(x, np.float32), device=dev) \
            if not torch.is_tensor(x) else x.to(dev, torch.float32)
        for node in g:
            env[node.name] = (xt if node.op == "input"
                              else _float_node(g, node, env, params))
    return env


def run_float(g: XGraph, params: dict, x, device=None) -> dict:
    """All node activations as float32 numpy arrays (used by calibration:
    ``quantize.calibrate(g, params, x, run_float)``)."""
    dev = resolve_device(device)
    env = _run_float_env(g, _float_params(params, dev), x, dev)
    return {k: v.cpu().numpy() for k, v in env.items()}


def build_float_fn(g: XGraph, params: dict, device=None):
    """x -> {graph output: float32 tensor on the device}."""
    dev = resolve_device(device)
    outputs = [n.name for n in g if not g.consumers(n.name)]
    p = _float_params(params, dev)

    def fn(x):
        env = _run_float_env(g, p, x, dev)
        return {o: env[o] for o in outputs}

    return fn


# -------------------------------------------------------------------- int8
def _int8_node(g: XGraph, node, env, qm: QuantizedModel, wts: dict):
    """One node with ``int8_ops`` semantics; ``wts`` maps a conv/fc node to
    its (weight, bias) tensors on the device."""
    a, op = node.attrs, node.op
    xs = [env[i] for i in node.inputs]
    relu = bool(a.get("relu"))
    if op in ("conv", "dilated_conv"):
        kh, kw = a["kernel"]
        dil = a.get("dilation", (1, 1))
        ph, pw = _padding(a.get("pad", "same"), dil[0] * (kh - 1) + 1,
                          dil[1] * (kw - 1) + 1)
        w, b = wts[node.name]
        return int8_ops.conv2d(xs[0], w, b, stride=a.get("stride", (1, 1)),
                               pad=(ph, pw), dilation=dil,
                               shift=qm.shift_for(g, node.name), relu=relu)
    if op == "depthwise_conv":
        kh, kw = a["kernel"]
        ph, pw = _padding(a.get("pad", "same"), kh, kw)
        w, b = wts[node.name]
        return int8_ops.depthwise_conv2d(
            xs[0], w, b, stride=a.get("stride", (1, 1)), pad=(ph, pw),
            shift=qm.shift_for(g, node.name), relu=relu)
    if op == "fc":
        w, b = wts[node.name]
        return int8_ops.fc(xs[0], w, b, shift=qm.shift_for(g, node.name),
                           relu=relu)
    if op == "maxpool":
        kh, kw = a["kernel"]
        ph, pw = _padding(a.get("pad", "valid"), kh, kw)
        return int8_ops.maxpool(xs[0], kernel=a["kernel"],
                                stride=a.get("stride", a["kernel"]),
                                pad=(ph, pw), ceil_mode=a.get("ceil_mode", True))
    if op == "avgpool":
        kh, kw = a["kernel"]
        ph, pw = _padding(a.get("pad", "valid"), kh, kw)
        return int8_ops.avgpool(xs[0], kernel=a["kernel"],
                                stride=a.get("stride", a["kernel"]),
                                pad=(ph, pw), ceil_mode=a.get("ceil_mode", True))
    if op == "global_avgpool":
        return int8_ops.global_avgpool(xs[0])
    if op == "eltwise_add":
        fs = [qm.f_a[i] for i in node.inputs]
        return int8_ops.eltwise_add(xs, fs, qm.f_a[node.name], relu=relu)
    if op == "concat":
        fs = [qm.f_a[i] for i in node.inputs]
        return int8_ops.concat(xs, fs, qm.f_a[node.name])
    if op == "upsample":
        return int8_ops.upsample(xs[0], a.get("factor", 2))
    if op == "reorg":
        return int8_ops.reorg(xs[0], a.get("stride", 2))
    if op == "softmax":  # host op: dequantize, float softmax
        f_in = qm.f_a[node.inputs[0]]
        return torch.softmax(xs[0].to(torch.float32) * 2.0 ** -f_in, dim=-1)
    raise ValueError(f"int8 executor: unknown op {op}")


class Int8Executor:
    """Executes a fusion strategy on int8 data.

    backend="ref"   : per-node fixed-point ops (oracle).
    backend="fused" : dispatches the lowered ``GroupProgram`` — one
                      ``kernels.conv_fused`` launch per FusedLaunch (the
                      plain PyTorch versions on the CPU), the ref path per
                      RefFallback.  Bit-exact with "ref" by contract.

    Weights move to the device once, here; so do each fused launch's
    stacked weights and shift/ReLU vectors."""

    BACKENDS = ("ref", "fused")

    def __init__(self, g: XGraph, qm: QuantizedModel, strategy=None,
                 backend: str = "ref", device=None):
        """``strategy`` is a ``pathsearch.Strategy``, anything carrying a
        quantized ``.program`` (dispatched as is), or None (naive, one
        group per node)."""
        if backend not in self.BACKENDS:
            raise ValueError(f"backend {backend!r} not in {self.BACKENDS}")
        self.g, self.qm, self.backend = g, qm, backend
        self.device = resolve_device(device)
        self.groups = None
        self.program = None
        if backend == "fused":
            prog = getattr(strategy, "program", None)
            if prog is None or not prog.meta.get("quantized"):
                from repro_torch.core import lower
                prog = lower.lower_strategy(g, strategy, qm)
            self.program = prog
        elif strategy is not None:
            # horizontal (shared-input) groups execute per member — the
            # sharing is a LOAD-time optimization, numerics are identical
            from repro_torch.core.pathsearch import order_groups
            groups = [list(grp) for grp in strategy.groups]
            groups += [[m] for hg in strategy.horizontal for m in hg]
            groups += [[h] for h in strategy.meta.get("host_nodes", [])]
            self.groups = order_groups(g, groups)
        else:
            self.groups = [[n] for n in g.compute_nodes()]
        self._wts = {
            name: (torch.as_tensor(np.asarray(qm.weights[name], np.int8),
                                   device=self.device),
                   torch.as_tensor(np.asarray(qm.biases[name], np.int32),
                                   device=self.device))
            for name in qm.weights}
        self._prepared = None
        if self.program is not None:
            self._prepared = [
                fused_ops.prepare_launch(item, qm, self.device)
                if isinstance(item, FusedLaunch) else None
                for item in self.program.items]
        self._fb_reasons = None
        self._outputs = [n.name for n in g if not g.consumers(n.name)]
        self._inputs = [n.name for n in g if n.op == "input"]
        self._in_shape = (g.shape(self._inputs[0]) if self._inputs else None)

    def _validate_input(self, x) -> None:
        """Fail fast with a clear message.  Any batch N >= 1 is accepted;
        dtype, rank and the per-image extents must match the graph."""
        shape = tuple(getattr(x, "shape", ()) or ())
        dtype = getattr(x, "dtype", None)
        if dtype not in (torch.int8, np.int8, np.dtype(np.int8)):
            raise ValueError(
                f"Int8Executor input must be int8 (quantize first, e.g. "
                f"quantize.quantize_to(x, qm.f_a[input])); got dtype {dtype}")
        if self._in_shape is None:
            return
        if len(shape) != 4:
            raise ValueError(
                f"Int8Executor input must be rank-4 NHWC; got shape {shape}")
        if tuple(shape[1:]) != tuple(self._in_shape[1:]):
            raise ValueError(
                f"Int8Executor input spatial/channel extents {shape[1:]} "
                f"do not match the compiled graph's {tuple(self._in_shape[1:])} "
                f"(any batch size is accepted; H/W/C are fixed at compile time)")
        if shape[0] < 1:
            raise ValueError("Int8Executor input batch must be >= 1")

    def _run(self, x: torch.Tensor) -> dict:
        g, qm = self.g, self.qm
        env = {name: x for name in self._inputs}
        if self.program is not None:
            steps = zip(self.program.items, self._prepared)
            if TRACER.enabled:
                batch = int(x.shape[0])
                for i, (item, prep) in enumerate(steps):
                    name, span = self._item_span(i, item, batch, env)
                    with torch.profiler.record_function(name):
                        self._step(item, prep, env, span)
            else:
                for item, prep in steps:
                    self._step(item, prep, env)
        else:
            for group in self.groups:
                for name in group:
                    env[name] = _int8_node(g, g.nodes[name], env, qm,
                                           self._wts)
        return {o: env[o] for o in self._outputs}

    def _step(self, item, prep, env: dict, span=None) -> None:
        """Run one item of the program into ``env``.  ``span`` times the
        item's device work: a fused launch's kernel alone (``run_launch``
        opens it after the launch's host preparation), or every node of a
        fallback."""
        if isinstance(item, FusedLaunch):
            env.update(fused_ops.run_launch(item, env, prepared=prep,
                                            span=span))
        else:
            with span if span is not None else contextlib.nullcontext():
                for name in item.nodes:
                    env[name] = _int8_node(self.g, self.g.nodes[name], env,
                                           self.qm, self._wts)

    def _item_span(self, i: int, item, batch: int, env: dict):
        """Item ``i``'s name, ``item<i>:<kind>:<first node>``, for its
        profiler range, and its device span of that name, whose args say
        which launch it is and at what batch; a chain launch's also say how
        many images a block takes (``ni``) and the weight bytes its blocks
        fetch by the planner's count (``w_fetch_bytes``)."""
        kind = item.kind if isinstance(item, FusedLaunch) else "fallback"
        name = f"item{i}:{kind}:{item.nodes[0]}"
        out = getattr(item, "out_name", "") or item.nodes[-1]
        plan = {}
        if kind == "chain":
            plan = fused_ops.launch_plan_args(
                item, tuple(env[item.in_name].shape),
                [self.g.shape(st[1])[3] for st in item.stages
                 if st[0] == "conv"])
        return name, TRACER.device_span(name, self.device, cat="executor",
                                        index=i, kind=kind, out=out,
                                        batch=batch, **plan)

    def __call__(self, x) -> dict:
        """{graph output: tensor on the executor's device}."""
        from repro_torch.obs.metrics import REGISTRY

        self._validate_input(x)
        xt = torch.as_tensor(x).to(self.device)
        with torch.no_grad():
            out = self._run(xt)
        REGISTRY.counter("executor.calls").inc()
        if self.program is not None:
            REGISTRY.counter("executor.fused_launches").inc(
                self.program.meta.get("n_launches", 0))
            REGISTRY.counter("executor.fallback_launches").inc(
                self.program.meta.get("n_fallbacks", 0))
            # per-reason fallback counters (lower.FALLBACK_REASONS)
            for reason, n in self._fallback_reasons().items():
                REGISTRY.counter("executor.fallback",
                                 {"reason": reason}).inc(n)
        return out

    def _fallback_reasons(self) -> dict:
        """reason -> launches-per-call, computed once from the program."""
        if self._fb_reasons is None:
            self._fb_reasons = dict(Counter(
                fb.reason for fb in self.program.fallbacks()))
        return self._fb_reasons


def build_group_callable(g: XGraph, group: list, params_or_qm, device=None):
    """One group as a standalone callable with random inputs on ``device``
    (None: CUDA) — the on-board evaluator's unit of measurement.  A
    ``QuantizedModel`` runs the group's nodes through the per-node int8
    path, float params through the float path; the weights move to the
    device here, once."""
    dev = resolve_device(device)
    in_names = list(dict.fromkeys(
        i for nm in group for i in g.nodes[nm].inputs if i not in group))
    gen = torch.Generator(device=dev).manual_seed(0)

    if isinstance(params_or_qm, QuantizedModel):
        qm = params_or_qm
        # full-range int8 activations: near-zero data would let saturation
        # work go unexercised and skew the timings
        ins = [torch.randint(-128, 128, tuple(g.shape(i)), generator=gen,
                             dtype=torch.int8, device=dev) for i in in_names]
        wts = {nm: (torch.as_tensor(np.asarray(qm.weights[nm], np.int8),
                                    device=dev),
                    torch.as_tensor(np.asarray(qm.biases[nm], np.int32),
                                    device=dev))
               for nm in group if nm in qm.weights}

        def fn(*xs):
            env = dict(zip(in_names, xs))
            with torch.no_grad():
                for nm in group:
                    env[nm] = _int8_node(g, g.nodes[nm], env, qm, wts)
            return env[group[-1]]
    else:
        params = _float_params({nm: params_or_qm[nm] for nm in group
                                if nm in params_or_qm}, dev)
        ins = [torch.randn(tuple(g.shape(i)), generator=gen, device=dev)
               for i in in_names]

        def fn(*xs):
            env = dict(zip(in_names, xs))
            with torch.no_grad(), _exact_float32():
                for nm in group:
                    env[nm] = _float_node(g, g.nodes[nm], env, params)
            return env[group[-1]]

    return fn, ins
