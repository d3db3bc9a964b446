# Copied from src/repro/core/frontend.py; imports point at repro_torch.
"""Front-end lowering: framework graphs -> coarse-grained XGraph.

Mirrors paper §3.2 / Fig. 4: different frameworks emit operations at different
granularities (Caffe: coarse conv+relu layers; TensorFlow: pad / conv2d /
biasadd / relu as separate fine-grained nodes).  The front-end normalizes all
of them into XGraph's coarse vocabulary via three passes:

  1. intrinsic fusion  — pad->conv folding, conv+BN+Scale / conv+bias_add
     parameter pre-computation (the fold itself happens at weight-prep time in
     ``quantize.prepare_params``; the graph pass records what was folded);
  2. point-wise fusion — relu-family after conv/fc/eltwise becomes an
     attribute bit (the CONV instruction's nonlinear bit, §4.1.2);
  3. layout pruning    — flatten is removed outright (NHWC flatten is a memory
     no-op for our layout, exactly the paper's Fig. 2c argument) and concat is
     marked ``folded`` so producers SAVE with strides instead of copying.

Each pass is also expressible through the generic template machinery; we keep
these three as direct passes because they are unconditional rewrites, whereas
kernel fusion (templates.py) is a *choice* costed by the path search.
"""
from __future__ import annotations

from repro_torch.core.xgraph import XGraph, POINTWISE


def lower(g: XGraph) -> XGraph:
    from repro_torch.obs.trace import TRACER

    with TRACER.span("frontend", cat="compile", track="compile",
                     graph=g.name):
        fold_pad(g)
        fold_intrinsics(g)
        fuse_pointwise(g)
        prune_flatten(g)
        fold_concat(g)
        g.validate()
    return g


def fold_pad(g: XGraph) -> None:
    """pad -> conv  becomes conv(pad=explicit)."""
    for name in list(g.nodes):
        node = g.nodes.get(name)
        if node is None or node.op != "pad":
            continue
        pads = tuple(node.attrs["pad"])
        ok = g.consumers(name) and all(
            g.nodes[c].op in ("conv", "dilated_conv", "depthwise_conv")
            for c in g.consumers(name))
        if not ok:
            continue
        for c in g.consumers(name):
            g.nodes[c].attrs["pad"] = pads
        g.remove(name)


def fold_intrinsics(g: XGraph) -> None:
    """bn / scale / bias_add after conv-like are folded into the conv.

    The numeric fold (w' = w*gamma/sqrt(var+eps), b' = ...) is performed by
    ``quantize.prepare_params``; here we record the chain on the conv node so
    weight preparation knows what to fold, and delete the graph nodes.
    """
    changed = True
    while changed:
        changed = False
        for name in list(g.nodes):
            node = g.nodes.get(name)
            if node is None or node.op not in ("bn", "scale", "bias_add"):
                continue
            (src,) = node.inputs
            prod = g.nodes[src]
            if prod.op in ("conv", "dilated_conv", "depthwise_conv", "deconv", "fc"):
                prod.attrs.setdefault("folded_intrinsics", []).append(
                    (node.op, dict(node.attrs)))
                g.remove(name)
                changed = True


def fuse_pointwise(g: XGraph) -> None:
    """relu-family after conv-like / eltwise becomes the nonlinear bit."""
    for name in list(g.nodes):
        node = g.nodes.get(name)
        if node is None or node.op not in POINTWISE:
            continue
        (src,) = node.inputs
        prod = g.nodes[src]
        if prod.op in ("conv", "dilated_conv", "depthwise_conv", "deconv",
                       "fc", "eltwise_add"):
            prod.attrs["relu"] = node.op
            g.remove(name)


def prune_flatten(g: XGraph) -> None:
    for name in list(g.nodes):
        node = g.nodes.get(name)
        if node is None or node.op != "flatten":
            continue
        # NHWC flatten is bit-identical in memory: prune (Fig. 2c).
        g.remove(name)


def fold_concat(g: XGraph) -> None:
    """Channel concat is folded into the producers' strided SAVE."""
    for name in list(g.nodes):
        node = g.nodes.get(name)
        if node is None or node.op != "concat":
            continue
        node.attrs["folded"] = True  # zero-cost in cost model & simulator


# ------------------------------------------------------------------ builders
def tf_style_conv(g: XGraph, name: str, bottom: str, *, oc: int, kernel,
                  stride=(1, 1), pad="same", relu: bool = True) -> str:
    """Emit the fine-grained TensorFlow-style op chain (pad, conv2d, biasadd,
    relu) that ``lower`` collapses into one XGraph conv — used by tests to
    demonstrate front-end decoupling (paper Fig. 4, path ②)."""
    kh, kw = kernel if isinstance(kernel, tuple) else (kernel, kernel)
    last = bottom
    if pad == "same" and (kh > 1 or kw > 1):
        g.add("pad", f"{name}/pad", (last,), pad=((kh - 1) // 2, (kw - 1) // 2))
        last = f"{name}/pad"
        pad = "valid"
    g.add("conv", name, (last,), oc=oc, kernel=(kh, kw), stride=stride, pad=pad)
    g.add("bias_add", f"{name}/bias", (name,))
    last = f"{name}/bias"
    if relu:
        g.add("relu", f"{name}/relu", (last,))
        last = f"{name}/relu"
    return last
