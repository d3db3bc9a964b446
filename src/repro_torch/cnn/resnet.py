# Copied from src/repro/cnn/resnet.py; imports point at repro_torch.
"""ResNet-50 / ResNet-152 (He et al. 2016) — eltwise-add fusion benchmark.

BN is emitted as explicit nodes so the intrinsic-fusion pass exercises the
paper's conv+BN folding path on a real network."""
from __future__ import annotations

import numpy as np

from repro_torch.core import frontend
from repro_torch.core.xgraph import XGraph


def _conv_bn(g: XGraph, name: str, bottom: str, oc: int, kernel, stride=(1, 1),
             relu: bool = True) -> str:
    g.add("conv", name, (bottom,), oc=oc, kernel=kernel, stride=stride, pad="same")
    g.add("bn", f"{name}/bn", (name,), gamma=1.0, beta=0.0,
          mean=0.0, var=1.0, eps=1e-5)
    last = f"{name}/bn"
    if relu:
        g.add("relu", f"{name}/relu", (last,))
        last = f"{name}/relu"
    return last


def _bottleneck(g: XGraph, name: str, bottom: str, mid: int, out: int,
                stride=(1, 1), project: bool = False) -> str:
    a = _conv_bn(g, f"{name}/c1", bottom, mid, (1, 1))
    b = _conv_bn(g, f"{name}/c2", a, mid, (3, 3), stride=stride)
    c = _conv_bn(g, f"{name}/c3", b, out, (1, 1), relu=False)
    if project:
        s = _conv_bn(g, f"{name}/sc", bottom, out, (1, 1), stride=stride,
                     relu=False)
    else:
        s = bottom
    g.add("eltwise_add", f"{name}/add", (c, s))
    g.add("relu", f"{name}/out", (f"{name}/add",))
    return f"{name}/out"


def _resnet(name: str, blocks: list[int], img: int, num_classes: int, batch: int = 1) -> XGraph:
    g = XGraph(name)
    last = g.input("data", (batch, img, img, 3))
    last = _conv_bn(g, "conv1", last, 64, (7, 7), stride=(2, 2))
    g.add("maxpool", "pool1", (last,), kernel=(3, 3), stride=(2, 2), pad=(0, 0))
    last = "pool1"
    widths = [(64, 256), (128, 512), (256, 1024), (512, 2048)]
    for si, (nb, (mid, out)) in enumerate(zip(blocks, widths)):
        for bi in range(nb):
            stride = (2, 2) if (bi == 0 and si > 0) else (1, 1)
            last = _bottleneck(g, f"s{si}b{bi}", last, mid, out,
                               stride=stride, project=(bi == 0))
    g.add("global_avgpool", "gap", (last,))
    g.add("fc", "fc", ("gap",), oc=num_classes)
    g.add("softmax", "prob", ("fc",))
    return frontend.lower(g)


def resnet50(img: int = 224, num_classes: int = 1000, batch: int = 1) -> XGraph:
    return _resnet("resnet50", [3, 4, 6, 3], img, num_classes, batch)


def resnet152(img: int = 224, num_classes: int = 1000, batch: int = 1) -> XGraph:
    return _resnet("resnet152", [3, 8, 36, 3], img, num_classes, batch)
