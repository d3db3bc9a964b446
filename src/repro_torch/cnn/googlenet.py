# Copied from src/repro/cnn/googlenet.py; imports point at repro_torch.
"""GoogLeNet v1 (Szegedy et al. 2015) — Inception: the horizontal-fusion and
folded-concat benchmark (paper §5.2, Fig. 4)."""
from __future__ import annotations

from repro_torch.core import frontend
from repro_torch.core.xgraph import XGraph

# (1x1, 3x3red, 3x3, 5x5red, 5x5, pool_proj) per inception module
_INCEPTION = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


def _conv(g, name, bottom, oc, k, stride=(1, 1)) -> str:
    g.add("conv", name, (bottom,), oc=oc, kernel=(k, k), stride=stride, pad="same")
    g.add("relu", f"{name}/r", (name,))
    return f"{name}/r"


def _inception(g: XGraph, name: str, bottom: str, cfg) -> str:
    c1, r3, c3, r5, c5, pp = cfg
    b1 = _conv(g, f"{name}/1x1", bottom, c1, 1)
    b2 = _conv(g, f"{name}/3x3r", bottom, r3, 1)
    b2 = _conv(g, f"{name}/3x3", b2, c3, 3)
    b3 = _conv(g, f"{name}/5x5r", bottom, r5, 1)
    b3 = _conv(g, f"{name}/5x5", b3, c5, 5)
    g.add("maxpool", f"{name}/pool", (bottom,), kernel=(3, 3), stride=(1, 1),
          pad=(1, 1))
    b4 = _conv(g, f"{name}/poolp", f"{name}/pool", pp, 1)
    g.add("concat", f"{name}/out", (b1, b2, b3, b4))
    return f"{name}/out"


def googlenet(img: int = 224, num_classes: int = 1000, batch: int = 1) -> XGraph:
    g = XGraph("googlenet")
    last = g.input("data", (batch, img, img, 3))
    last = _conv(g, "conv1", last, 64, 7, stride=(2, 2))
    g.add("maxpool", "pool1", (last,), kernel=(3, 3), stride=(2, 2), pad=(0, 0))
    last = _conv(g, "conv2r", "pool1", 64, 1)
    last = _conv(g, "conv2", last, 192, 3)
    g.add("maxpool", "pool2", (last,), kernel=(3, 3), stride=(2, 2), pad=(0, 0))
    last = "pool2"
    for mod in ("3a", "3b"):
        last = _inception(g, f"inc{mod}", last, _INCEPTION[mod])
    g.add("maxpool", "pool3", (last,), kernel=(3, 3), stride=(2, 2), pad=(0, 0))
    last = "pool3"
    for mod in ("4a", "4b", "4c", "4d", "4e"):
        last = _inception(g, f"inc{mod}", last, _INCEPTION[mod])
    g.add("maxpool", "pool4", (last,), kernel=(3, 3), stride=(2, 2), pad=(0, 0))
    last = "pool4"
    for mod in ("5a", "5b"):
        last = _inception(g, f"inc{mod}", last, _INCEPTION[mod])
    g.add("global_avgpool", "gap", (last,))
    g.add("fc", "fc", ("gap",), oc=num_classes)
    g.add("softmax", "prob", ("fc",))
    return frontend.lower(g)
