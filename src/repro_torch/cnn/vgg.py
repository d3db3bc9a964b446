# Copied from src/repro/cnn/vgg.py; imports point at repro_torch.
"""VGG-16 (Simonyan & Zisserman 2014) — the paper's compute-bound benchmark."""
from __future__ import annotations

from repro_torch.core import frontend
from repro_torch.core.xgraph import XGraph

_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
        512, 512, 512, "M", 512, 512, 512, "M"]


def vgg16(img: int = 224, num_classes: int = 1000, batch: int = 1) -> XGraph:
    g = XGraph("vgg16")
    last = g.input("data", (batch, img, img, 3))
    ci = 0
    for v in _CFG:
        if v == "M":
            g.add("maxpool", f"pool{ci}", (last,), kernel=(2, 2), stride=(2, 2))
            last = f"pool{ci}"
        else:
            ci += 1
            g.add("conv", f"conv{ci}", (last,), oc=v, kernel=(3, 3),
                  stride=(1, 1), pad="same")
            g.add("relu", f"relu{ci}", (f"conv{ci}",))
            last = f"relu{ci}"
    g.add("flatten", "flat", (last,))
    g.add("fc", "fc6", ("flat",), oc=4096)
    g.add("relu", "relu_fc6", ("fc6",))
    g.add("fc", "fc7", ("relu_fc6",), oc=4096)
    g.add("relu", "relu_fc7", ("fc7",))
    g.add("fc", "fc8", ("relu_fc7",), oc=num_classes)
    g.add("softmax", "prob", ("fc8",))
    return frontend.lower(g)
