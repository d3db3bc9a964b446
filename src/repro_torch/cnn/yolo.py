# Copied from src/repro/cnn/yolo.py; imports point at repro_torch.
"""A YOLO-style straight-line detector neck — exercises the no-branch Floyd
path (paper §5.2: "CNNs with no branch like VGG and YOLO") plus the reorg op."""
from __future__ import annotations

from repro_torch.core import frontend
from repro_torch.core.xgraph import XGraph


def yolo_lite(img: int = 224, num_anchors: int = 5, num_classes: int = 20) -> XGraph:
    g = XGraph("yolo_lite")
    last = g.input("data", (1, img, img, 3))
    oc = 16
    for i in range(5):
        g.add("conv", f"conv{i}", (last,), oc=oc, kernel=(3, 3), pad="same")
        g.add("relu", f"relu{i}", (f"conv{i}",))
        g.add("maxpool", f"pool{i}", (f"relu{i}",), kernel=(2, 2), stride=(2, 2))
        last = f"pool{i}"
        oc = min(oc * 2, 512)
    g.add("reorg", "reorg", (last,), stride=2)
    g.add("conv", "head1", ("reorg",), oc=512, kernel=(3, 3), pad="same")
    g.add("relu", "head1/r", ("head1",))
    out_c = num_anchors * (5 + num_classes)
    g.add("conv", "head2", ("head1/r",), oc=out_c, kernel=(1, 1), pad="same")
    return frontend.lower(g)
