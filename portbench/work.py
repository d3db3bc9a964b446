"""The work a kernel launch must do, the model's operations, and the card's
peaks: the yardstick of the roofline and utilisation metrics.

A launch's bytes count each input, weight, bias and side tensor read once
and its output written once (int8 activations and weights, int32 vectors);
its operations are two per multiply-accumulate of its convolutions.  Neither
counts what a kernel issues beyond that (recomputed halos, padding, repeated
reads), so a share of the roofline above 100% means the time left out work.
A launch is read through its descriptor's fields (``kind``, ``stages``,
``in_name``, ``sides``, ``fc_reshape``, ``out_hw``, ``members``); the sizes
of the tensors it names come from callables, so this file imports nothing
of the program.
"""
from __future__ import annotations

import math

from portbench.reference import model

# Published dense peaks (NVIDIA's H100 SXM data sheet; 700 W), keyed by
# torch.cuda.get_device_name().  A card not listed has no roofline here.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int8_ops_per_s": 1.979e15,
                              "bytes_per_s": 3.35e12},
}


def chain_work(launch, shape, wshape, batch: int) -> tuple[int, int]:
    """(bytes, MACs) of one chain launch over ``batch`` images.
    ``shape(name)`` is a tensor's per-image (H, W, C); ``wshape(name)`` a
    conv or fc layer's weight shape."""
    convs = [st for st in launch.stages if st[0] == "conv"]
    ws = [math.prod(wshape(st[1])) for st in convs]
    ocs = [wshape(st[1])[-1] for st in convs]
    oh, ow = launch.out_hw
    oc = ocs[-1] if ocs else shape(launch.in_name)[-1]
    nbytes = (batch * math.prod(shape(launch.in_name)) + sum(ws)
              + 4 * sum(ocs)
              + batch * sum(math.prod(shape(s)) for s in launch.sides)
              + batch * oh * ow * oc)
    # a conv stage's (oh, ow) are its fields 12 and 13
    macs = sum(batch * st[12] * st[13] * w for st, w in zip(convs, ws))
    return nbytes, macs


def horizontal_work(launch, shape, wshape, batch: int) -> tuple[int, int]:
    """(bytes, MACs) of one horizontal launch: sibling convs on one input,
    their weights stacked on OC, with a bias, shift and ReLU vector each
    (int32) per output channel."""
    ws = [math.prod(wshape(m[0])) for m in launch.members]
    oc = sum(m[1] for m in launch.members)
    oh, ow = launch.out_hw
    nbytes = (batch * math.prod(shape(launch.in_name)) + sum(ws) + 3 * 4 * oc
              + batch * oh * ow * oc)
    return nbytes, batch * oh * ow * sum(ws)


def least_seconds(nbytes: int, macs: int, peak: dict) -> float:
    """The least time the card could take: bytes at its memory bandwidth or
    operations at its int8 peak, whichever is longer."""
    return max(nbytes / peak["bytes_per_s"], 2 * macs / peak["int8_ops_per_s"])


def model_ops(layers) -> int:
    """int8 operations of one image: two per multiply-accumulate of every
    conv and fc layer of the model as written out (``reference.model``),
    not of what the kernels issue."""
    return 2 * model.macs(layers)
