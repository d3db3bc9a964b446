# Copied from src/repro/core/partition.py; imports point at repro_torch.
"""Mixed compilation (paper §2.3.5): automatically distribute operations
between the accelerator and the host CPU.

The paper maps everything except fully-connected layers onto the FPGA and
compiles the remainder (softmax, detection post-processing, ...) for the CPU
with LLVM.  Here the "host" is plain PyTorch; the partition decides which
nodes the DNNVM planner may schedule on the virtual accelerator.
"""
from __future__ import annotations

from repro_torch.core.xgraph import XGraph, HOST_OPS

POLICIES = ("paper", "all_acc")


def assign(g: XGraph, policy: str = "paper") -> dict:
    """Node -> "acc" | "cpu".  ``paper``: FC on CPU (as deployed in §6.1);
    ``all_acc``: FC on the accelerator (our ISA supports it as a 1x1 conv)."""
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}")
    out = {}
    for node in g:
        if node.op == "input":
            continue
        if node.op in HOST_OPS:
            out[node.name] = "cpu"
        elif node.op == "fc" and policy == "paper":
            out[node.name] = "cpu"
        else:
            out[node.name] = "acc"
    return out


def device_of(g: XGraph, policy: str = "paper"):
    table = assign(g, policy)
    return lambda name: table.get(name, "cpu")
