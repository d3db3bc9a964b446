# Copied from src/repro/memory/liveness.py; imports point at repro_torch.
"""Activation liveness over the group execution order.

Every DDR-resident activation buffer is either a graph input (written by the
host before step 0) or the exposed output of one execution group (written by
that group's SAVEs).  Exposure is ``XGraph.exposed_outputs`` — the same
helper the assembler (``isa.emit_strategy``) uses, so planner and emitted
SAVE stream cannot desync: a chain group exposes only its tail, a horizontal
group exposes every member; interior nodes of a fused chain never touch DDR,
which is the whole point of kernel fusion.

A buffer's lifetime is the closed step interval [writer step, last reader
step].  Readers outside any group (host-partitioned ops, graph outputs) pin
the buffer to the end of the schedule — the host reads it after the
accelerator finishes, so its space is never recycled.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.xgraph import XGraph


@dataclasses.dataclass
class Interval:
    name: str                      # buffer label, unique per plan
    nbytes: int
    start: int                     # writing step (-1: graph input, pre-loaded)
    end: int                       # last reading step (len(groups): live to end)
    writer_gid: int                # group index, -1 for graph inputs
    parts: dict = dataclasses.field(default_factory=dict)  # node -> byte offset

    def overlaps(self, other: "Interval") -> bool:
        return self.start <= other.end and other.start <= self.end


def activation_intervals(g: XGraph, groups: list[list[str]],
                         elem_bytes: int = 1,
                         pin_input: bool = False) -> list[Interval]:
    """Lifetimes of every DDR activation buffer for ``groups`` in execution
    order.  Buffers with no in-schedule reader (graph outputs, host-consumed
    activations) end at ``len(groups)``.

    ``pin_input`` extends every graph-input buffer to the end of the
    schedule, keeping its DDR region out of the reuse pool: a later group's
    output can then never recycle the input's address, so a pipelined
    serving runtime needs no write-after-read guard between request r's
    recycled SAVEs and request r+ddr_slots's pre-loaded input reads (the
    guard that throttles cross-request overlap in ``runtime.schedule``)."""
    nsteps = len(groups)
    owner: dict[str, int] = {}
    for gi, grp in enumerate(groups):
        for nm in grp:
            owner[nm] = gi

    def last_reader(node_name: str, writer_gid: int) -> int:
        cons = g.consumers(node_name)
        if not cons:
            return nsteps
        end = writer_gid
        for c in cons:
            ci = owner.get(c)
            if ci is None:            # host op or unplanned consumer
                return nsteps
            if ci != writer_gid:      # intra-group reads stay on chip
                end = max(end, ci)
        return end

    intervals: list[Interval] = []
    for node in g:
        if node.op != "input":
            continue
        end = nsteps if pin_input else last_reader(node.name, -1)
        iv = Interval(f"in:{node.name}", g.fmap_bytes(node.name, elem_bytes),
                      start=-1, end=end, writer_gid=-1,
                      parts={node.name: 0})
        intervals.append(iv)

    for gi, grp in enumerate(groups):
        parts, off, end = {}, 0, gi
        for nm in g.exposed_outputs(grp):
            parts[nm] = off
            off += g.fmap_bytes(nm, elem_bytes)
            end = max(end, last_reader(nm, gi))
        intervals.append(Interval(f"g{gi}:{grp[-1]}", off, start=gi, end=end,
                                  writer_gid=gi, parts=parts))
    return intervals
