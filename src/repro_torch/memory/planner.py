# Copied from src/repro/memory/planner.py; imports point at repro_torch.
"""Top-level memory planner: liveness -> DDR offsets -> BRAM banks.

``plan_memory`` turns an ordered execution strategy (groups + their tilings)
into a :class:`MemoryPlan`: every DDR activation buffer gets an offset, every
group gets a ping/pong bank assignment, and every address reuse records which
expired buffers it recycles so the assembler can emit write-after-read
dependency bits.  The plan is what upgrades the timing-only instruction
streams of ``core.isa`` into an addressed program a runtime could actually
execute — and what the simulator's hazard checker audits.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.tiling import GroupTiling
from repro_torch.core.xgraph import XGraph
from repro_torch.hw import DeviceModel
from repro_torch.memory.banks import BankPlan, plan_banks
from repro_torch.memory.ddr_alloc import DDRPlan, first_fit
from repro_torch.memory.liveness import activation_intervals


class MemoryPlanError(ValueError):
    """A strategy that cannot be laid out on the device."""


@dataclasses.dataclass
class MemoryPlan:
    ddr: DDRPlan
    intervals: list                 # list[Interval], schedule order
    banks: list                     # list[BankPlan], one per group
    buf_of_node: dict               # exposed node / graph input -> buffer name
    war: list                       # per group: tuple of recycled buffer names
    pin_input: bool = False         # graph-input regions kept out of reuse

    @property
    def peak_bytes(self) -> int:
        return self.ddr.peak_bytes

    @property
    def no_reuse_bytes(self) -> int:
        return self.ddr.no_reuse_bytes

    @property
    def reuse_factor(self) -> float:
        return self.ddr.reuse_factor

    def node_region(self, node: str) -> tuple[int, int]:
        """(DDR offset, bytes) of one node's feature map within its buffer."""
        buf = self.buf_of_node[node]
        base, _ = self.ddr.region_of(buf)
        iv = self.ddr.placements[buf].interval
        names = sorted(iv.parts, key=iv.parts.get)
        i = names.index(node)
        end = iv.parts[names[i + 1]] if i + 1 < len(names) else iv.nbytes
        return base + iv.parts[node], end - iv.parts[node]

    def group_out_region(self, gid: int) -> tuple[int, int]:
        """(DDR offset, bytes) of one group's whole output buffer."""
        iv = self.intervals_by_gid().get(gid)
        if iv is None or iv.nbytes == 0:
            return -1, 0
        base, size = self.ddr.region_of(iv.name)
        return base, size

    def intervals_by_gid(self) -> dict:
        by_gid = getattr(self, "_by_gid", None)
        if by_gid is None:
            by_gid = {iv.writer_gid: iv for iv in self.intervals
                      if iv.writer_gid >= 0}
            self._by_gid = by_gid
        return by_gid

    def summary(self) -> dict:
        return {
            "n_buffers": len(self.intervals),
            "peak_bytes": self.peak_bytes,
            "no_reuse_bytes": self.no_reuse_bytes,
            "reuse_factor": self.reuse_factor,
            "n_reused": len(self.ddr.reuses),
            "double_buffered_groups": sum(
                1 for b in self.banks if b.n_banks_in == 2),
            "pin_input": self.pin_input,
        }


def plan_memory(g: XGraph, groups: list[list[str]],
                tilings: list[GroupTiling], dev: DeviceModel,
                pin_input: bool = False) -> MemoryPlan:
    """Plan DDR + bank layout for ``groups`` (execution order) on ``dev``.

    ``pin_input`` reserves the network input's DDR region for the whole
    schedule (never recycled) — slightly higher peak, but the serving
    runtime's cross-request pre-load guard disappears (see
    ``memory.liveness.activation_intervals``).

    Raises :class:`MemoryPlanError` when a group's tile cannot fit the BRAM
    banks or the activation peak exceeds the device's DDR capacity.
    """
    if len(groups) != len(tilings):
        raise ValueError(f"{len(groups)} groups vs {len(tilings)} tilings")
    eb = dev.elem_bytes
    intervals = activation_intervals(g, groups, eb, pin_input=pin_input)
    ddr = first_fit(intervals, align=dev.ddr_align)
    cap = getattr(dev, "ddr_bytes", 0)
    if cap and ddr.peak_bytes > cap:
        raise MemoryPlanError(
            f"activation peak {ddr.peak_bytes}B exceeds DDR capacity {cap}B "
            f"on {dev.name}")

    banks: list[BankPlan] = []
    for grp, t in zip(groups, tilings):
        bp = plan_banks(t, dev)
        if not bp.feasible:
            raise MemoryPlanError(f"group {grp}: {bp.reason}")
        banks.append(bp)

    buf_of_node = {}
    for iv in intervals:
        for nm in iv.parts:
            buf_of_node[nm] = iv.name

    by_gid = {iv.writer_gid: iv for iv in intervals if iv.writer_gid >= 0}
    war = []
    for gi in range(len(groups)):
        iv = by_gid.get(gi)
        war.append(tuple(ddr.reuses.get(iv.name, ())) if iv else ())

    return MemoryPlan(ddr=ddr, intervals=intervals, banks=banks,
                      buf_of_node=buf_of_node, war=war, pin_input=pin_input)
