# Copied from src/repro/memory/ddr_alloc.py; imports point at repro_torch.
"""First-fit DDR offset allocation over activation lifetimes.

Classic interval-graph register allocation applied to DDR: process buffers in
schedule order and place each at the lowest aligned offset that does not
collide with any *concurrently live* buffer.  Buffers whose lifetimes are
disjoint may share addresses — that reuse is what separates the peak DDR
footprint from the sum-of-all-buffers baseline, and every reuse is recorded so
the assembler can emit the write-after-read dependency protecting it (the
previous tenant's last LOAD must retire before the new tenant's first SAVE).
"""
from __future__ import annotations

import dataclasses

from repro_torch.memory.liveness import Interval


@dataclasses.dataclass
class Placement:
    interval: Interval
    offset: int
    size: int                      # aligned size actually reserved

    @property
    def limit(self) -> int:
        return self.offset + self.size


@dataclasses.dataclass
class DDRPlan:
    placements: dict                # buffer name -> Placement
    peak_bytes: int                 # max concurrent footprint (with reuse)
    no_reuse_bytes: int             # sum of all buffers (baseline)
    align: int
    reuses: dict                    # buffer name -> [expired buffer names whose
                                    #                 address range it recycles]

    @property
    def reuse_factor(self) -> float:
        return self.no_reuse_bytes / max(1, self.peak_bytes)

    def region_of(self, buf_name: str) -> tuple[int, int]:
        p = self.placements[buf_name]
        return p.offset, p.interval.nbytes


def first_fit(intervals: list[Interval], align: int = 64) -> DDRPlan:
    """Place every interval; returns the plan with peak/no-reuse footprints."""
    def up(n: int) -> int:
        return max(align, (n + align - 1) // align * align)

    placed: list[Placement] = []
    placements: dict[str, Placement] = {}
    reuses: dict[str, list[str]] = {}
    order = sorted(intervals, key=lambda iv: (iv.start, -iv.nbytes, iv.name))
    for iv in order:
        size = up(iv.nbytes)
        live = sorted((p for p in placed if p.interval.overlaps(iv)),
                      key=lambda p: p.offset)
        off = 0
        for p in live:
            if off + size <= p.offset:
                break
            off = max(off, p.limit)
        pl = Placement(iv, off, size)
        placed.append(pl)
        placements[iv.name] = pl
        recycled = [p.interval.name for p in placed[:-1]
                    if not p.interval.overlaps(iv)
                    and p.offset < pl.limit and off < p.limit]
        if recycled:
            reuses[iv.name] = recycled
    peak = max((p.limit for p in placed), default=0)
    total = sum(p.size for p in placed)
    return DDRPlan(placements=placements, peak_bytes=peak,
                   no_reuse_bytes=total, align=align, reuses=reuses)
