# Copied from src/repro/memory/banks.py; imports point at repro_torch.
"""Ping/pong bank split of the on-chip buffers (paper §3.1 / Eq. 6).

The accelerator pre-allocates BRAM regions B_in and B_out.  Double buffering
— LOAD(t+1) streaming into one bank while CONV(t) reads the other — needs
*two* tile-sized banks per region.  The planner:

* assigns 2 banks when two tile working sets fit the region (the normal,
  fully pipelined case);
* falls back to 1 bank when only one tile fits — the tile chain serializes
  (LOAD(t+1) must wait for the consumer of tile t), which the assembler
  enforces with bank-reuse dependency bits;
* rejects the tiling outright when even a single tile exceeds the region
  (cannot happen for tilings produced by ``tiling.solve``, which checks the
  same bound, but callers may hand-construct tilings).

Full-channel intermediates of a fused conv->conv chain stay resident in B_out
across oc passes, so only the final output tile swings between banks — the
resident bytes are charged once, not per bank.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.tiling import GroupTiling
from repro_torch.hw import DeviceModel


@dataclasses.dataclass(frozen=True)
class BankPlan:
    feasible: bool
    n_banks_in: int = 1
    n_banks_out: int = 1
    in_bank_bytes: int = 0         # capacity of one B_in bank
    out_bank_bytes: int = 0        # capacity of one B_out bank
    reason: str = ""
    # bank-assignment policy is tile % n_banks, implemented where the banks
    # are stamped onto instructions (isa.emit_group) — single source of truth


def plan_banks(tiling: GroupTiling, dev: DeviceModel) -> BankPlan:
    """Bank assignment for one group's tiling on ``dev``."""
    if not tiling.feasible:
        return BankPlan(False, reason="tiling itself is infeasible")
    in_need = tiling.in_tile_bytes
    out_need = tiling.out_tile_bytes
    resident = tiling.resident_bytes
    if in_need > dev.buf_in_bytes:
        return BankPlan(False, reason=(
            f"input tile {in_need}B exceeds B_in {dev.buf_in_bytes}B"))
    if out_need + resident > dev.buf_out_bytes:
        return BankPlan(False, reason=(
            f"output tile {out_need}B + resident {resident}B exceeds "
            f"B_out {dev.buf_out_bytes}B"))
    n_in = 2 if 2 * in_need <= dev.buf_in_bytes else 1
    n_out = 2 if 2 * out_need + resident <= dev.buf_out_bytes else 1
    return BankPlan(
        True, n_banks_in=n_in, n_banks_out=n_out,
        in_bank_bytes=dev.buf_in_bytes // n_in,
        out_bank_bytes=(dev.buf_out_bytes - resident) // n_out)
