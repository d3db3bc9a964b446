# Copied from src/repro/core/simulator.py; imports point at repro_torch.
"""Cycle-level time-wheel simulator (paper §5.1, evaluation method 3).

"We record the number of cycles consumption for each hardware block according
to our hardware design ... then we insert each instruction into a time wheel
after analyzing the dependencies among them."

Engines mirror the accelerator's execution modules: one DDR port (shared by
LOAD and SAVE — the Bank-arbiter view), a CONV array, a POOL unit and a MISC
unit.  Each engine retires its instructions in program order; an instruction
starts at max(engine free, all deps done).  That single rule reproduces the
pipelining the paper exploits: LOAD(t+1) overlaps CONV(t) because nothing
orders them, while CONV(t) -> POOL(t) -> SAVE(t) chain through their
dependency bits (Fig. 8/9 timelines).

For address-bearing streams (``isa.emit_strategy`` with a MemoryPlan) the
simulator doubles as a *memory-correctness oracle*, the scheduling analogue
of the validation environment's bit-exactness oracle: ``memory_hazards``
replays the schedule and flags

* overlapping live DDR windows — two groups' SAVE regions share addresses
  while one of them is still being read (a broken reuse plan would silently
  corrupt activations on real hardware);
* ping/pong bank hazards — a LOAD streams into a BRAM bank a previous tile
  is still computing from, or a compute overwrites an out-bank before its
  SAVE drained it.

``check`` turns any hazard into a hard :class:`MemoryHazardError`.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.isa import Instr, ENGINES, COMPUTE_ENGINES


class MemoryHazardError(AssertionError):
    """An addressed instruction stream whose schedule corrupts memory."""


@dataclasses.dataclass
class SimReport:
    total_cycles: int
    busy_cycles: dict      # engine -> busy
    n_instructions: int

    def utilization(self, engine: str) -> float:
        return self.busy_cycles.get(engine, 0) / max(1, self.total_cycles)

    def seconds(self, freq_hz: float) -> float:
        return self.total_cycles / freq_hz


def run_times(instrs: list[Instr]) -> tuple[SimReport, dict]:
    """Time-wheel schedule; returns (report, iid -> (start, end) cycles)."""
    times: dict[int, tuple[int, int]] = {}
    done: dict[int, int] = {}
    engine_free = {e: 0 for e in ENGINES}
    busy = {e: 0 for e in ENGINES}
    for ins in instrs:  # program order == topological order of deps
        dep_ready = max((done[d] for d in ins.deps), default=0)
        start = max(engine_free[ins.engine], dep_ready)
        end = start + ins.cycles
        done[ins.iid] = end
        times[ins.iid] = (start, end)
        engine_free[ins.engine] = end
        busy[ins.engine] += ins.cycles
    total = max(done.values(), default=0)
    return SimReport(total_cycles=total, busy_cycles=busy,
                     n_instructions=len(instrs)), times


def run(instrs: list[Instr]) -> SimReport:
    return run_times(instrs)[0]


def engine_windows(instrs: list[Instr], times: dict) -> dict:
    """Per-engine occupancy timeline: engine -> [(start, end, opcode, tag)],
    in schedule order.  This is the Fig. 8/9 view — the runtime supporter
    renders it per request to show LOAD(i+1) overlapping CONV(i)."""
    out: dict[str, list] = {e: [] for e in ENGINES}
    for ins in instrs:
        s, e = times[ins.iid]
        out[ins.engine].append((s, e, ins.opcode, ins.tag))
    return out


def check(instrs: list[Instr]) -> SimReport:
    """Simulate and audit the memory plan; raises MemoryHazardError."""
    from repro_torch.obs.trace import TRACER

    with TRACER.span("simulate", cat="compile", track="compile",
                     n_instrs=len(instrs)) as sp:
        rep, times = run_times(instrs)
        hazards = memory_hazards(instrs, times)
        if hazards:
            raise MemoryHazardError(
                f"{len(hazards)} memory hazard(s):\n  "
                + "\n  ".join(hazards[:10]))
        sp.set(total_cycles=rep.total_cycles)
    return rep


# --------------------------------------------------------------- hazard audit
def memory_hazards(instrs: list[Instr], times: dict) -> list[str]:
    """Audit an addressed stream against its time-wheel schedule.

    Returns human-readable hazard descriptions (empty list == clean plan).
    Instructions without addresses/banks (timing-only streams) are ignored.
    """
    return _ddr_hazards(instrs, times) + _bank_hazards(instrs, times)


def _ranges_overlap(a0: int, a1: int, b0: int, b1: int) -> bool:
    return a0 < b1 and b0 < a1           # half-open [start, end)


def _windows_overlap(a: tuple[int, int], b: tuple[int, int]) -> bool:
    return _ranges_overlap(a[0], a[1], b[0], b[1])


def _ddr_hazards(instrs: list[Instr], times: dict) -> list[str]:
    # One DDR "region" per writing group: [addr, addr+len) with a live window
    # spanning first write start -> last read end.  Reads with no preceding
    # writer model pre-loaded buffers (graph inputs), written at time 0.
    writers: dict[tuple, list] = {}   # (gid, addr, len) -> [wstart, wend]
    for ins in instrs:
        if ins.opcode != "SAVE" or ins.ddr_addr < 0:
            continue
        key = (ins.group_id, ins.ddr_addr, ins.ddr_len)
        s, e = times[ins.iid]
        if key in writers:
            writers[key][0] = min(writers[key][0], s)
            writers[key][1] = max(writers[key][1], e)
        else:
            writers[key] = [s, e]
    regions = [{"gid": gid, "addr": a, "len": ln,
                "start": w[0], "wend": w[1], "end": w[1]}
               for (gid, a, ln), w in writers.items()]

    pre: dict[tuple, dict] = {}       # pre-loaded (read-only) regions
    for ins in instrs:
        if ins.opcode != "LOAD" or ins.ddr_addr < 0:
            continue
        rs, re_ = times[ins.iid]
        a0, a1 = ins.ddr_addr, ins.ddr_addr + ins.ddr_len
        # attribute the read to the latest region whose write fully retired
        # before the read begins — the only region a correct plan could be
        # reading (a later in-flight writer overlapping this read is exactly
        # the hazard the pairwise window check below reports)
        best = None
        for r in regions:
            if (_ranges_overlap(a0, a1, r["addr"], r["addr"] + r["len"])
                    and r["wend"] <= rs
                    and (best is None or r["start"] > best["start"])):
                best = r
        if best is not None:
            best["end"] = max(best["end"], re_)
        else:
            key = (ins.ddr_addr, ins.ddr_len)
            if key in pre:
                pre[key]["end"] = max(pre[key]["end"], re_)
            else:
                pre[key] = {"gid": -1, "addr": ins.ddr_addr, "len": ins.ddr_len,
                            "start": 0, "wend": 0, "end": re_}
    regions.extend(pre.values())

    out = []
    for i, r1 in enumerate(regions):
        for r2 in regions[i + 1:]:
            if r1["gid"] == r2["gid"] and r1["gid"] >= 0:
                continue
            if not _ranges_overlap(r1["addr"], r1["addr"] + r1["len"],
                                   r2["addr"], r2["addr"] + r2["len"]):
                continue
            if _windows_overlap((r1["start"], r1["end"]),
                                (r2["start"], r2["end"])):
                out.append(
                    f"DDR overlap: group {r1['gid']} "
                    f"[{r1['addr']}, +{r1['len']}) live cycles "
                    f"[{r1['start']}, {r1['end']}) vs group {r2['gid']} "
                    f"[{r2['addr']}, +{r2['len']}) live "
                    f"[{r2['start']}, {r2['end']})")
    return out


def tile_accesses(instrs: list[Instr]) -> dict:
    """Bucket an addressed stream per (group_id, tile) into its LOAD / SAVE /
    compute instructions — the unit both the bank-hazard audit and the
    runtime's cross-request schedule reason about."""
    tiles: dict[tuple, dict] = {}
    for ins in instrs:
        if ins.group_id < 0 or ins.tile < 0:
            continue
        t = tiles.setdefault((ins.group_id, ins.tile),
                             {"load": [], "save": [], "compute": []})
        if ins.opcode == "LOAD":
            t["load"].append(ins)
        elif ins.opcode == "SAVE":
            t["save"].append(ins)
        elif ins.engine in COMPUTE_ENGINES:
            t["compute"].append(ins)
    return tiles


def bank_hazards(instrs: list[Instr], times: dict) -> list[str]:
    """Ping/pong BRAM bank audit alone (the bank half of
    :func:`memory_hazards`).  Public so the runtime can re-run it over a
    *relabelled* pipelined stream — bank windows key on (group, bank), which
    a per-request group renumbering would otherwise hide."""
    return _bank_hazards(instrs, times)


def _bank_hazards(instrs: list[Instr], times: dict) -> list[str]:
    # Per (group, tile): the in-bank is occupied from its LOAD's start until
    # its last compute retires (SAVE if the tile has no compute); the out-bank
    # from its first compute's start until its SAVE retires.
    tiles = tile_accesses(instrs)

    in_windows: dict[tuple, list] = {}    # (gid, bank) -> [(s, e, tile)]
    out_windows: dict[tuple, list] = {}
    for (gid, tile), t in tiles.items():
        if not t["load"] and not t["save"]:
            continue
        consumers = t["compute"] or t["save"]
        if t["load"] and t["load"][0].bank >= 0:
            s = min(times[i.iid][0] for i in t["load"])
            e = max(times[i.iid][1] for i in consumers) if consumers else s
            in_windows.setdefault((gid, t["load"][0].bank), []).append(
                (s, e, tile))
        if t["save"] and t["save"][0].bank >= 0:
            producers = t["compute"] or t["load"]
            s = (min(times[i.iid][0] for i in producers) if producers
                 else times[t["save"][0].iid][0])
            e = max(times[i.iid][1] for i in t["save"])
            out_windows.setdefault((gid, t["save"][0].bank), []).append(
                (s, e, tile))

    out = []
    for kind, windows in (("in", in_windows), ("out", out_windows)):
        for (gid, bank), ws in windows.items():
            ws.sort()
            for (s1, e1, t1), (s2, e2, t2) in zip(ws, ws[1:]):
                if _windows_overlap((s1, e1), (s2, e2)):
                    out.append(
                        f"{kind}-bank hazard: group {gid} bank {bank} tiles "
                        f"{t1}/{t2} overlap cycles [{s1},{e1}) vs [{s2},{e2})")
    return out
