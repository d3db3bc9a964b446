# Copied from src/repro/runtime/schedule.py; imports point at repro_torch.
"""Engine-level schedule view: cross-request software pipelining (Fig. 8/9).

The paper's 1.26x comes from pipelining coarse-grained instructions across
engines: while CONV(t) runs, the Dispatcher already issues LOAD(t+1) into the
other ping/pong bank.  A serving runtime extends the same idea across
*requests*: request i+1's LOADs stream in while request i computes, and the
steady-state throughput is bound by the busiest engine, not by the
single-request latency.

:func:`pipeline_stream` builds that schedule from a compiled artifact's
addressed instruction stream — it replicates the stream once per request and
threads exactly the dependency bits the hardware would need:

* **ping/pong continuation** — request r's first LOADs into group g's input
  banks wait for request r-1's last consumer of the same bank (the in-bank
  wrap-around of ``isa.emit_group``, continued across the request boundary);
* **out-bank continuation** — request r's first computes of group g wait for
  request r-1's last SAVE draining the same output bank;
* **DDR ping/pong** — activation buffers are double-buffered across requests
  (request r uses DDR slot ``r % ddr_slots``), so write-after-read conflicts
  only arise at distance ``ddr_slots``: request r's first SAVE of group g
  waits for request r-ddr_slots's last LOAD/SAVE touching the same region,
  and request r's reads of pre-loaded (input) regions wait for any recycled
  write of request r-ddr_slots to retire.

The result is *checkable*: the stream carries real addresses and banks, so
``simulator.check`` audits it with the same memory-hazard oracle that audits
single-request plans — :func:`pipeline_report` hard-errors on any hazard.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import simulator
from repro_torch.core.isa import COMPUTE_ENGINES, ENGINES, Instr


def _overlaps(a0: int, al: int, b0: int, bl: int) -> bool:
    return a0 < b0 + bl and b0 < a0 + al


def _base_bookkeeping(instrs: list[Instr], banks: list[dict]) -> dict:
    """Per-group resource hand-off points of one request's stream."""
    tiles = simulator.tile_accesses(instrs)

    in_cont: dict[tuple, int] = {}      # (gid, in_bank)  -> consumer iid
    out_cont: dict[tuple, int] = {}     # (gid, out_bank) -> last SAVE iid
    first_receiver: dict[tuple, int] = {}  # (gid, tile) -> iid taking out-bank dep
    for (gid, tile), t in sorted(tiles.items()):
        consumer = (t["compute"][-1] if t["compute"]
                    else t["save"][-1] if t["save"] else None)
        if t["load"] and t["load"][0].bank >= 0 and consumer is not None:
            in_cont[(gid, t["load"][0].bank)] = consumer.iid  # last tile wins
        if t["save"] and t["save"][0].bank >= 0:
            out_cont[(gid, t["save"][0].bank)] = t["save"][-1].iid
        recv = t["compute"][0] if t["compute"] else \
            (t["save"][0] if t["save"] else None)
        if recv is not None:
            first_receiver[(gid, tile)] = recv.iid

    # DDR regions: per-group output region + conflict targets (EVERY LOAD /
    # SAVE of the stream overlapping that region — address reuse means these
    # may belong to *any* group, including pre-loaded inputs).  All of them,
    # not just the last: the merged pipelined program may legally reorder
    # instructions of different requests, so no single target is guaranteed
    # to retire last.
    out_region: dict[int, tuple[int, int]] = {}
    for ins in instrs:
        if ins.opcode == "SAVE" and ins.ddr_addr >= 0:
            out_region.setdefault(ins.group_id, (ins.ddr_addr, ins.ddr_len))
    conflicts: dict[int, list[int]] = {}
    for gid, (a, ln) in out_region.items():
        conflicts[gid] = [i.iid for i in instrs
                          if i.opcode in ("LOAD", "SAVE") and i.ddr_addr >= 0
                          and _overlaps(i.ddr_addr, i.ddr_len, a, ln)]

    # pre-loaded reads: a LOAD whose region no earlier instruction of the
    # same request wrote reads data staged by the host (the graph input).
    # Address recycling means a *later* group of an earlier same-parity
    # request may write over it, so each such LOAD waits for every
    # overlapping SAVE of request r - ddr_slots to retire.
    pre_guard: dict[int, list[int]] = {}
    saves = [i for i in instrs if i.opcode == "SAVE" and i.ddr_addr >= 0]
    for ins in instrs:
        if ins.opcode != "LOAD" or ins.ddr_addr < 0:
            continue
        earlier = [s for s in saves if s.iid < ins.iid
                   and _overlaps(s.ddr_addr, s.ddr_len,
                                 ins.ddr_addr, ins.ddr_len)]
        if earlier:
            continue                       # produced in-request; entry deps +
                                           # SAVE-side conflict bits cover it
        guards = [s.iid for s in saves
                  if _overlaps(s.ddr_addr, s.ddr_len,
                               ins.ddr_addr, ins.ddr_len)]
        if guards:
            pre_guard[ins.iid] = guards

    n_bi = {g: b.get("n_in", 1) for g, b in enumerate(banks)}
    n_bo = {g: b.get("n_out", 1) for g, b in enumerate(banks)}
    return {"in_cont": in_cont, "out_cont": out_cont,
            "first_receiver": first_receiver,
            "conflicts": conflicts, "pre_guard": pre_guard,
            "n_bi": n_bi, "n_bo": n_bo}


def _interleave(instrs: list[Instr], n_base: int) -> list[Instr]:
    """Software-pipeline the merged program: list-schedule the request-major
    stream into the order a cross-request dispatcher would issue.

    Engines retire instructions in *program* order (``simulator.run_times``),
    so a request-major concatenation lets request r's very first LOAD queue
    behind request r-1's LAST load — zero overlap.  The runtime owns the
    merged program, so it list-schedules instead: each request's *own*
    instruction order is preserved (the per-request stream order carries
    implicit semantics — entry deps sit only on a group's first tile, later
    tiles ride the engine's in-order retirement), and among the R request
    heads whose dependencies are all emitted, the dispatcher issues the one
    that can *start* earliest on the time wheel (ties: earliest stream
    position).  Time-awareness matters: emitting a dependency-clear but
    far-future instruction early would head-of-line-block its whole engine
    for every later-emitted request.  Dependencies are preserved exactly;
    only issue order changes.
    """
    n = len(instrs)
    n_req = n // n_base
    emitted = [False] * n                  # global position == iid
    done = [0] * n                         # retire time of emitted instrs
    engine_free: dict[str, int] = {e: 0 for e in ENGINES}
    pos = [r * n_base for r in range(n_req)]
    out: list[Instr] = []
    while len(out) < n:
        best = None
        for r in range(n_req):
            if pos[r] >= (r + 1) * n_base:
                continue
            ins = instrs[pos[r]]
            if any(not emitted[d] for d in ins.deps):
                continue
            start = max(engine_free[ins.engine],
                        max((done[d] for d in ins.deps), default=0))
            key = (start, pos[r] - r * n_base, r)
            if best is None or key < best[0]:
                best = (key, r, ins, start)
        assert best is not None, "pipeline stream deadlocked (dep cycle?)"
        _, r, ins, start = best
        emitted[ins.iid] = True
        done[ins.iid] = start + ins.cycles
        engine_free[ins.engine] = start + ins.cycles
        pos[r] += 1
        out.append(ins)
    return out


def pipeline_stream(art, n_requests: int, ddr_slots: int = 2,
                    interleave: bool = True, _bk_out: dict | None = None
                    ) -> list[Instr]:
    """Replicate ``art.instrs`` per request with cross-request dependency bits
    and per-request DDR slot offsets, then software-pipeline the merged
    program order.  ``simulator.check``-clean by design.

    ``_bk_out``: caller-provided dict filled with the per-request resource
    bookkeeping (``pipeline_report`` reads the pre-load guard count from it
    without recomputing the pass)."""
    if n_requests < 1:
        raise ValueError("n_requests must be >= 1")
    if ddr_slots < 1:
        raise ValueError("ddr_slots must be >= 1")
    base = art.instrs
    n_base = len(base)
    n_groups = len(art.exec_items)
    banks = art.mem_summary.get("banks", [])
    bk = _base_bookkeeping(base, banks)
    if _bk_out is not None:
        _bk_out.update(bk)

    from repro_torch.hw import get_device
    align = get_device(art.device).ddr_align if art.device else 64
    top = max((i.ddr_addr + i.ddr_len for i in base if i.ddr_addr >= 0),
              default=0)
    slot_stride = -(-top // max(1, align)) * max(1, align)

    out: list[Instr] = []
    for r in range(n_requests):
        off = r * n_base
        poff = (r - 1) * n_base
        qoff = (r - ddr_slots) * n_base
        for ins in base:
            deps = [d + off for d in ins.deps]
            g, t = ins.group_id, ins.tile
            if r >= 1 and g >= 0 and t >= 0:
                if (ins.opcode == "LOAD" and ins.bank >= 0
                        and t < bk["n_bi"].get(g, 1)):
                    cont = bk["in_cont"].get((g, ins.bank))
                    if cont is not None:
                        deps.append(cont + poff)
                if (bk["first_receiver"].get((g, t)) == ins.iid
                        and t < bk["n_bo"].get(g, 1)):
                    cont = bk["out_cont"].get(
                        (g, t % max(1, bk["n_bo"].get(g, 1))))
                    if cont is not None:
                        deps.append(cont + poff)
            if r >= ddr_slots:
                if ins.opcode == "SAVE" and g >= 0:
                    deps.extend(d + qoff for d in bk["conflicts"].get(g, ()))
                deps.extend(d + qoff for d in bk["pre_guard"].get(ins.iid, ()))
            addr = ins.ddr_addr
            if addr >= 0:
                addr += (r % ddr_slots) * slot_stride
            out.append(Instr(
                ins.iid + off, ins.engine, ins.opcode, ins.cycles,
                tuple(sorted(set(deps))), tag=f"r{r}:{ins.tag}",
                ddr_addr=addr, ddr_len=ins.ddr_len, bank=ins.bank,
                group_id=(g + r * n_groups if g >= 0 else -1), tile=t))
    return _interleave(out, n_base) if interleave else out


# ------------------------------------------------------- ddr_slots selection
def choose_ddr_slots(art, profile=None, *, max_slots: int = 4,
                     default: int = 2) -> int:
    """Pick the DDR double-buffer slot depth from the stream's DRAM/compute
    ratio instead of the fixed default.

    Request r's SAVEs must wait for request r-ddr_slots's conflicting
    LOAD/SAVEs to retire, so when a request spends more time on the DDR
    channels than on its busiest compute engine the distance-2 guard becomes
    the pipeline's critical path — each extra slot pushes the write-after-
    read horizon one request further at the cost of one more activation
    footprint in DDR.  Compute-bound streams keep the classic ping/pong
    ``default``.

    ``profile`` (a calibrated ``tune.DeviceProfile``) rescales the DDR busy
    cycles by measured-vs-modeled bandwidth: the instruction cycles were
    emitted under the hand-written device model, but the slot decision should
    reflect the bandwidth this machine actually delivers.
    """
    import math

    from repro_torch.core.isa import COMPUTE_ENGINES
    from repro_torch.hw import get_device

    rep = simulator.run(art.instrs)
    busy = rep.busy_cycles
    ddr = busy.get("DDR_RD", 0) + busy.get("DDR_WR", 0)
    comp = max((busy.get(e, 0) for e in COMPUTE_ENGINES), default=0)
    if profile is not None and art.device:
        eff = getattr(profile, "dram_rd_bytes_per_s", 0.0)
        if eff and math.isfinite(eff):
            ddr *= get_device(art.device).dram_bw_bytes_per_s / eff
    if comp <= 0 or ddr <= comp:
        return default
    return int(min(max_slots, max(default, math.ceil(ddr / comp) + 1)))


# ------------------------------------------------------------------- report
@dataclasses.dataclass
class PipelineReport:
    """Modeled steady-state serving behaviour of a pipelined request stream."""
    n_requests: int
    total_cycles: int
    single_request_cycles: int     # time-wheel latency of one request alone
    busy_cycles: dict              # engine -> busy cycles over the whole run
    request_windows: list          # per request (first start, last end) cycles
    ddr_slots: int
    n_instructions: int
    # True when the artifact's memory plan pinned the network input's DDR
    # region out of the reuse pool: no recycled write ever lands on a
    # pre-loaded region, so the distance-ddr_slots pre-load guard vanishes
    # from the stream and request r+1's first LOADs issue earlier.
    pin_input: bool = False
    # pre-load guard dependencies per pipelined request (0 when the plan pins
    # the input region): each is an edge from request r's pre-loaded LOAD to
    # a recycled SAVE of request r-ddr_slots
    n_preload_guards: int = 0
    # how ddr_slots was decided: "explicit" (caller-passed), "auto" (stream
    # DRAM/compute ratio under the hand-written device model), or "profile"
    # (ratio rescaled by the calibrated profile's measured bandwidth)
    ddr_slots_source: str = "explicit"
    engine_timeline: dict = dataclasses.field(default_factory=dict)
    # engine -> [(start, end, opcode, "r<i>:<node>@t<k>")] in schedule order
    # (simulator.engine_windows over the pipelined stream — the Fig. 8/9
    # gantt; LOAD rows of request i+1 sit inside CONV rows of request i)

    @property
    def sequential_cycles(self) -> int:
        return self.n_requests * self.single_request_cycles

    @property
    def modeled_speedup(self) -> float:
        """Pipelined vs strictly sequential back-to-back execution."""
        return self.sequential_cycles / max(1, self.total_cycles)

    @property
    def overlap(self) -> float:
        """Fraction of sequential time hidden by cross-request pipelining."""
        return 1.0 - self.total_cycles / max(1, self.sequential_cycles)

    def utilization(self, engine: str | None = None):
        if engine is not None:
            return self.busy_cycles.get(engine, 0) / max(1, self.total_cycles)
        return {e: self.utilization(e) for e in self.busy_cycles}

    @property
    def bottleneck(self) -> str:
        return max(self.busy_cycles, key=lambda e: self.busy_cycles[e])

    def throughput_images_per_s(self, freq_hz: float) -> float:
        return self.n_requests * freq_hz / max(1, self.total_cycles)

    def request_latency_cycles(self) -> list:
        return [e - s for s, e in self.request_windows]


def pipeline_report(art, n_requests: int, ddr_slots: int | None = 2,
                    profile=None) -> PipelineReport:
    """Schedule ``n_requests`` pipelined copies of the artifact's stream on
    the time wheel, audit the memory plan (raises
    :class:`~repro_torch.core.simulator.MemoryHazardError` on any hazard), and
    report per-engine utilization + modeled cross-request overlap.

    ``ddr_slots=None`` picks the slot depth from the stream's DRAM/compute
    ratio (:func:`choose_ddr_slots`), rescaled by ``profile`` when given —
    the report records which path decided it (``ddr_slots_source``)."""
    source = "explicit"
    if ddr_slots is None:
        ddr_slots = choose_ddr_slots(art, profile)
        source = "profile" if profile is not None else "auto"
    bk: dict = {}
    stream = pipeline_stream(art, n_requests, ddr_slots=ddr_slots, _bk_out=bk)
    rep, times = simulator.run_times(stream)
    hazards = simulator.memory_hazards(stream, times)
    # The bank audit keys windows by (group, bank), and the stream renumbers
    # groups per request (DDR regions need that), which would hide
    # cross-request collisions on the same physical bank.  Re-run it with the
    # base group ids restored (tiles offset per request to stay distinct).
    n_base = len(art.instrs)
    n_groups = max(1, len(art.exec_items))
    tile_stride = 1 + max((i.tile for i in art.instrs), default=0)
    relabelled = [dataclasses.replace(
        i, group_id=i.group_id % n_groups,
        tile=i.tile + (i.iid // n_base) * tile_stride)
        for i in stream if i.group_id >= 0 and i.tile >= 0]
    hazards += simulator.bank_hazards(relabelled, times)
    if hazards:
        raise simulator.MemoryHazardError(
            f"pipelined stream has {len(hazards)} hazard(s):\n  "
            + "\n  ".join(hazards[:10]))
    spans: dict[int, list] = {}
    for ins in stream:   # interleaved issue order: bucket by request id
        spans.setdefault(ins.iid // n_base, []).append(times[ins.iid])
    windows = [(min(s for s, _ in spans[r]), max(e for _, e in spans[r]))
               for r in range(n_requests)]
    single = art.sim_total_cycles or simulator.run(art.instrs).total_cycles
    return PipelineReport(
        n_requests=n_requests, total_cycles=rep.total_cycles,
        single_request_cycles=single, busy_cycles=dict(rep.busy_cycles),
        request_windows=windows, ddr_slots=ddr_slots,
        n_instructions=rep.n_instructions,
        pin_input=bool(art.mem_summary.get("pin_input")),
        n_preload_guards=sum(len(v) for v in bk["pre_guard"].values()),
        ddr_slots_source=source,
        engine_timeline=simulator.engine_windows(stream, times))
