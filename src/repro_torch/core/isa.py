# Copied from src/repro/core/isa.py; imports point at repro_torch.
"""Custom ISA (paper §3.1): LOAD / SAVE / CONV / POOL / MISC coarse
instructions with dependency bits.

The assembler emits one instruction stream per execution group; instructions
are variable-grain (one CONV covers a whole tile's worth of MACs — the paper's
"coarse-grained nature of the ISA").  Dependencies are explicit instruction
ids, the hardware analogue of the dependency bits that let the Dispatcher
issue LOAD(t+1) while CONV(t) runs (double buffering).

With a :class:`repro.memory.MemoryPlan` the stream becomes *addressed*: every
LOAD/SAVE carries its DDR region and BRAM bank, and three extra families of
dependency bits appear —

* in-bank reuse:  LOAD(t) waits for the consumer of tile t-n_banks_in, since
  it overwrites that tile's ping/pong input bank;
* out-bank reuse: the first compute of tile t waits for SAVE(t-n_banks_out);
* DDR write-after-read: a group whose output buffer recycles the address
  range of an expired buffer waits for that buffer's last LOAD to retire.

Without a plan the streams are timing-only and byte-identical in schedule to
the pre-memory-planner assembler (addresses stay -1), so cost evaluation
inside the path search is unchanged.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.hw import DeviceModel
from repro_torch.core.tiling import GroupTiling
from repro_torch.core.xgraph import XGraph

# DDR_RD / DDR_WR: the AXI read and write channels are independent (the
# paper's Fig. 8/9 timelines show LOAD and SAVE overlapping), so LOAD and
# SAVE occupy separate bandwidth lanes; CONV / POOL / MISC mirror the
# accelerator's execution modules.
ENGINES = ("DDR_RD", "DDR_WR", "CONV", "POOL", "MISC")
COMPUTE_ENGINES = ("CONV", "POOL", "MISC")


@dataclasses.dataclass
class Instr:
    iid: int
    engine: str          # one of ENGINES
    opcode: str          # LOAD / SAVE / CONV / POOL / MISC / END
    cycles: int
    deps: tuple[int, ...] = ()
    tag: str = ""
    # memory-plan fields (memory/planner.py); -1 / 0 => unaddressed stream
    ddr_addr: int = -1   # DDR region this LOAD reads / SAVE writes
    ddr_len: int = 0
    bank: int = -1       # BRAM ping/pong bank (in-bank for LOAD, out for SAVE)
    group_id: int = -1   # execution-group index within the strategy
    tile: int = -1       # spatial tile index within the group


@dataclasses.dataclass(frozen=True)
class GroupMem:
    """Per-group slice of a MemoryPlan, as the emitter consumes it."""
    in_addr: int = -1
    in_len: int = 0
    out_addr: int = -1
    out_len: int = 0
    n_banks_in: int = 1
    n_banks_out: int = 1
    war_deps: tuple[int, ...] = ()   # last LOADs of recycled DDR buffers


def emit_group(g: XGraph, group: list[str], tiling: GroupTiling,
               dev: DeviceModel, base_id: int = 0,
               entry_deps: tuple[int, ...] = (),
               group_id: int = -1, mem: GroupMem | None = None) -> list[Instr]:
    """Assemble the tiled instruction stream for one fused group.

    One LOAD -> CONV -> POOL/MISC -> SAVE chain per spatial tile; oc passes
    are folded into per-tile durations (keeps streams compact for deep nets
    without changing the schedule the time wheel sees).  ``mem`` threads DDR
    addresses, bank ids and the bank/WAR dependency bits described in the
    module docstring.
    """
    instrs: list[Instr] = []
    nid = base_id
    n_t = max(1, tiling.n_spatial_tiles)
    bw_cyc = dev.dram_bw_bytes_per_s / dev.freq_hz  # DDR bytes per cycle

    def cyc_for_bytes(b: float) -> int:
        return max(1, math.ceil(b / bw_cyc))

    load_c = cyc_for_bytes((tiling.load_bytes + tiling.weight_bytes) / n_t)
    save_c = cyc_for_bytes(tiling.save_bytes / n_t)
    conv_c = max(0, math.ceil(tiling.conv_cycles / n_t))
    pool_c = max(0, math.ceil(tiling.pool_cycles / n_t))
    misc_c = max(0, math.ceil(tiling.misc_cycles / n_t))

    n_bi = mem.n_banks_in if mem else 1
    n_bo = mem.n_banks_out if mem else 1
    in_consumer: dict[int, int] = {}   # tile -> iid of last reader of its in-bank
    save_iid: dict[int, int] = {}      # tile -> iid of its SAVE

    for t in range(n_t):
        load_deps = list(entry_deps if t == 0 else ())
        if mem and t >= n_bi:
            # ping/pong: this LOAD overwrites the bank tile t-n_bi was read from
            load_deps.append(in_consumer[t - n_bi])
        li = Instr(nid, "DDR_RD", "LOAD", load_c, tuple(load_deps),
                   tag=f"{group[0]}@t{t}", group_id=group_id, tile=t)
        if mem:
            li.ddr_addr, li.ddr_len = mem.in_addr, mem.in_len
            li.bank = t % n_bi
        nid += 1
        last = li.iid
        instrs.append(li)
        first_compute = True
        for eng, cyc in (("CONV", conv_c), ("POOL", pool_c), ("MISC", misc_c)):
            if cyc:
                deps = [last]
                if first_compute and mem and t >= n_bo:
                    # out-bank reuse: don't overwrite tile t-n_bo before it is
                    # drained to DDR
                    deps.append(save_iid[t - n_bo])
                ins = Instr(nid, eng, eng, cyc, tuple(deps),
                            tag=f"{group[0]}@t{t}", group_id=group_id, tile=t)
                nid += 1
                last = ins.iid
                first_compute = False
                instrs.append(ins)
        save_deps = [last]
        if mem and t == 0 and mem.war_deps:
            save_deps.extend(mem.war_deps)   # DDR write-after-read
        if mem and first_compute and t >= n_bo:
            save_deps.append(save_iid[t - n_bo])  # compute-less pass-through
        si = Instr(nid, "DDR_WR", "SAVE", save_c, tuple(save_deps),
                   tag=f"{group[-1]}@t{t}", group_id=group_id, tile=t)
        if mem:
            si.ddr_addr, si.ddr_len = mem.out_addr, mem.out_len
            si.bank = t % n_bo
        nid += 1
        instrs.append(si)
        in_consumer[t] = last if not first_compute else si.iid
        save_iid[t] = si.iid
    return instrs


def emit_strategy(g: XGraph, groups: list[list[str]],
                  tilings: list[GroupTiling], dev: DeviceModel,
                  plan=None) -> list[Instr]:
    """Assemble the whole execution strategy with *dataflow* dependency bits:
    a group's first LOAD waits on the SAVEs of exactly the groups producing
    its external inputs.  Independent groups (e.g. Inception branches) then
    overlap across the CONV/POOL/MISC engines — the latency hiding of
    §4.1.3 ("different operations can be concurrently executed by different
    computation modules").

    ``plan`` (a :class:`repro.memory.MemoryPlan` over the same group order)
    threads DDR addresses, bank assignments and write-after-read bits into
    the stream; the result is checkable by ``simulator.memory_hazards``."""
    out: list[Instr] = []
    nid = 0
    save_of: dict[str, int] = {}       # producer node -> SAVE instr id
    last_load_of: dict[str, int] = {}  # DDR buffer name -> last LOAD iid
    for gi, (group, tiling) in enumerate(zip(groups, tilings)):
        gset = set(group)
        ext = [i for nm in group for i in g.nodes[nm].inputs if i not in gset]
        deps = tuple(sorted({save_of[i] for i in ext if i in save_of}))
        mem = None
        if plan is not None:
            # LOADs carry one DDR region, so multi-input groups (eltwise
            # residuals) advertise only their primary input to the hazard
            # oracle; reads of the remaining inputs are still protected,
            # because the WAR bookkeeping below records the group's last
            # LOAD against *every* external input buffer.
            primary = next((i for i in ext if i in plan.buf_of_node), None)
            in_addr, in_len = (plan.node_region(primary) if primary is not None
                               else (-1, 0))
            out_addr, out_len = plan.group_out_region(gi)
            bp = plan.banks[gi]
            war = tuple(sorted(last_load_of[b] for b in plan.war[gi]
                               if b in last_load_of))
            mem = GroupMem(in_addr=in_addr, in_len=in_len,
                           out_addr=out_addr, out_len=out_len,
                           n_banks_in=bp.n_banks_in, n_banks_out=bp.n_banks_out,
                           war_deps=war)
        instrs = emit_group(g, group, tiling, dev, base_id=nid,
                            entry_deps=deps, group_id=gi, mem=mem)
        nid += len(instrs)
        out.extend(instrs)
        if plan is not None:
            last_load = max((i.iid for i in instrs if i.opcode == "LOAD"),
                            default=None)
            if last_load is not None:
                for i in ext:
                    buf = plan.buf_of_node.get(i)
                    if buf is not None:
                        last_load_of[buf] = last_load
        saves = [i for i in instrs if i.opcode == "SAVE"]
        if saves:
            for nm in g.exposed_outputs(group):
                save_of[nm] = saves[-1].iid
    return out
