"""repro_torch.memory (liveness, first-fit DDR placement, ping/pong banks,
the planner) and the addressed assembler/simulator seam, as
tests/test_memory_plan.py holds the reference; and the port's plan against
the reference's for the same graphs and tilings."""
import pytest

from repro.core import pathsearch as ref_pathsearch
from repro.core import tiling as ref_tiling
from repro.core.cost import AnalyticEvaluator as RefAnalyticEvaluator
from repro.hw import ZU2 as REF_ZU2
from repro.memory import plan_memory as ref_plan_memory
from repro_torch.core import partition, pathsearch, simulator
from repro_torch.core import tiling as tiling_mod
from repro_torch.core.cost import AnalyticEvaluator
from repro_torch.core.isa import Instr, emit_strategy
from repro_torch.core.tiling import GroupTiling
from repro_torch.hw import ZU2
from repro_torch.memory import (MemoryPlanError, activation_intervals,
                                first_fit, plan_banks, plan_memory)
from repro_torch.memory.liveness import Interval
from torch_common import build_graph, make_toy_graph


def _tilings(g, items, hset, dev, solve_horizontal, evaluator):
    ana = evaluator(g, dev)
    return [solve_horizontal(g, grp, dev) if tuple(grp) in hset
            else ana.cost(grp).tiling for grp in items]


def _planned(g, dev=ZU2):
    s = pathsearch.search(g, dev)
    items = pathsearch.order_groups(g, [list(x) for x in s.groups] +
                                    [list(h) for h in s.horizontal])
    tilings = _tilings(g, items, {tuple(h) for h in s.horizontal}, dev,
                       tiling_mod.solve_horizontal, AnalyticEvaluator)
    plan = plan_memory(g, items, tilings, dev)
    instrs = emit_strategy(g, items, tilings, dev, plan=plan)
    return s, items, tilings, plan, instrs


@pytest.fixture(scope="module")
def toy():
    return make_toy_graph("repro_torch")


# ----------------------------------------------------------------- liveness
def test_liveness_intervals_cover_schedule(toy):
    _, items, _, plan, _ = _planned(toy)
    ivs = plan.intervals
    by_gid = {iv.writer_gid: iv for iv in ivs}
    assert len(ivs) == len(items) + 1          # one per group + the input
    assert by_gid[-1].name == "in:data" and by_gid[-1].start == -1
    assert all(iv.end >= iv.start and iv.nbytes > 0 for iv in ivs)
    assert by_gid[-1].end < len(items)         # not live forever


def test_liveness_host_consumed_buffer_lives_to_end(toy):
    dv = partition.device_of(toy, "paper")     # fc1 on the host
    assert dv("fc1") == "cpu" and dv("c1") == "acc"
    s = pathsearch.search(toy, ZU2, device_of=dv)
    items = pathsearch.order_groups(toy, [list(x) for x in s.groups] +
                                    [list(h) for h in s.horizontal])
    (p1_iv,) = [iv for iv in activation_intervals(toy, items)
                if "p1" in iv.parts]
    assert p1_iv.end == len(items)


# ------------------------------------------------------------------ ddr_alloc
def test_first_fit_disjoint_when_live_and_reuses_when_dead():
    ivs = [Interval("a", 100, 0, 2, 0),
           Interval("b", 100, 1, 3, 1),    # overlaps a -> disjoint addresses
           Interval("c", 100, 4, 5, 2)]    # a, b dead -> reuses offset 0
    plan = first_fit(ivs, align=64)
    a, b, c = (plan.placements[k] for k in "abc")
    assert a.offset + a.size <= b.offset or b.offset + b.size <= a.offset
    assert c.offset == 0
    assert "c" in plan.reuses and "a" in plan.reuses["c"]
    assert plan.peak_bytes < plan.no_reuse_bytes
    assert plan.reuse_factor > 1.0


def test_first_fit_alignment():
    plan = first_fit([Interval("a", 10, 0, 1, 0), Interval("b", 10, 0, 1, 1)],
                     align=64)
    for p in plan.placements.values():
        assert p.offset % 64 == 0 and p.size % 64 == 0


# ---------------------------------------------------------------------- banks
def test_bank_plan_ping_pong_and_fallback():
    small = GroupTiling(True, n_spatial_tiles=4,
                        in_tile_bytes=ZU2.buf_in_bytes // 4,
                        out_tile_bytes=ZU2.buf_out_bytes // 4)
    bp = plan_banks(small, ZU2)
    assert bp.feasible and bp.n_banks_in == 2 and bp.n_banks_out == 2
    assert bp.in_bank_bytes == ZU2.buf_in_bytes // 2
    big = GroupTiling(True, n_spatial_tiles=4,
                      in_tile_bytes=int(ZU2.buf_in_bytes * 0.8),
                      out_tile_bytes=int(ZU2.buf_out_bytes * 0.8))
    bp = plan_banks(big, ZU2)
    assert bp.feasible and bp.n_banks_in == 1 and bp.n_banks_out == 1


def test_bank_plan_rejects_oversized_tile():
    t = GroupTiling(True, n_spatial_tiles=1, in_tile_bytes=ZU2.buf_in_bytes + 1)
    bp = plan_banks(t, ZU2)
    assert not bp.feasible and "exceeds B_in" in bp.reason
    t = GroupTiling(True, n_spatial_tiles=1, out_tile_bytes=1,
                    resident_bytes=ZU2.buf_out_bytes)
    assert not plan_banks(t, ZU2).feasible


def test_plan_memory_raises_on_infeasible_bank(toy):
    _, items, tilings, _, _ = _planned(toy)
    bad = list(tilings)
    bad[0] = GroupTiling(True, n_spatial_tiles=1,
                         in_tile_bytes=ZU2.buf_in_bytes + 1)
    with pytest.raises(MemoryPlanError):
        plan_memory(toy, items, bad, ZU2)


# --------------------------------------------------- assembler/simulator seam
def test_every_load_save_addressed_and_banked(toy):
    *_, instrs = _planned(toy)
    for i in instrs:
        if i.opcode in ("LOAD", "SAVE"):
            assert i.bank >= 0 and i.group_id >= 0 and i.tile >= 0
        if i.opcode == "SAVE":
            assert i.ddr_addr >= 0 and i.ddr_len > 0


def test_planned_stream_passes_hazard_check(toy):
    *_, instrs = _planned(toy)
    rep = simulator.check(instrs)              # raises on any hazard
    assert rep.n_instructions == len(instrs)
    assert rep.total_cycles >= max(rep.busy_cycles.values())


def test_hazard_checker_catches_overlapping_ddr_writes():
    instrs = [
        Instr(0, "DDR_WR", "SAVE", 100, (), ddr_addr=0, ddr_len=512,
              group_id=0, tile=0),
        Instr(1, "DDR_RD", "LOAD", 200, (0,), ddr_addr=0, ddr_len=512,
              group_id=1, tile=0),
        Instr(2, "DDR_WR", "SAVE", 100, (), ddr_addr=256, ddr_len=512,
              group_id=2, tile=0),
    ]
    with pytest.raises(simulator.MemoryHazardError):
        simulator.check(instrs)


# ------------------------------------------------------- against the reference
@pytest.mark.parametrize("model,img", [("toy", 16), ("googlenet", 32),
                                       ("resnet50", 32)])
@pytest.mark.parametrize("pin_input", [False, True])
def test_plan_summary_matches_reference(model, img, pin_input):
    """Same graph, same items and tilings: the port's ``MemoryPlan`` has
    the reference's summary, intervals, placements and bank plans."""
    g = build_graph("repro_torch", model, img)
    g_ref = build_graph("repro", model, img)
    s = pathsearch.search(g, ZU2)
    s_ref = ref_pathsearch.search(g_ref, REF_ZU2)
    items = pathsearch.order_groups(g, [list(x) for x in s.groups] +
                                    [list(h) for h in s.horizontal])
    items_ref = ref_pathsearch.order_groups(
        g_ref, [list(x) for x in s_ref.groups] +
        [list(h) for h in s_ref.horizontal])
    assert items == items_ref
    hset = {tuple(h) for h in s.horizontal}
    plan = plan_memory(g, items, _tilings(
        g, items, hset, ZU2, tiling_mod.solve_horizontal, AnalyticEvaluator),
        ZU2, pin_input=pin_input)
    ref = ref_plan_memory(g_ref, items_ref, _tilings(
        g_ref, items_ref, hset, REF_ZU2, ref_tiling.solve_horizontal,
        RefAnalyticEvaluator), REF_ZU2, pin_input=pin_input)
    assert plan.summary() == ref.summary()
    assert [tuple(vars(iv).values()) for iv in plan.intervals] == \
        [tuple(vars(iv).values()) for iv in ref.intervals]
    assert {k: (p.offset, p.size) for k, p in plan.ddr.placements.items()} \
        == {k: (p.offset, p.size) for k, p in ref.ddr.placements.items()}
    assert [vars(b) for b in plan.banks] == [vars(b) for b in ref.banks]
