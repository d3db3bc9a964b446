# Copied from src/repro/explain/report.py; imports point at repro_torch.
"""The CompileReport: one structured record of every compile decision.

Assembled by :func:`build_report` at the point where graph, strategy, memory
plan, and lowered program are all simultaneously in hand (``asm.
assemble_artifact``), embedded into the artifact meta, and read back by
:func:`report_of` — which also reconstructs a *degraded* report for pre-v5
artifacts so ``explain`` never crashes on an old object file.

The report is plain JSON-native data (dicts / lists / scalars, no NaN/Inf):
it must survive the artifact's strict ``json.dumps`` round trip and the
``/explain/<model>`` HTTP route unchanged.  Schema stability is a contract
(``validate_report`` + tests/test_explain.py); grow it by adding keys, not by
renaming them, and bump :data:`REPORT_VERSION` when you do.
"""
from __future__ import annotations

from collections import Counter

REPORT_VERSION = 1

# (key, type(s)) pairs every report must carry — the stable schema surface.
_TOP_SCHEMA = {
    "report_version": int,
    "model": str,
    "device": str,
    "evaluator": (str, type(None)),
    "profile_hash": (str, type(None)),
    "profile_name": (str, type(None)),
    "degraded": bool,
    "fusion": dict,
    "tiles": dict,
    "memory": dict,
    "schedule": dict,
}
_FUSION_SCHEMA = {
    "n_groups": int,
    "n_horizontal": int,
    "coverage": (float, int, type(None)),
    "groups": list,
    "fallbacks": list,
    "search": (dict, type(None)),
}
_TILES_SCHEMA = {
    "source": (str, type(None)),
    "n_units": int,
    "n_tuned": int,
    "leaderboard": list,
}
_MEMORY_SCHEMA = {
    "peak_bytes": int,
    "no_reuse_bytes": int,
    "reuse_factor": (float, int),
    "pin_input": bool,
    "regions": list,
    "n_regions": int,
    "banks": list,
}
_SCHEDULE_SCHEMA = {
    "sim_total_cycles": int,
    "n_instrs": int,
    "engines": dict,
}

# DDR allocation map entries embedded per report (a 224px GoogLeNet plan has
# ~100 buffers; deeper synthetic graphs get the head of the map + a count).
MAX_REGIONS = 128


def _group_key(nodes) -> str:
    from repro_torch.core.lower import tile_key
    return tile_key(list(nodes))


def build_report(g, strategy, dev, planres, program, *,
                 profile_hash: str | None = None,
                 profile_name: str | None = None) -> dict:
    """Assemble the CompileReport for one finished compilation."""
    trace = strategy.meta.get("search_trace")
    group_costs = (trace or {}).get("group_costs", {})
    tile_shapes = dict(strategy.meta.get("tile_shapes") or {})
    hset = {tuple(h) for h in strategy.horizontal}

    groups = []
    for grp in planres.items:
        key = _group_key(grp)
        costs = group_costs.get(key, {})
        groups.append({
            "key": key,
            "nodes": list(grp),
            "ops": [g.nodes[n].op for n in grp if n in g.nodes],
            "kind": "horizontal" if tuple(grp) in hset else "chain",
            "cost_s": costs.get("cost_s"),
            "analytic_cost_s": costs.get("analytic_cost_s"),
            "tile": tile_shapes.get(key),
        })

    fallbacks = []
    coverage = None
    if program is not None:
        coverage = program.meta.get("coverage")
        for fb in program.fallbacks():
            fallbacks.append({"nodes": list(fb.nodes), "reason": fb.reason,
                              "detail": fb.detail})

    provenance = (_bounded_provenance(strategy.meta.get("tile_provenance"))
                  or [])
    tiles = {
        "source": strategy.meta.get("tile_source"),
        "n_units": len(planres.items),
        "n_tuned": len(tile_shapes),
        "leaderboard": provenance,
    }

    plan = planres.plan
    regions = sorted(
        ({"buffer": name,
          "offset": int(pl.offset),
          "bytes": int(pl.interval.nbytes),
          "reserved_bytes": int(pl.size),
          "reuses": list(plan.ddr.reuses.get(name, []))}
         for name, pl in plan.ddr.placements.items()),
        key=lambda r: (r["offset"], r["buffer"]))
    banks = [{"key": _group_key(grp), "n_in": b.n_banks_in,
              "n_out": b.n_banks_out}
             for grp, b in zip(planres.items, plan.banks)]
    memory = {
        "peak_bytes": int(plan.peak_bytes),
        "no_reuse_bytes": int(plan.no_reuse_bytes),
        "reuse_factor": float(plan.reuse_factor),
        "pin_input": bool(planres.pin_input),
        "regions": regions[:MAX_REGIONS],
        "n_regions": len(regions),
        "banks": banks,
    }

    schedule = {
        "sim_total_cycles": int(planres.sim_total_cycles),
        "n_instrs": len(planres.instrs),
        "engines": dict(Counter(ins.engine for ins in planres.instrs)),
    }

    return {
        "report_version": REPORT_VERSION,
        "model": g.name,
        "device": dev.name,
        "evaluator": strategy.meta.get("evaluator") or (trace or {}).get(
            "evaluator"),
        "profile_hash": profile_hash,
        "profile_name": profile_name,
        "total_cost_s": getattr(strategy, "cost", None),
        "degraded": False,
        "fusion": {
            "n_groups": len(strategy.groups),
            "n_horizontal": len(strategy.horizontal),
            "coverage": coverage,
            "groups": groups,
            "fallbacks": fallbacks,
            "search": trace,
        },
        "tiles": tiles,
        "memory": memory,
        "schedule": schedule,
    }


def _bounded_provenance(prov):
    from repro_torch.asm.artifact import bounded_tile_provenance
    return bounded_tile_provenance(prov)


def report_of(art) -> dict:
    """An artifact's CompileReport.

    v5 artifacts carry it verbatim; older artifacts (or plans compiled with
    reporting stripped) get a *degraded* reconstruction from what the object
    file alone can say — fusion structure, tile shapes, memory summary, and
    instruction schedule, but no search trace, no runner-up costs, and no DDR
    region map (the placements are not serialized pre-v5)."""
    rep = art.meta.get("compile_report")
    if rep:
        return rep

    tile_shapes = dict(art.meta.get("tile_shapes") or {})
    hset = {tuple(h) for h in art.horizontal}
    groups = [{
        "key": _group_key(grp),
        "nodes": list(grp),
        "ops": [],
        "kind": "horizontal" if tuple(grp) in hset else "chain",
        "cost_s": None,
        "analytic_cost_s": None,
        "tile": tile_shapes.get(_group_key(grp)),
    } for grp in art.exec_items]
    fallbacks = []
    coverage = None
    if art.program is not None:
        coverage = art.program.meta.get("coverage")
        fallbacks = [{"nodes": list(fb.nodes), "reason": fb.reason,
                      "detail": fb.detail} for fb in art.program.fallbacks()]
    ms = dict(art.mem_summary)
    banks = [{"key": _group_key(grp), "n_in": b.get("n_in", 1),
              "n_out": b.get("n_out", 1)}
             for grp, b in zip(art.exec_items, ms.get("banks") or [])]
    return {
        "report_version": REPORT_VERSION,
        "model": art.meta.get("graph_name") or "artifact",
        "device": art.device,
        "evaluator": art.meta.get("evaluator"),
        "profile_hash": art.meta.get("profile_hash"),
        "profile_name": art.meta.get("profile_name"),
        "total_cost_s": None,
        "degraded": True,
        "fusion": {
            "n_groups": len(art.groups),
            "n_horizontal": len(art.horizontal),
            "coverage": coverage,
            "groups": groups,
            "fallbacks": fallbacks,
            "search": art.meta.get("search_trace"),
        },
        "tiles": {
            "source": art.meta.get("tile_source"),
            "n_units": len(art.exec_items),
            "n_tuned": len(tile_shapes),
            "leaderboard": list(art.meta.get("tile_provenance") or []),
        },
        "memory": {
            "peak_bytes": int(ms.get("peak_bytes", 0)),
            "no_reuse_bytes": int(ms.get("no_reuse_bytes", 0)),
            "reuse_factor": float(ms.get("reuse_factor", 1.0)),
            "pin_input": bool(ms.get("pin_input", False)),
            "regions": [],
            "n_regions": 0,
            "banks": banks,
        },
        "schedule": {
            "sim_total_cycles": int(art.sim_total_cycles),
            "n_instrs": len(art.instrs),
            "engines": dict(Counter(ins.engine for ins in art.instrs)),
        },
    }


def validate_report(rep: dict) -> dict:
    """Assert the stable schema surface; returns ``rep`` for chaining.

    Raises ``ValueError`` naming the first offending key — used by the tests
    and the explain-smoke gate so accidental schema drift fails loudly."""
    def check(d, schema, where):
        if not isinstance(d, dict):
            raise ValueError(f"{where}: expected dict, got {type(d).__name__}")
        for key, types in schema.items():
            if key not in d:
                raise ValueError(f"{where}.{key}: missing")
            if not isinstance(d[key], types):
                raise ValueError(
                    f"{where}.{key}: expected {types}, got "
                    f"{type(d[key]).__name__}")

    check(rep, _TOP_SCHEMA, "report")
    if rep["report_version"] != REPORT_VERSION:
        raise ValueError(f"report.report_version: {rep['report_version']} != "
                         f"{REPORT_VERSION}")
    check(rep["fusion"], _FUSION_SCHEMA, "report.fusion")
    check(rep["tiles"], _TILES_SCHEMA, "report.tiles")
    check(rep["memory"], _MEMORY_SCHEMA, "report.memory")
    check(rep["schedule"], _SCHEDULE_SCHEMA, "report.schedule")
    for i, grp in enumerate(rep["fusion"]["groups"]):
        for key in ("key", "nodes", "kind"):
            if key not in grp:
                raise ValueError(f"report.fusion.groups[{i}].{key}: missing")
    for i, reg in enumerate(rep["memory"]["regions"]):
        for key in ("buffer", "offset", "bytes", "reuses"):
            if key not in reg:
                raise ValueError(f"report.memory.regions[{i}].{key}: missing")
    return rep
