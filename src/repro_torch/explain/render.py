# Copied from src/repro/explain/render.py; imports point at repro_torch.
"""Deterministic text rendering of CompileReports and plan diffs.

Formatting is fixed-precision and sorted everywhere (no dict-order or
locale dependence): the golden-output test in tests/test_explain.py diffs
this renderer's output byte-for-byte against a committed expectation, so
cosmetic changes here are schema changes — update the golden with intent.
"""
from __future__ import annotations


def _us(x) -> str:
    """Seconds -> fixed-precision microseconds ('-' for unknown)."""
    return "-" if x is None else f"{float(x) * 1e6:.2f}us"


def _kb(n) -> str:
    return f"{int(n) / 1024.0:.1f}KiB"


def _shape(t) -> str:
    return "default" if not t else "x".join(str(int(v)) for v in t)


def _pct(x) -> str:
    return "-" if x is None else f"{float(x) * 100.0:.0f}%"


def render_report(rep: dict, *, drift: list | None = None,
                  max_rows: int = 64) -> str:
    """Render one CompileReport as an aligned text document.

    ``drift`` (optional) is the live measured-vs-predicted join produced by
    ``Session.explain()`` — rendered as an extra section when present."""
    L: list[str] = []
    prof = rep.get("profile_name") or rep.get("profile_hash") or "analytic"
    L.append(f"== compile report: {rep['model']} on {rep['device']} "
             f"[{rep.get('evaluator') or 'unknown'} / {prof}]"
             f"{' (degraded: pre-v5 artifact)' if rep.get('degraded') else ''}"
             " ==")
    if rep.get("total_cost_s") is not None:
        L.append(f"predicted e2e cost: {_us(rep['total_cost_s'])}")

    fu = rep["fusion"]
    L.append("")
    L.append(f"-- fusion: {fu['n_groups']} chain + {fu['n_horizontal']} "
             f"horizontal groups, coverage {_pct(fu.get('coverage'))}, "
             f"{len(fu['fallbacks'])} fallbacks")
    for grp in fu["groups"][:max_rows]:
        tag = "horiz" if grp["kind"] == "horizontal" else "chain"
        cost = _us(grp.get("cost_s"))
        ana = grp.get("analytic_cost_s")
        vs = ("" if ana is None or grp.get("cost_s") is None
              or ana == grp.get("cost_s")
              else f" (analytic {_us(ana)})")
        L.append(f"  [{tag}] {grp['key']}  cost {cost}{vs}  "
                 f"tile {_shape(grp.get('tile'))}")
    if len(fu["groups"]) > max_rows:
        L.append(f"  ... {len(fu['groups']) - max_rows} more groups")
    for fb in fu["fallbacks"][:max_rows]:
        L.append(f"  [fallback] {'|'.join(fb['nodes'])}  "
                 f"reason={fb['reason']}")

    search = fu.get("search")
    if search:
        L.append("")
        rejected: dict[str, int] = {}
        for ch in search.get("chains", []):
            for why, n in (ch.get("n_rejected") or {}).items():
                rejected[why] = rejected.get(why, 0) + n
        rej = (", ".join(f"{k}={v}" for k, v in sorted(rejected.items()))
               or "none")
        L.append(f"-- search: {search.get('n_chains', 0)} chains, "
                 f"{search.get('n_fusable_pairs', 0)} fusable pairs, "
                 f"rejected: {rej}")
        tmpl = ", ".join(f"{k}={v}" for k, v in
                         sorted((search.get("templates") or {}).items()))
        if tmpl:
            L.append(f"  templates: {tmpl}")
        rows = 0
        for ch in search.get("chains", []):
            for alt in ch.get("alternatives", []):
                if rows >= max_rows:
                    break
                L.append(f"  [not chosen] {'|'.join(alt['nodes'])}  "
                         f"cost {_us(alt.get('cost_s'))}")
                rows += 1
        for ch in search.get("chains", []):
            for ex in ch.get("rejected_examples", [])[:2]:
                if rows >= max_rows:
                    break
                L.append(f"  [rejected] {'|'.join(ex['nodes'])}  "
                         f"reason={ex['reason']}")
                rows += 1
        for ew in search.get("eltwise_absorb", []):
            word = (f"absorbed into {ew['into']}" if ew.get("absorbed")
                    else "kept standalone")
            L.append(f"  [eltwise] {ew['eltwise']}: {word} "
                     f"(delta {_us(ew.get('delta_s'))})")
        for hz in search.get("horizontal", []):
            word = "fused" if hz.get("fused") else "split"
            detail = (f" ({_us(hz.get('with_tails_cost_s'))} vs split "
                      f"{_us(hz.get('split_cost_s'))})"
                      if hz.get("split_cost_s") is not None else
                      f" ({hz.get('reason', '')})")
            L.append(f"  [horizontal] {'+'.join(hz['heads'])}: "
                     f"{word}{detail}")

    ti = rep["tiles"]
    L.append("")
    L.append(f"-- tiles: source={ti.get('source') or 'default'}, "
             f"{ti['n_tuned']}/{ti['n_units']} units tuned")
    for unit in ti["leaderboard"][:max_rows]:
        key = unit.get("key") or "|".join(unit.get("nodes", []))
        chosen = unit.get("chosen")
        L.append(f"  {key}  chosen={_shape(chosen)} "
                 f"(default {_shape(unit.get('default'))})")
        for cand in unit.get("candidates", []):
            mark = "*" if (cand.get("shape") == chosen
                           or (chosen is None and cand.get("default"))) \
                else " "
            meas = _us(cand.get("measured"))
            pred = _us(cand.get("predicted"))
            L.append(f"   {mark} {_shape(cand.get('shape'))}"
                     f"{' [default]' if cand.get('default') else ''}  "
                     f"measured {meas}  predicted {pred}")

    me = rep["memory"]
    L.append("")
    L.append(f"-- memory: peak {_kb(me['peak_bytes'])} "
             f"(no-reuse {_kb(me['no_reuse_bytes'])}, "
             f"reuse x{float(me['reuse_factor']):.2f}"
             f"{', pinned input' if me.get('pin_input') else ''})")
    for reg in me["regions"][:max_rows]:
        reuse = (f"  reuses {','.join(reg['reuses'])}" if reg.get("reuses")
                 else "")
        L.append(f"  0x{int(reg['offset']):08x}  {_kb(reg['bytes']):>10}  "
                 f"{reg['buffer']}{reuse}")
    if me["n_regions"] > max_rows:
        L.append(f"  ... {me['n_regions'] - max_rows} more regions")
    elif not me["regions"]:
        L.append("  (DDR map not serialized in this artifact version)")
    pp = sum(1 for b in me["banks"] if b.get("n_in", 1) == 2)
    L.append(f"  banks: {pp}/{len(me['banks'])} groups ping/pong "
             f"double-buffered")

    sc = rep["schedule"]
    L.append("")
    engines = ", ".join(f"{k}={v}" for k, v in sorted(sc["engines"].items()))
    L.append(f"-- schedule: {sc['n_instrs']} instrs "
             f"({engines}), {sc['sim_total_cycles']} simulated cycles")

    if drift is not None:
        L.append("")
        L.append(f"-- live drift: {len(drift)} units sampled")
        for u in drift[:max_rows]:
            L.append(f"  {u['key']}  predicted {_us(u.get('predicted'))}  "
                     f"measured {_us(u.get('measured'))}  "
                     f"deviation {_pct(u.get('deviation'))} "
                     f"(n={u.get('n_samples', 0)})")
    return "\n".join(L) + "\n"


def render_diff(d: dict, *, max_rows: int = 64) -> str:
    L: list[str] = []
    L.append(f"== plan diff: {d['models']['a']} (a) vs "
             f"{d['models']['b']} (b) ==")
    if d["identical"]:
        L.append("plans are identical")
        return "\n".join(L) + "\n"

    fu = d["fusion"]
    if fu["only_a"] or fu["only_b"]:
        L.append("")
        L.append(f"-- fusion changed: {len(fu['only_a'])} groups only in a, "
                 f"{len(fu['only_b'])} only in b")
        for key in fu["only_a"][:max_rows]:
            L.append(f"  - {key}")
        for key in fu["only_b"][:max_rows]:
            L.append(f"  + {key}")

    ti = d["tiles"]
    if ti["changed"]:
        L.append("")
        L.append(f"-- tiles changed: {ti['n_changed']} units")
        for c in ti["changed"][:max_rows]:
            delta = c.get("predicted_delta_s")
            word = ("" if delta is None else
                    f"  predicted {_us(c.get('predicted_a_s'))} -> "
                    f"{_us(c.get('predicted_b_s'))} "
                    f"({'+' if delta >= 0 else ''}{delta * 1e6:.2f}us)")
            L.append(f"  {c['key']}  {_shape(c.get('a'))} -> "
                     f"{_shape(c.get('b'))}{word}")

    L.append("")
    me, sc, co = d["memory"], d["schedule"], d["cost"]
    L.append(f"-- memory: peak {_kb(me['peak_bytes']['a'])} -> "
             f"{_kb(me['peak_bytes']['b'])}")
    L.append(f"-- schedule: {sc['sim_total_cycles']['a']} -> "
             f"{sc['sim_total_cycles']['b']} simulated cycles, "
             f"{sc['n_instrs']['a']} -> {sc['n_instrs']['b']} instrs")
    total = co["total_cost_s"]
    if total["a"] or total["b"]:
        L.append(f"-- predicted e2e: {_us(total['a'])} -> "
                 f"{_us(total['b'])}")
    return "\n".join(L) + "\n"
