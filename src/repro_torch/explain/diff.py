# Copied from src/repro/explain/diff.py; imports point at repro_torch.
"""Structural + cost diff of two compiled plans.

``diff(a, b)`` answers the hot-swap loop's audit question — *what changed
between the plan we were serving and the plan we just re-tuned?* — in
machine-readable form: fusion groups present on only one side, shared units
whose tile shape changed (with each side's own predicted seconds and the
predicted delta), and the memory / schedule / cost scalar deltas.

Contract (enforced by tests/test_explain.py):

- ``diff(a, a)`` is *empty*: ``identical`` is True and every changed-list is
  ``[]``, every scalar delta 0;
- antisymmetry: ``diff(a, b) == negate(diff(b, a))`` — the diff carries no
  information that depends on argument order beyond the a/b labelling.

Every computed diff is also emitted as a ``plan.diff`` event so the re-tune
loop leaves an audit trail in the event log.
"""
from __future__ import annotations

from repro_torch.explain.report import report_of


def diff(a, b) -> dict:
    """Diff two artifacts or two reports (duck-typed: anything with ``.meta``
    is treated as an artifact and run through :func:`report_of`)."""
    ra = report_of(a) if hasattr(a, "meta") else a
    rb = report_of(b) if hasattr(b, "meta") else b
    return diff_reports(ra, rb)


def diff_artifacts(a, b) -> dict:
    return diff(a, b)


def _scalar(va, vb) -> dict:
    va = 0 if va is None else va
    vb = 0 if vb is None else vb
    return {"a": va, "b": vb, "delta": vb - va}


def _chosen_shape(grp: dict) -> tuple | None:
    t = grp.get("tile")
    return tuple(int(v) for v in t) if t else None


def _predicted_unit_seconds(rep: dict, key: str, shape: tuple | None):
    """This side's own predicted seconds for unit ``key`` at ``shape``: the
    matching tile-leaderboard candidate's measured (preferred) or predicted
    seconds; falls back to the search trace's group cost when the unit never
    entered the tile search."""
    for unit in rep["tiles"]["leaderboard"]:
        ukey = unit.get("key") or "|".join(unit.get("nodes", []))
        if ukey != key:
            continue
        default = tuple(int(v) for v in unit.get("default") or ()) or None
        want = shape if shape is not None else default
        for cand in unit.get("candidates", []):
            cshape = tuple(int(v) for v in cand.get("shape") or ()) or None
            if cshape == want or (want is None and cand.get("default")):
                for k in ("measured", "predicted"):
                    if cand.get(k) is not None:
                        return float(cand[k])
    for grp in rep["fusion"]["groups"]:
        if grp["key"] == key:
            return grp.get("cost_s")
    return None


def diff_reports(ra: dict, rb: dict) -> dict:
    keys_a = {grp["key"]: grp for grp in ra["fusion"]["groups"]}
    keys_b = {grp["key"]: grp for grp in rb["fusion"]["groups"]}
    only_a = sorted(set(keys_a) - set(keys_b))
    only_b = sorted(set(keys_b) - set(keys_a))

    changed = []
    for key in sorted(set(keys_a) & set(keys_b)):
        sa = _chosen_shape(keys_a[key])
        sb = _chosen_shape(keys_b[key])
        if sa == sb:
            continue
        pa = _predicted_unit_seconds(ra, key, sa)
        pb = _predicted_unit_seconds(rb, key, sb)
        changed.append({
            "key": key,
            "a": list(sa) if sa else None,
            "b": list(sb) if sb else None,
            "predicted_a_s": pa,
            "predicted_b_s": pb,
            "predicted_delta_s": (pb - pa
                                  if pa is not None and pb is not None
                                  else None),
        })

    out = {
        "models": {"a": ra["model"], "b": rb["model"]},
        "fusion": {
            "only_a": only_a,
            "only_b": only_b,
            "n_groups": _scalar(ra["fusion"]["n_groups"],
                                rb["fusion"]["n_groups"]),
            "n_horizontal": _scalar(ra["fusion"]["n_horizontal"],
                                    rb["fusion"]["n_horizontal"]),
        },
        "tiles": {"changed": changed, "n_changed": len(changed)},
        "memory": {
            "peak_bytes": _scalar(ra["memory"]["peak_bytes"],
                                  rb["memory"]["peak_bytes"]),
            "reuse_factor": _scalar(ra["memory"]["reuse_factor"],
                                    rb["memory"]["reuse_factor"]),
        },
        "schedule": {
            "sim_total_cycles": _scalar(ra["schedule"]["sim_total_cycles"],
                                        rb["schedule"]["sim_total_cycles"]),
            "n_instrs": _scalar(ra["schedule"]["n_instrs"],
                                rb["schedule"]["n_instrs"]),
        },
        "cost": {
            "total_cost_s": _scalar(ra.get("total_cost_s"),
                                    rb.get("total_cost_s")),
        },
    }
    out["identical"] = (not only_a and not only_b and not changed
                        and all(s["delta"] == 0 for s in (
                            out["memory"]["peak_bytes"],
                            out["schedule"]["sim_total_cycles"],
                            out["schedule"]["n_instrs"],
                            out["cost"]["total_cost_s"])))
    _emit(out)
    return out


def _emit(d: dict) -> None:
    from repro_torch.obs.events import EVENTS
    EVENTS.emit(
        "plan.diff",
        message=(f"plan diff {d['models']['a']} vs {d['models']['b']}: "
                 f"{'identical' if d['identical'] else 'changed'} "
                 f"({d['tiles']['n_changed']} tiles, "
                 f"{len(d['fusion']['only_a']) + len(d['fusion']['only_b'])}"
                 f" fusion groups)"),
        severity="info",
        identical=d["identical"],
        n_tiles_changed=d["tiles"]["n_changed"],
        n_fusion_changed=(len(d["fusion"]["only_a"])
                          + len(d["fusion"]["only_b"])),
        cost_delta_s=d["cost"]["total_cost_s"]["delta"],
    )


def negate(d: dict) -> dict:
    """Mirror a diff: swap the a/b roles and negate every delta, such that
    ``negate(diff(b, a)) == diff(a, b)``."""
    def neg_scalar(s):
        return {"a": s["b"], "b": s["a"], "delta": -s["delta"]
                if s["delta"] != 0 else 0}

    changed = [{
        "key": c["key"],
        "a": c["b"], "b": c["a"],
        "predicted_a_s": c["predicted_b_s"],
        "predicted_b_s": c["predicted_a_s"],
        "predicted_delta_s": (-c["predicted_delta_s"]
                              if c["predicted_delta_s"] else
                              c["predicted_delta_s"]),
    } for c in d["tiles"]["changed"]]
    return {
        "models": {"a": d["models"]["b"], "b": d["models"]["a"]},
        "fusion": {
            "only_a": list(d["fusion"]["only_b"]),
            "only_b": list(d["fusion"]["only_a"]),
            "n_groups": neg_scalar(d["fusion"]["n_groups"]),
            "n_horizontal": neg_scalar(d["fusion"]["n_horizontal"]),
        },
        "tiles": {"changed": changed, "n_changed": len(changed)},
        "memory": {k: neg_scalar(v) for k, v in d["memory"].items()},
        "schedule": {k: neg_scalar(v) for k, v in d["schedule"].items()},
        "cost": {k: neg_scalar(v) for k, v in d["cost"].items()},
        "identical": d["identical"],
    }
