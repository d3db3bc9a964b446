"""Tile-shape search: make the chain kernel's (T_h, T_w, T_oc) a searched
compilation decision on the card.

Port of ``src/repro/tune/tiles.py``.  For every lowered chain launch it
enumerates the tile shapes that are feasible under a device model's Eq. 6
capacity (:func:`tiling.enumerate_tilings`, the Pareto frontier over
traffic / grid cells / footprint, plus the paper's Eq. 5/6 shape), keeps
the ones the card can launch (``ops.card_tile``: T_oc divides OC and a
block's buffers fit its shared memory), ranks them with a fitted
:class:`~repro_torch.tune.profile.DeviceProfile`, measures the top-K
beside the card's own choice (``choose_chain_tile``, the default) through
the :class:`~repro_torch.tune.measure.MeasurementHarness`, and records the
winner in ``strategy.meta['tile_shapes']``.  A candidate the card cannot
launch appears in the unit's provenance with its reason.

Horizontal launches have no tile on the card: ``horizontal_mma_kernel`` is
an implicit GEMM whose plan depends only on M, N and K
(``ops.horizontal_plan``).  The search records them with ``chosen: None``
and ``source: "card_plan"``; calibration still measures them.

From there the shape is an artifact citizen: ``core.lower`` stamps it onto
the launch (``FusedLaunch.tile``), ``run_launch`` runs the kernel at it, the
memory planner charges its footprints, and the compiled artifact
round-trips it.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import lower, tiling
from repro_torch.core.xgraph import XGraph
from repro_torch.hw import DeviceModel
from repro_torch.kernels.conv_fused import ops as fused_ops
from repro_torch.tune.evaluator import (_chain_vec, _horizontal_vec,
                                        chain_geometry_of, chain_tile,
                                        predict_seconds)
from repro_torch.tune.profile import DeviceProfile

# A tuned shape must beat the card's default by more than noise to be
# recorded: measured winners need 1%, profile-predicted winners 2% (a
# prediction is softer evidence than an A/B on the same round-robin passes).
MEASURED_MARGIN = 0.01
PREDICTED_MARGIN = 0.02


def launch_oc(g: XGraph, item: lower.FusedLaunch) -> int:
    """Output channels the launch's OC grid axis tiles."""
    if item.kind == "horizontal":
        return sum(oc for _, oc, _, _ in item.members)
    return chain_geometry_of(g, item)[2]


def default_shape(g: XGraph, item: lower.FusedLaunch) -> tuple | None:
    """The (t_h, t_w, t_oc) the card runs without a tile record: its
    ``choose_chain_tile``; None for a horizontal launch (no tile)."""
    if item.kind == "horizontal":
        return None
    return chain_tile(g, dataclasses.replace(item, tile=()))


def analytic_shape(g: XGraph, dev: DeviceModel,
                   item: lower.FusedLaunch) -> tuple | None:
    """The paper's Eq. 5/6 shape for this launch's node cover (T_h/T_oc
    pinned to the array parallelism, maximal T_w)."""
    t = tiling.solve(g, list(item.nodes), dev)
    return (t.t_h, t.t_w, t.t_oc) if t.feasible else None


def card_filter(g: XGraph, item: lower.FusedLaunch, shapes) -> tuple:
    """(shapes the card can launch, as it runs them; the others, each with
    its reason).  Shapes that clamp to one tile are kept once."""
    oh, ow, oc, c_in, oc_list = chain_geometry_of(g, item)
    kept, dropped, seen = [], [], set()
    for s in shapes:
        tile, why = fused_ops.card_tile(item.stages, oh, ow, oc, c_in,
                                        oc_list, s)
        if why:
            dropped.append({"shape": [int(v) for v in s], "reason": why})
        elif tile not in seen:
            seen.add(tile)
            kept.append(tile)
    return kept, dropped


def _candidates(g: XGraph, dev: DeviceModel, item: lower.FusedLaunch,
                max_candidates: int) -> tuple:
    """(card-launchable candidates, dropped ones with reasons)."""
    cands = tiling.enumerate_tilings(g, list(item.nodes), dev,
                                     max_candidates=max_candidates)
    return card_filter(g, item, [(t.t_h, t.t_w, t.t_oc) for t in cands])


def shape_candidates(g: XGraph, dev: DeviceModel, item: lower.FusedLaunch,
                     max_candidates: int = 16) -> list:
    """Card-launchable (t_h, t_w, t_oc) candidates for one chain launch,
    every one feasible under ``dev``'s Eq. 6 capacity; [] for a horizontal
    launch."""
    if item.kind == "horizontal":
        return []
    return _candidates(g, dev, item, max_candidates)[0]


def predict_shape_seconds(profile: DeviceProfile, g: XGraph,
                          item: lower.FusedLaunch, shape: tuple) -> float:
    """Price one tile candidate with the fitted profile: the launch's
    kernel-domain work vector under that shape (blocks, per-block windows
    and recomputed stages, weight panels all move with the tile)."""
    it = dataclasses.replace(item, tile=tuple(int(v) for v in shape))
    f = _horizontal_vec(g, it) if it.kind == "horizontal" else _chain_vec(g, it)
    oh, ow = item.out_hw
    th, tw, _ = shape
    n_fill = max(1, math.ceil(oh / max(1, th)) * math.ceil(ow / max(1, tw)))
    return predict_seconds(profile, f, n_fill)


def predict_best_shape(profile: DeviceProfile, g: XGraph, dev: DeviceModel,
                       item: lower.FusedLaunch,
                       margin: float = PREDICTED_MARGIN) -> tuple | None:
    """Profile-predicted best shape for one chain launch, or ``None`` when
    the card's chooser wins (within ``margin``) or the launch is
    horizontal."""
    cands = shape_candidates(g, dev, item)
    if not cands:
        return None
    base = predict_shape_seconds(profile, g, item, default_shape(g, item))
    best, best_s = None, base
    for s in cands:
        sec = predict_shape_seconds(profile, g, item, s)
        if sec < best_s:
            best, best_s = s, sec
    if best is None or best_s > base * (1.0 - margin):
        return None
    return tuple(int(v) for v in best)


# ------------------------------------------------------------------- search
@dataclasses.dataclass
class TileSearchReport:
    """What the tile search decided, per lowered unit."""
    tile_shapes: dict               # tile_key -> [t_h, t_w, t_oc] (winners)
    provenance: list                # per-unit candidates + timings
    n_units: int                    # launches considered
    n_tuned: int                    # launches with a non-default winner
    source: str                     # "measured" | "profile"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def search_tile_shapes(g: XGraph, qm, dev: DeviceModel, strategy, *,
                       profile: DeviceProfile | None = None, harness=None,
                       top_k: int = 3, passes: int | None = None,
                       max_candidates: int = 16,
                       min_measurable_s: float | None = None
                       ) -> TileSearchReport:
    """Search per-launch tile shapes for ``strategy`` and record them in
    ``strategy.meta['tile_shapes']`` (+ ``tile_provenance`` / ``tile_source``).

    ``dev`` is the capacity model candidates are enumerated under (``H100``
    for the card's own).  With a ``harness`` the top-K profile-ranked
    candidates of every chain launch (plus the card's default, always) are
    measured together in round-robin passes and the measured winner is
    kept; without one the profile-predicted best is kept.  Only shapes that
    beat the default by the evidence-appropriate margin are recorded — and
    only for units whose default time is at least ``min_measurable_s``
    (None: the harness's resolution, ``measure.MIN_MEASURABLE_S``).  An
    empty record runs the card's chooser, so untuned programs are unchanged.
    """
    if profile is None and harness is None:
        raise ValueError("search_tile_shapes needs a profile, a harness, "
                         "or both")
    if min_measurable_s is None:
        min_measurable_s = getattr(harness, "min_measurable_s", 5e-4)
    from repro_torch.obs.trace import TRACER
    with TRACER.span("tile_search", cat="compile", track="compile"):
        return _search_tile_shapes(
            g, qm, dev, strategy, profile=profile, harness=harness,
            top_k=top_k, passes=passes, max_candidates=max_candidates,
            min_measurable_s=min_measurable_s)


def _unit_record(item, default, chosen, source, candidates, dropped) -> dict:
    return {"key": lower.tile_key(item.nodes), "nodes": list(item.nodes),
            "kind": item.kind,
            "default": list(default) if default is not None else None,
            "chosen": list(chosen) if chosen is not None else None,
            "source": source, "candidates": candidates, "dropped": dropped}


def _search_tile_shapes(g: XGraph, qm, dev: DeviceModel, strategy, *,
                        profile, harness, top_k: int, passes: int | None,
                        max_candidates: int,
                        min_measurable_s: float) -> TileSearchReport:
    prog = lower.lower_strategy(g, strategy, qm)
    units, provenance = [], []
    for item in prog.launches():
        if item.kind == "horizontal":
            m, k = (max(1, g.shape(item.in_name)[0]) * item.out_hw[0]
                    * item.out_hw[1],
                    item.kernel[0] * item.kernel[1] * g.shape(item.in_name)[3])
            rec = _unit_record(item, None, None, "card_plan", [], [])
            rec["card_plan"] = fused_ops.horizontal_plan(
                m, launch_oc(g, item), k)
            provenance.append(rec)
            continue
        item = dataclasses.replace(item, tile=())      # the card's default
        default = default_shape(g, item)
        ana = analytic_shape(g, dev, item)
        cands, dropped = _candidates(g, dev, item, max_candidates)
        cands = [s for s in cands if s != default]
        if profile is not None:
            pred = {s: predict_shape_seconds(profile, g, item, s)
                    for s in cands}
            cands.sort(key=lambda s: pred[s])
            pred[default] = predict_shape_seconds(profile, g, item, default)
        else:
            # no profile: fewest blocks first — measurement arbitrates
            pred = {}
            cands.sort(key=lambda s: (math.ceil(item.out_hw[0] / s[0])
                                      * math.ceil(item.out_hw[1] / s[1])
                                      * (launch_oc(g, item) // s[2])))
        top = cands[:top_k]
        # the Eq. 5/6 shape is always in the measured set when the card can
        # run it: the result is never measured-worse than the analytic one
        if ana is not None:
            ana_kept, ana_dropped = card_filter(g, item, [ana])
            dropped += ana_dropped
            for s in ana_kept:
                if s != default and s not in top:
                    top.append(s)
                    if profile is not None:
                        pred.setdefault(s, predict_shape_seconds(
                            profile, g, item, s))
        units.append((item, default, top, pred, dropped))

    chosen: dict = {}
    source = "measured" if harness is not None else "profile"
    if harness is not None:
        items, index = [], []
        for u, (item, default, top, _, _) in enumerate(units):
            items.append(item)                     # tile=() == the default
            index.append((u, None))
            for s in top:
                items.append(dataclasses.replace(item, tile=s))
                index.append((u, s))
        measured = harness.measure_item_set(items, passes=passes)
        by_unit: dict = {}
        for (u, s), m in zip(index, measured):
            by_unit.setdefault(u, []).append((s, m))
        for u, (item, default, top, pred, dropped) in enumerate(units):
            rows = by_unit[u]
            base = rows[0][1]
            win_s, win_m = min(rows, key=lambda r: r[1].seconds)
            keep = (win_s is not None
                    and base.seconds >= min_measurable_s
                    and win_m.seconds < base.seconds * (1 - MEASURED_MARGIN))
            if keep:
                chosen[lower.tile_key(item.nodes)] = [int(v) for v in win_s]
            provenance.append(_unit_record(
                item, default, win_s if keep else None, "measured",
                [{"shape": list(s if s is not None else default),
                  "default": s is None,
                  "predicted": pred.get(s if s is not None else default),
                  "measured": m.seconds, "spread": m.spread}
                 for s, m in rows], dropped))
    else:
        for item, default, top, pred, dropped in units:
            base = pred[default]
            win = min(top, key=lambda s: pred[s], default=None)
            keep = win is not None and pred[win] < base * (1 - PREDICTED_MARGIN)
            if keep:
                chosen[lower.tile_key(item.nodes)] = [int(v) for v in win]
            provenance.append(_unit_record(
                item, default, win if keep else None, "profile",
                [{"shape": list(s), "default": s == default,
                  "predicted": pred[s], "measured": None}
                 for s in [default] + top], dropped))

    report = TileSearchReport(
        tile_shapes=chosen, provenance=provenance,
        n_units=len(prog.launches()), n_tuned=len(chosen), source=source)
    strategy.meta["tile_shapes"] = dict(chosen)
    strategy.meta["tile_source"] = source
    strategy.meta["tile_provenance"] = provenance
    return report


def tune_lowered(lowered, *, profile=None, harness=None, cache=None,
                 **search_kw):
    """Re-run the tile-shape search over an existing ``stages.Lowered`` and
    return a new ``Lowered`` carrying the tuned shapes.

    The staged pipeline's partial-recompile path: pathsearch is NOT re-run —
    the searched group partition is kept, only the per-launch tile shapes
    move, enumerated under the lowering's planning device (every candidate
    also launchable on the card).  The input stage is never mutated (its
    strategy is copied before the search writes ``meta['tile_shapes']``),
    so the untuned and tuned lowerings coexist in the stage cache under
    their own content hashes.
    """
    import copy

    from repro_torch.tune.profile import resolve_profile

    resolved = resolve_profile(profile) if profile is not None \
        else lowered.profile
    w = lowered.wrapped
    strat = copy.copy(lowered.strategy)
    strat.meta = dict(lowered.strategy.meta)
    search_tile_shapes(w.graph, w.qm, w.device, strat,
                       profile=resolved, harness=harness, **search_kw)
    ph = resolved.hash() if resolved is not None else lowered.profile_hash
    return w.lower(strategy=strat, profile=resolved, profile_hash=ph,
                   cache=cache)
