"""Calibration: fit the cost model's coefficients to measured time.

Port of ``src/repro/tune/calibrate.py``; the NNLS fit is the reference's,
line for line.  The analytic pipeline model prices a group as
``max(stage times) + fill`` with stage rates taken from the hand-written
``DeviceModel``.  On the card those rates are wrong by construction — they
describe a ZU-series FPGA, not an H100.  Calibration closes the loop:

1. measure a candidate fused-op set through the
   :class:`~repro_torch.tune.measure.MeasurementHarness` (or any injected
   ``measure_fn`` — the tests fit against simulator-generated ground truth);
2. extract each group's work-unit feature vector
   (:func:`repro_torch.tune.evaluator.group_features`);
3. least-squares fit the per-unit rates.  Both combination forms are fitted —
   the pipeline ``max + fill`` form (stage-dominance is re-assigned and the
   then-linear system re-solved until the assignment fixes) and the
   sequential ``sum`` form (a block runs a fused chain's stages
   back-to-back, not overlapped) — and the better-fitting form wins;
4. report the deviation band next to the paper's learned-model band (5-10%),
   and refit :class:`~repro_torch.core.cost.ModelEvaluator` against the same
   measurements.

Coefficients are constrained nonnegative (an active-set NNLS: a negative rate
is always a collinearity artifact, never physics); features with no support in
the sample set are left at zero and recorded as unfitted.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core import lower
from repro_torch.core.cost import AnalyticEvaluator, ModelEvaluator
from repro_torch.core.xgraph import XGraph
from repro_torch.hw import DeviceModel
from repro_torch.tune.evaluator import (_STAGE_IDX, CalibratedEvaluator,
                                  _horizontal_vec, group_features,
                                  predict_seconds)
from repro_torch.tune.measure import Measurement, MeasurementHarness
from repro_torch.tune.profile import (COEF_NAMES, DeviceProfile, _gpu_name,
                                      _toolchain_version)

PAPER_MODEL_BAND = (0.05, 0.10)     # Table 2's learned-model deviation band
ACCEPT_BAND = 0.15                  # our acceptance ceiling (median abs dev)


# ----------------------------------------------------------------- NNLS fit
def _nnls(X: np.ndarray, y: np.ndarray, max_iter: int | None = None
          ) -> np.ndarray:
    """Nonnegative least squares (Lawson-Hanson active set): greedily admit
    the variable with the largest positive gradient, back off along the line
    segment when a candidate solution leaves the feasible orthant."""
    n = X.shape[1]
    max_iter = max_iter or 3 * n
    x = np.zeros(n)
    passive = np.zeros(n, dtype=bool)
    scale = np.linalg.norm(X, axis=0)
    usable = scale > 0
    tol = 1e-12 * max(1.0, float(scale.max(initial=0.0)))
    for _ in range(max_iter):
        w = X.T @ (y - X @ x)
        w[~usable | passive] = -np.inf
        if not (w > tol).any():
            break
        passive[int(np.argmax(w))] = True
        while True:
            s = np.zeros(n)
            sol, *_ = np.linalg.lstsq(X[:, passive], y, rcond=None)
            s[passive] = sol
            if (s[passive] >= 0).all():
                break
            bad = passive & (s <= 0)
            ratio = x[bad] / np.maximum(x[bad] - s[bad], 1e-30)
            alpha = float(ratio.min(initial=1.0))
            x = x + alpha * (s - x)
            passive &= x > 1e-30
        x = s
    return np.maximum(x, 0.0)


def _max_design(F: np.ndarray, n_fill: np.ndarray,
                assign: np.ndarray) -> np.ndarray:
    """Linearized pipeline form: the dominant stage contributes fully, the
    rest amortize over the tile count (the analytic model's fill term)."""
    X = F.copy()
    for i in range(F.shape[0]):
        for j in _STAGE_IDX:
            if j != assign[i]:
                X[i, j] = F[i, j] / n_fill[i]
    return X


def _assign(F: np.ndarray, coef: np.ndarray) -> np.ndarray:
    stage = F[:, list(_STAGE_IDX)] * coef[list(_STAGE_IDX)]
    return np.asarray([_STAGE_IDX[int(np.argmax(row))] for row in stage])


def _deviation(pred: np.ndarray, y: np.ndarray) -> float:
    return float(np.median(np.abs(pred - y) / np.maximum(y, 1e-12)))


def _fit_form(F, n_fill, y, w, combine: str, max_iters: int) -> tuple:
    """Weighted NNLS fit of one combine form; returns (coef, deviation).

    Rows are scaled by ``w`` (1/y): the objective is squared *relative*
    error, matching the reported median-relative-deviation metric — without
    it a single slow op (a 100x outlier like an int8 GEMV that falls off
    a library's fast path) owns the whole fit."""
    if combine == "sum":
        coef = _nnls(F * w[:, None], y * w)
        return coef, _deviation(F @ coef, y)
    coef = _nnls(F * w[:, None], y * w)     # sum fit seeds the assignment
    assign = _assign(F, np.where(coef > 0, coef, 1e-30))
    deviation = math.inf
    for _ in range(max_iters):
        X = _max_design(F, n_fill, assign)
        coef = _nnls(X * w[:, None], y * w)
        deviation = _deviation(X @ coef, y)
        new_assign = _assign(F, np.where(coef > 0, coef, 1e-30))
        if (new_assign == assign).all():
            break
        assign = new_assign
    return coef, deviation


def fit_profile(F: np.ndarray, n_fill: np.ndarray, y: np.ndarray, *,
                combine: str | None = None, max_iters: int = 10,
                trim_nmedian: float = 3.0) -> dict:
    """Fit coefficients for both combine forms; return the winner + details.

    ``F``: (n, len(COEF_NAMES)) work units; ``n_fill``: fill divisor per
    sample; ``y``: measured seconds.  After the first pass, samples whose
    relative error exceeds ``trim_nmedian`` x the median are dropped and the
    winner refitted (backend pathologies must not warp every other rate);
    the reported deviation is still computed over ALL samples.
    """
    F = np.asarray(F, dtype=float)
    y = np.asarray(y, dtype=float)
    n_fill = np.maximum(1, np.asarray(n_fill, dtype=float))
    if F.ndim != 2 or F.shape[1] != len(COEF_NAMES):
        raise ValueError(f"feature matrix must be (n, {len(COEF_NAMES)})")
    if len(y) < 3:
        raise ValueError("need at least 3 measurements to fit a profile")
    w = 1.0 / np.maximum(y, 1e-12)

    forms = {f: _fit_form(F, n_fill, y, w, f, max_iters)
             for f in ("sum", "max")}
    pick = combine or min(forms, key=lambda f: forms[f][1])
    coef, deviation = forms[pick]

    # trimmed refit of the winning form
    pred = _predict_rows(F, n_fill, coef, pick)
    rel = np.abs(pred - y) / np.maximum(y, 1e-12)
    keep = rel <= trim_nmedian * max(float(np.median(rel)), 1e-6)
    n_trimmed = int((~keep).sum())
    if 0 < n_trimmed <= len(y) - max(3, len(COEF_NAMES) // 2):
        coef2, _ = _fit_form(F[keep], n_fill[keep], y[keep], w[keep],
                             pick, max_iters)
        dev2 = _deviation(_predict_rows(F, n_fill, coef2, pick), y)
        if dev2 <= deviation:
            coef, deviation = coef2, dev2
    return {
        "coef": tuple(float(c) for c in coef),
        "combine": pick,
        "deviation": deviation,
        "deviation_by_form": {k: float(v[1]) for k, v in forms.items()},
        "n_trimmed": n_trimmed,
        "fitted": [COEF_NAMES[j] for j in range(len(COEF_NAMES))
                   if np.linalg.norm(F[:, j]) > 0],
    }


def _predict_rows(F, n_fill, coef, combine) -> np.ndarray:
    from repro_torch.tune.evaluator import _OVERHEAD_IDX
    stage = F[:, list(_STAGE_IDX)] * coef[list(_STAGE_IDX)]
    fixed = F[:, list(_OVERHEAD_IDX)] @ coef[list(_OVERHEAD_IDX)]
    if combine == "sum":
        return stage.sum(axis=1) + fixed
    steady = stage.max(axis=1)
    return steady + (stage.sum(axis=1) - steady) / n_fill + fixed


# ------------------------------------------------------------ candidate sets
def default_candidate_groups(g: XGraph, max_samples: int = 48,
                             extra: list | None = None) -> list:
    """The measurable fused-op set: singles + template-fusable pairs (+ any
    caller-supplied groups, e.g. a searched strategy's segments), stride-
    sampled down to ``max_samples`` so calibration cost stays bounded."""
    from repro_torch.core import isomorphism, templates

    pairs = templates.pairwise_fusable(
        isomorphism.find_all(g, templates.KERNEL_TEMPLATES))
    singles = [[n.name] for n in g
               if n.op not in ("input", "softmax", "concat")]
    fused = [list(p) for p in sorted(pairs)]
    seen, cands = set(), []
    for grp in (extra or []) + singles + fused:
        key = tuple(grp)
        if key not in seen:
            seen.add(key)
            cands.append(list(grp))
    if len(cands) > max_samples:
        idx = np.linspace(0, len(cands) - 1, max_samples).astype(int)
        cands = [cands[i] for i in sorted(set(idx.tolist()))]
    return cands


def default_horizontal_candidates(g: XGraph, max_sets: int = 6) -> list:
    """Fork points with >= 2 *stackable* conv consumers sharing one input —
    the sibling sets ``lower_horizontal`` turns into ONE OC-stacked launch,
    and therefore the launches calibration must measure directly
    (extrapolating their cost from chain coefficients misses the per-channel
    requant vectors and the wider stacked OC panel the launch actually runs).
    Compatibility mirrors ``lower_horizontal``'s classes: same kernel,
    stride and pad, dilation 1."""
    out = []
    for node in g:
        classes: dict = {}
        for c in g.consumers(node.name):
            nd = g.nodes[c]
            a = nd.attrs
            if nd.op != "conv" or tuple(a.get("dilation", (1, 1))) != (1, 1):
                continue
            kh, kw = a["kernel"]
            key = (kh, kw, tuple(a.get("stride", (1, 1))),
                   str(a.get("pad", "same")))
            classes.setdefault(key, []).append(c)
        for ms in classes.values():
            if len(ms) >= 2 and len(out) < max_sets:
                out.append(ms)
    return out


# -------------------------------------------------------------- calibration
@dataclasses.dataclass
class CalibrationResult:
    profile: DeviceProfile
    measurements: list              # list[Measurement], fit set order
    report: dict                    # deviations, band checks, skip reasons
    model: ModelEvaluator | None = None   # measurement-refit learned model

    def evaluator(self, g: XGraph, dev: DeviceModel) -> CalibratedEvaluator:
        return CalibratedEvaluator(g, dev, self.profile)


def calibrate(g: XGraph, qm, dev: DeviceModel, *,
              groups: list | None = None, harness=None, measure_fn=None,
              backend: str = "fused", features: str = "kernel",
              device=None, warmup: int = 1, repeats: int = 7,
              max_samples: int = 48, combine: str | None = None,
              name: str | None = None,
              min_measurable_s: float | None = None,
              refit_model: bool = True,
              horizontal: list | None = None) -> CalibrationResult:
    """Measure a fused-op candidate set and fit a :class:`DeviceProfile`.

    ``measure_fn(group) -> seconds`` overrides the harness (simulator ground
    truth in tests); otherwise a :class:`MeasurementHarness` on ``backend``
    and ``device`` (None: CUDA) does the timing.  ``min_measurable_s``
    (None: the harness's own resolution, ``measure.MIN_MEASURABLE_S``)
    drops units too short to time.  Only groups that are feasible on ``dev`` *and* lower to
    a fused launch (or are deliberately measurable fallbacks) enter the fit;
    skipped groups are reported, never silently dropped.

    ``horizontal`` lists sibling-head sets whose OC-stacked launches are
    measured DIRECTLY and added to the fit as stacked-launch rows (``None``:
    auto-discover fork points via :func:`default_horizontal_candidates`;
    ``[]``: disable).  Before this, a stacked launch's cost was extrapolated
    from chain coefficients alone — the per-channel requant vectors and the
    stacked OC panel never constrained the fit.  The stacked rows' own
    deviation band is reported separately (``report["stacked"]``).  Requires
    the harness path (injected ``measure_fn`` ground truth measures chain
    groups only).
    """
    analytic = AnalyticEvaluator(g, dev)
    cands = groups if groups is not None else default_candidate_groups(
        g, max_samples=max_samples)
    if measure_fn is None and harness is None:
        harness = MeasurementHarness(g, qm, dev, backend=backend,
                                     device=device, warmup=warmup,
                                     repeats=repeats)

    measurable, feats, skipped = [], [], []
    for grp in cands:
        got = group_features(g, dev, grp, domain=features, analytic=analytic)
        if got is None:
            skipped.append({"group": list(grp), "reason": "infeasible"})
            continue
        item = lower.lower_group(g, None, list(grp))
        if isinstance(item, lower.RefFallback) and \
                item.reason in ("folded_concat", "host_op"):
            skipped.append({"group": list(grp), "reason": item.reason})
            continue
        measurable.append(list(grp))
        feats.append(got)

    if measure_fn is not None:
        got_ms = []
        for grp in measurable:
            sec = measure_fn(grp)
            got_ms.append(None if sec is None else Measurement(
                nodes=tuple(grp), kind="injected", seconds=float(sec),
                spread=0.0, n_samples=1, n_rejected=0))
    else:
        # round-robin passes over the whole set: interference epochs hit
        # passes, not groups (see MeasurementHarness.measure_set)
        got_ms = harness.measure_set(measurable)

    # measurement floor: units below the harness's resolution (0.5 ms of
    # host wall-clock on the CPU, 1 us of CUDA-event device time on the
    # card; measure.MIN_MEASURABLE_S) carry no rate information and only
    # poison the relative-error fit.  The floor never applies to injected
    # ground truth (simulator seconds are exact), and is dropped entirely
    # when it would starve the fit.
    if min_measurable_s is None:
        min_measurable_s = getattr(harness, "min_measurable_s", 5e-4)
    floor = min_measurable_s if measure_fn is None else 0.0
    if sum(1 for m in got_ms
           if m is not None and m.seconds >= floor) < 8:
        floor = 0.0

    rows, fills, ys, fit_groups, measurements = [], [], [], [], []
    for grp, (f, n_fill), m in zip(measurable, feats, got_ms):
        if m is None or not math.isfinite(m.seconds) or m.seconds <= 0:
            skipped.append({"group": list(grp), "reason": "unmeasured"})
            continue
        if m.seconds < floor:
            skipped.append({"group": list(grp), "reason": "below_floor",
                            "seconds": m.seconds})
            continue
        rows.append(f)
        fills.append(n_fill)
        ys.append(m.seconds)
        fit_groups.append(list(grp))
        measurements.append(m)
    n_chain_rows = len(rows)

    # --- stacked (horizontal) launch rows, measured directly ----------------
    stacked_idx: list[int] = []
    if measure_fn is None and features == "kernel" and \
            hasattr(harness, "measure_item_set"):
        from repro_torch.core import tiling

        h_sets, h_seen = [], set()
        for heads in (default_horizontal_candidates(g) if horizontal is None
                      else horizontal):
            key = tuple(heads)
            if key not in h_seen:
                h_seen.add(key)
                h_sets.append(list(heads))
        s_items, s_feats, s_fills = [], [], []
        for heads in h_sets:
            t = tiling.solve_horizontal(g, heads, dev)
            if not t.feasible:
                skipped.append({"group": list(heads),
                                "reason": "infeasible_horizontal"})
                continue
            for item in lower.lower_horizontal(g, qm, heads):
                if isinstance(item, lower.FusedLaunch) and \
                        item.kind == "horizontal":
                    s_items.append(item)
                    s_feats.append(_horizontal_vec(g, item))
                    s_fills.append(max(1, t.n_spatial_tiles))
        if s_items:
            for item, f, n_fill, m in zip(
                    s_items, s_feats, s_fills,
                    harness.measure_item_set(s_items)):
                if not math.isfinite(m.seconds) or m.seconds <= 0 or \
                        m.seconds < floor:
                    skipped.append({"group": list(item.nodes),
                                    "reason": "stacked_below_floor",
                                    "seconds": m.seconds})
                    continue
                stacked_idx.append(len(rows))
                rows.append(f)
                fills.append(n_fill)
                ys.append(m.seconds)
                fit_groups.append(list(item.nodes))
                measurements.append(m)

    fit = fit_profile(np.asarray(rows), np.asarray(fills), np.asarray(ys),
                      combine=combine)
    backend_name = backend if measure_fn is None else "injected"
    profile = DeviceProfile(
        name=name or f"{dev.name}-{backend_name}-cal",
        device=dev.name,
        backend=backend_name,
        jax_version=_toolchain_version(),
        features=features,
        combine=fit["combine"],
        coef=fit["coef"],
        deviation=fit["deviation"],
        n_samples=len(ys),
        meta={"fitted": fit["fitted"],
              "deviation_by_form": fit["deviation_by_form"],
              "gpu": _gpu_name()})

    # deviation of the exact prediction path the search evaluator uses
    pred = np.asarray([predict_seconds(profile, f, n)
                       for f, n in zip(rows, fills)])
    rel = np.abs(pred - np.asarray(ys)) / np.maximum(ys, 1e-12)
    report = {
        # stacked-launch rows report their own band: the paper-band headline
        # number must not hide a systematically worse horizontal fit
        "stacked": {
            "n_samples": len(stacked_idx),
            "deviation": (float(np.median(rel[stacked_idx]))
                          if stacked_idx else None),
        },
        "deviation": fit["deviation"],
        "deviation_by_form": fit["deviation_by_form"],
        "mean_abs_deviation": float(np.mean(
            np.abs(pred - np.asarray(ys)) / np.maximum(ys, 1e-12))),
        "paper_model_band": list(PAPER_MODEL_BAND),
        "accept_band": ACCEPT_BAND,
        "within_accept_band": fit["deviation"] <= ACCEPT_BAND,
        "n_samples": len(ys),
        "n_trimmed": fit["n_trimmed"],
        "n_skipped": len(skipped),
        "skipped": skipped,
        "fitted": fit["fitted"],
        "profile_hash": profile.hash(),
        "samples": [
            {**m.to_json(), "predicted": float(p),
             "rel_err": float(abs(p - m.seconds) / max(m.seconds, 1e-12))}
            for m, p in zip(measurements, pred)],
    }

    model = None
    # the learned-model refit prices groups through the chain tiling solver,
    # so it trains on the chain rows only (stacked rows would be mis-featured)
    if refit_model and n_chain_rows >= len(ModelEvaluator.FEATURES):
        model = ModelEvaluator(g, dev, fit_groups[:n_chain_rows],
                               targets=list(ys[:n_chain_rows]))
        report["model_refit_mape"] = model.fit_mape
        report["model_within_paper_band"] = model.fit_mape <= PAPER_MODEL_BAND[1]

    return CalibrationResult(profile=profile, measurements=measurements,
                             report=report, model=model)
