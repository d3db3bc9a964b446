"""The port's drift profiler against the JAX package's on the same toy model.

The port prices a unit with its kernel-domain features (the CUDA kernel's
geometry), the reference with the Pallas kernel's, so their predictions
differ by design.  The comparisons here fix both sides to the same per-unit
predicted and measured seconds — an injected ``measure_fn`` and a patched
``predict_item_seconds`` on each side — and then hold the reports (band,
per-unit deviation, aggregate, verdict), the sampling cadence, the labelled
gauges and the session's ``explain`` drift section equal field by field.
The port's own default measurement path runs once on the CPU.
"""
import dataclasses
import json

import numpy as np
import pytest

from torch_common import port_model, reference_model, strategy

TOL = 1e-12


def _profile(pkg, g, qm):
    """The simulator-calibrated profile of the toy model (analytic
    features), as in the reference's drift tests."""
    import importlib
    tune = importlib.import_module(f"{pkg}.tune")
    ZU2 = importlib.import_module(f"{pkg}.hw").ZU2
    sim = importlib.import_module(f"{pkg}.core.cost").SimulatorEvaluator(
        g, ZU2)
    return tune.calibrate(g, qm, ZU2, measure_fn=lambda grp: sim(grp),
                          features="analytic").profile


@pytest.fixture(scope="module")
def sessions():
    """One toy session per package under the same profile: the reference's
    calibrated there, carried across as JSON (equal hash)."""
    from repro import asm as ref_asm
    from repro.hw import ZU2 as REF_ZU2
    from repro.runtime import Session as RefSession
    from repro_torch import asm
    from repro_torch.hw import ZU2
    from repro_torch.runtime import Session
    from repro_torch.tune.profile import DeviceProfile

    g_ref, _, _, qm_ref, _ = reference_model("toy", 16)
    prof_ref = _profile("repro", g_ref, qm_ref)
    ref = RefSession(g_ref, strategy("repro", g_ref), REF_ZU2, qm_ref,
                     backend="ref", cache=ref_asm.PlanCache(),
                     profile=prof_ref)
    g, qm, _ = port_model("toy", 16)
    prof = DeviceProfile.from_json(prof_ref.to_json())
    port = Session(g, strategy("repro_torch", g), ZU2, qm, device="cpu",
                   cache=asm.PlanCache(), profile=prof)
    assert prof.hash() == prof_ref.hash()
    return ref, port


def _pred(item):
    """Deterministic per-unit prediction from the unit's node names; None
    (no finite prediction) for the last fallback."""
    key = "+".join(item.nodes)
    if key == "fc1":
        return None
    return 1e-4 * (1 + sum(map(ord, key)) % 7)


def _measure(scale_of):
    def measure(item):
        key = "+".join(item.nodes)
        return _pred(item) * (1.0 + scale_of(key))
    return measure


def _skew(key):
    """Per-unit relative error: spread across [-0.3, 0.3]."""
    return (sum(map(ord, key)) % 13 - 6) / 20.0


@pytest.fixture()
def patched(monkeypatch):
    """Both packages' ``predict_item_seconds`` replaced by ``_pred``."""
    import repro.tune.evaluator as ref_eval
    import repro_torch.tune.evaluator as port_eval
    for mod in (ref_eval, port_eval):
        monkeypatch.setattr(mod, "predict_item_seconds",
                            lambda profile, g, dev, item: _pred(item))


def _pair(sessions, *, profile=None, labels=None, **kw):
    from repro.obs.drift import DriftProfiler as RefDrift
    from repro.obs.metrics import MetricsRegistry as RefRegistry
    from repro_torch.obs.drift import DriftProfiler
    from repro_torch.obs.metrics import MetricsRegistry

    ref_s, port_s = sessions
    rp = pp = None
    if profile is not None:
        rp, pp = profile(ref_s.profile), profile(port_s.profile)
    ref = RefDrift.from_session(ref_s, registry=RefRegistry(), labels=labels,
                                **({"profile": rp} if rp else {}), **kw)
    port = DriftProfiler.from_session(port_s, registry=MetricsRegistry(),
                                      labels=labels,
                                      **({"profile": pp} if pp else {}), **kw)
    return ref, port


def assert_reports_equal(a: dict, b: dict):
    """Two ``DriftReport.to_json()`` documents equal field by field, floats
    to ``TOL``."""
    assert set(a) == set(b)
    for k in a:
        if k == "units":
            assert len(a[k]) == len(b[k])
            for u, v in zip(a[k], b[k]):
                assert set(u) == set(v)
                for f in u:
                    if isinstance(u[f], float):
                        assert abs(u[f] - v[f]) <= TOL, (k, f)
                    else:
                        assert u[f] == v[f], (k, f)
        elif isinstance(a[k], float):
            assert abs(a[k] - b[k]) <= TOL, k
        else:
            assert a[k] == b[k], k


# ------------------------------------------------------------- the reports
def test_units_and_keys_match_the_reference(sessions, patched):
    ref, port = _pair(sessions, every=1, measure_fn=_measure(_skew))
    assert [(u.nodes, type(u).__name__) for u in port._resolve_units()] == \
        [(u.nodes, type(u).__name__) for u in ref._resolve_units()]
    assert port._skipped == ref._skipped == [("fc1", "no finite prediction")]
    assert sessions[1].tile_summary() == sessions[0].tile_summary()


@pytest.mark.parametrize("skew", [_skew, lambda key: 0.0,
                                  lambda key: 1.0],
                         ids=["spread", "exact", "doubled"])
def test_report_equal_field_by_field(sessions, patched, skew):
    ref, port = _pair(sessions, every=1, measure_fn=_measure(skew))
    for _ in range(3):
        ref.sample()
        port.sample()
    a, b = ref.report().to_json(), port.report().to_json()
    assert_reports_equal(a, b)
    json.dumps(b)
    assert b["n_sampled"] == 3 and b["units"]
    assert b["drifted"] == (b["aggregate_deviation"] > b["band"])
    assert port.last == pytest.approx(ref.last, abs=TOL)


def test_perturbed_profile_flagged_alike(sessions, patched):
    """A profile with doubled coefficients (halved rates): a new hash, so the
    provenance check fails on both sides, and the band follows the
    perturbed profile's own fit residual."""
    double = lambda p: dataclasses.replace(   # noqa: E731
        p, coef=tuple(2 * c for c in p.coef), deviation=0.2)
    ref, port = _pair(sessions, profile=double, every=1,
                      measure_fn=_measure(_skew))
    ref.sample()
    port.sample()
    a, b = ref.report().to_json(), port.report().to_json()
    assert_reports_equal(a, b)
    assert b["band"] == pytest.approx(0.4)
    assert b["profile_hash"] != sessions[1].artifact.profile_hash
    assert not b["profile_match"] and b["drifted"]


def test_sampling_cadence_matches(sessions, patched):
    calls = {"ref": 0, "port": 0}

    def counting(side):
        def measure(item):
            calls[side] += 1
            return 1e-3
        return measure

    from repro.obs.drift import DriftProfiler as RefDrift
    from repro.obs.metrics import MetricsRegistry as RefRegistry
    from repro_torch.obs.drift import DriftProfiler
    from repro_torch.obs.metrics import MetricsRegistry

    ref = RefDrift.from_session(sessions[0], every=4, registry=RefRegistry(),
                                measure_fn=counting("ref"))
    port = DriftProfiler.from_session(sessions[1], every=4,
                                      registry=MetricsRegistry(),
                                      measure_fn=counting("port"))
    fired = [(ref.observe_launch(), port.observe_launch()) for _ in range(8)]
    assert fired == [(f, f) for f in [False, False, False, True] * 2]
    n_units = len(port._resolve_units())
    assert calls == {"ref": 2 * n_units, "port": 2 * n_units}
    assert (port.n_observed, port.n_sampled) == (ref.n_observed,
                                                 ref.n_sampled) == (8, 2)


def test_labelled_gauges_and_trip_event_match(sessions, patched):
    from repro.obs.events import EVENTS as REF_EVENTS
    from repro_torch.obs.events import EVENTS

    ref, port = _pair(sessions, every=1, labels={"model": "toy"},
                      measure_fn=_measure(lambda key: 1.0))
    trips = {"ref": [], "port": []}
    watch = {side: (lambda e, side=side: trips[side].append(e)
                    if e.kind == "drift.trip" else None)
             for side in trips}
    REF_EVENTS.subscribe(watch["ref"])
    EVENTS.subscribe(watch["port"])
    try:
        for _ in range(2):
            ref.sample()
            port.sample()
    finally:
        REF_EVENTS.unsubscribe(watch["ref"])
        EVENTS.unsubscribe(watch["port"])
    names = ("drift.median_deviation{model=toy}", "drift.tripped{model=toy}",
             "drift.aggregate_deviation{model=toy}",
             "drift.drifted{model=toy}", "drift.samples{model=toy}")
    for name in names:
        assert port.registry.get(name).value == pytest.approx(
            ref.registry.get(name).value, abs=TOL), name
    assert port.registry.get("drift.tripped{model=toy}").value == 1.0
    assert port.registry.get("drift.samples{model=toy}").value == 2.0
    assert len(trips["port"]) == len(trips["ref"]) == 1
    assert trips["port"][0].fields == pytest.approx(trips["ref"][0].fields)


def test_explain_drift_section_matches(sessions, patched):
    ref, port = _pair(sessions, every=2, measure_fn=_measure(_skew))
    x = np.random.default_rng(1).integers(
        -128, 128, sessions[0].graph.shape("data")[1:]).astype(np.int8)
    ref_s, port_s = sessions
    ref_s.attach_drift(ref)
    port_s.attach_drift(port)
    try:
        for _ in range(4):
            want = ref_s.run(x)
            got = port_s.run(x)
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(), want[k])
        a, b = ref_s.explain()["drift"], port_s.explain()["drift"]
        text = port_s.explain(render=True)
        assert port_s.drift_state() == pytest.approx(ref_s.drift_state(),
                                                     abs=TOL)
    finally:
        ref_s.attach_drift(None)
        port_s.attach_drift(None)
    assert port.n_observed == 4 and port.n_sampled == 2
    assert b["drifted"] == a["drifted"]
    assert b["aggregate_deviation"] == pytest.approx(a["aggregate_deviation"],
                                                     abs=TOL)
    assert [(u["key"], u["kind"], u["n_samples"]) for u in b["units"]] == \
        [(u["key"], u["kind"], u["n_samples"]) for u in a["units"]]
    for u, v in zip(a["units"], b["units"]):
        assert v["deviation"] == pytest.approx(u["deviation"], abs=TOL)
    assert "drift" in text.lower()
    assert port_s.drift_state() is None


# ------------------------------------------------ the port's own measurement
def test_default_measurement_path_runs_on_the_cpu(sessions):
    """No injected measure_fn: each unit is built by
    ``tune.measure.build_item_callable`` on the session's device with the
    executor's prepared launch weights and timed by ``time_callable``."""
    from repro_torch.obs.drift import DriftProfiler
    from repro_torch.obs.metrics import MetricsRegistry

    port_s = sessions[1]
    dp = DriftProfiler.from_session(port_s, every=1, repeats=1,
                                    registry=MetricsRegistry())
    assert str(dp.device) == "cpu" and dp.dev is port_s.device_model
    dp.prepare()
    dp.sample()
    rep = dp.report()
    assert rep.units and rep.n_sampled == 1
    assert all(u.measured > 0 and u.predicted > 0 for u in rep.units)
    assert rep.aggregate is not None and rep.profile_match
    kinds = {u.kind for u in rep.units}
    assert "chain" in kinds
    # the executor's prepared weights were reused, not rebuilt
    prepared = [p for p in port_s.executor._prepared if p is not None]
    assert prepared and all(any(p is q for q in dp._prep.values())
                            for p in prepared)


def test_from_artifact_keeps_resolved_profile(sessions, tmp_path):
    from repro_torch import asm
    from repro_torch.obs.drift import DriftProfiler
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.runtime import Session

    port_s = sessions[1]
    p = port_s.profile
    path = str(tmp_path / "tuned.npz")
    asm.save_artifact(port_s.artifact, path)
    cache = asm.PlanCache()
    sess = Session.from_artifact(asm.load_artifact(path), cache=cache,
                                 profile=p, device="cpu")
    assert sess.cache_hit and cache.misses == 0
    assert sess.profile == p
    assert sess.stats()["session_profile_hash"] == p.hash()
    dp = DriftProfiler.from_session(sess, measure_fn=lambda item: 1e-3,
                                    registry=MetricsRegistry())
    assert dp.profile is p


def test_drift_needs_a_profile_and_a_program(sessions):
    from repro_torch.obs.drift import DriftProfiler
    from repro_torch.runtime import Session

    port_s = sessions[1]
    bare = Session(port_s.graph, port_s.artifact, port_s.device_model,
                   port_s.qm, device="cpu", cache=port_s.cache)
    with pytest.raises(ValueError, match="no device profile"):
        DriftProfiler.from_session(bare)
    with pytest.raises(ValueError, match="every"):
        DriftProfiler.from_session(port_s, every=0)
