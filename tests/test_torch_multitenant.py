"""The port's multi-tenant host against the JAX package's: two co-resident
toy models on the CPU, every interleaved answer bit-equal to the
reference's ``Session(backend="ref")``, the DDR carve-up equal to the
reference's for the same two artifacts, admission control, SLO burn alerts
with flight dumps, and the planning-device / ``torch.device`` pinning that
the port adds (``session.device`` is a ``torch.device`` there; the planning
model is ``session.device_model``)."""
import numpy as np
import pytest

from torch_common import reference_model, strategy


def _pair(seed):
    """The toy model with weights from ``seed``: the reference's session and
    the port's on the CPU, the port carrying the reference's quantization."""
    from repro import asm as ref_asm
    from repro.cnn import init_params
    from repro.core import executor, quantize
    from repro.hw import ZU2 as REF_ZU2
    from repro.runtime import Session as RefSession
    from repro_torch import asm
    from repro_torch.core.carry import qm_from_reference
    from repro_torch.hw import ZU2
    from repro_torch.runtime import Session
    from torch_common import build_graph

    g_ref = reference_model("toy", 16)[0]
    params = init_params(g_ref, seed=seed)
    x = np.random.default_rng(seed).standard_normal(
        g_ref.shape("data")).astype(np.float32)
    qm_ref = quantize.calibrate(g_ref, params, x, executor.run_float)
    ref = RefSession(g_ref, strategy("repro", g_ref), REF_ZU2, qm_ref,
                     backend="ref", cache=ref_asm.PlanCache())
    g = build_graph("repro_torch", "toy", 16)
    port = Session(g, strategy("repro_torch", g), ZU2,
                   qm_from_reference(qm_ref), device="cpu",
                   cache=asm.PlanCache())
    return ref, port


@pytest.fixture(scope="module")
def two_models():
    (ra, pa), (rb, pb) = _pair(0), _pair(1)
    return (ra, rb), (pa, pb)


def _inputs(g, n, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(-128, 127, (n,) + tuple(g.shape("data")[1:]),
                        np.int8)


# ----------------------------------------------------------------- routing
def test_interleaved_answers_bit_equal_to_the_reference(two_models):
    from repro_torch.runtime import MultiServer

    (ra, rb), (pa, pb) = two_models
    xs = _inputs(pa.graph, 6)
    with MultiServer() as ms:
        ms.add_model("a", pa, slo="gold", max_latency_s=1e-4, warmup=False)
        ms.add_model("b", pb, slo="silver", max_latency_s=1e-4, warmup=False)
        futs = [(name, x, ms.submit(name, x))
                for x in xs for name in ("a", "b")]
        for name, x, fut in futs:
            want = (ra if name == "a" else rb).run(x)
            got = fut.result(timeout=60)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k].numpy(), want[k])
        st = ms.stats()
    assert st["models"]["a"]["n_served"] == len(xs)
    assert st["models"]["b"]["n_served"] == len(xs)
    assert st["slo"] == {"a": "gold", "b": "silver"}


def test_models_differ_so_routing_is_observable(two_models):
    """The two tenants answer the same input differently, so a request
    routed to the wrong tenant would fail the bit-equality above."""
    _, (pa, pb) = two_models
    x = _inputs(pa.graph, 1)[0]
    a, b = pa.run(x), pb.run(x)
    assert any(not bool((a[k] == b[k]).all()) for k in a)


# ---------------------------------------------------------- DDR partitioning
def test_ddr_partition_equals_the_reference(two_models):
    from repro.runtime import MultiServer as RefMultiServer
    from repro_torch.hw import ZU2
    from repro_torch.runtime import MultiServer

    (ra, rb), (pa, pb) = two_models
    with RefMultiServer() as rms:
        rms.add_model("a", ra, warmup=False)
        rms.add_model("b", rb, warmup=False)
        want = rms.ddr_partition()
        want_used = rms.stats()["ddr_used_bytes"]
    with MultiServer() as ms:
        ms.add_model("a", pa, warmup=False)
        ms.add_model("b", pb, warmup=False)
        parts = ms.ddr_partition()
        st = ms.stats()
    assert parts == want
    assert parts[0]["base"] == 0
    assert parts[1]["base"] == parts[0]["bytes"]       # disjoint regions
    assert st["ddr_used_bytes"] == want_used <= ZU2.ddr_bytes
    assert st["ddr_budget_bytes"] == ZU2.ddr_bytes     # planning model's


def test_add_model_refused_when_ddr_budget_exhausted(two_models):
    from repro_torch.runtime import MultiServer

    _, (pa, pb) = two_models
    budget = int(pa.artifact.peak_ddr_bytes * 1.5)     # fits one, not two
    with MultiServer(ddr_budget_bytes=budget) as ms:
        ms.add_model("a", pa, warmup=False)
        with pytest.raises(MemoryError, match="DDR"):
            ms.add_model("b", pb, warmup=False)
        assert ms.models() == ["a"]
        ms.remove_model("a")
        ms.add_model("b", pb, warmup=False)
        assert ms.ddr_partition()[0]["base"] == 0


# ------------------------------------------------------------------ devices
def test_name_and_slo_conflicts_rejected(two_models):
    from repro_torch.runtime import MultiServer

    _, (pa, _) = two_models
    with MultiServer() as ms:
        ms.add_model("a", pa, warmup=False)
        with pytest.raises(ValueError, match="already registered"):
            ms.add_model("a", pa, warmup=False)
        with pytest.raises(ValueError, match="unknown SLO"):
            ms.add_model("c", pa, slo="platinum", warmup=False)


def test_session_on_another_torch_device_refused(two_models):
    """The host pins the first tenant's ``torch.device``: a session whose
    kernels run elsewhere is refused like a planning-device conflict."""
    import torch

    from repro_torch.runtime import MultiServer

    _, (pa, pb) = two_models
    with MultiServer() as ms:
        ms.add_model("a", pa, warmup=False)
        pb_meta = object.__new__(type(pb))
        pb_meta.__dict__.update(pb.__dict__)
        pb_meta.device = torch.device("meta")
        with pytest.raises(ValueError, match="runs on meta"):
            ms.add_model("b", pb_meta, warmup=False)
        assert ms.models() == ["a"]


def test_session_under_another_planning_device_refused(two_models):
    from repro_torch.hw import H100
    from repro_torch.runtime import MultiServer

    _, (pa, pb) = two_models
    with MultiServer() as ms:
        ms.add_model("a", pa, warmup=False)
        other = object.__new__(type(pb))
        other.__dict__.update(pb.__dict__)
        other.device_model = H100
        with pytest.raises(ValueError, match="targets device 'h100'"):
            ms.add_model("b", other, warmup=False)


def test_artifact_tenant_opens_on_the_given_device(two_models):
    from repro_torch.runtime import MultiServer

    (ra, _), (pa, _) = two_models
    x = _inputs(pa.graph, 1)[0]
    with MultiServer() as ms:
        ms.add_model("a", pa.artifact, warmup=False,
                     session_kw={"device": "cpu"})
        sess = ms._models["a"]["session"]
        assert sess.device.type == "cpu" and sess.backend == "fused"
        got = ms.submit("a", x).result(timeout=60)
    want = ra.run(x)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


# --------------------------------------------------------- admission control
def test_admission_control_sheds_load_with_event_and_dump(two_models):
    from repro_torch.obs.events import EventLog
    from repro_torch.obs.flight import FlightRecorder
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.runtime import AdmissionError, MultiServer

    _, (pa, _) = two_models
    x = np.zeros(tuple(pa.graph.shape("data")[1:]), np.int8)
    events = EventLog()
    flight = FlightRecorder(capacity=16, events=events)
    with MultiServer(flight=flight, events=events) as ms:
        ms.add_model("a", pa, max_queue=0, warmup=False)
        with pytest.raises(AdmissionError):
            ms.submit("a", x)
    assert REGISTRY.get("serve.rejected{model=a}").value >= 1.0
    assert [e.kind for e in events.records(kind="admission")] \
        == ["admission.reject"]
    rec = flight.records()[-1]
    assert rec.status == "rejected" and rec.tenant == "a"
    dump = flight.dumps()[-1]
    assert dump["reason"] == "admission_rejection"
    assert dump["context"]["a"]["slo_class"] == "best_effort"
    assert dump["context"]["a"]["tiles"] == pa.tile_summary()


def test_stats_use_label_index_and_expose_burn(two_models):
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.runtime import MultiServer

    _, (pa, pb) = two_models
    x = np.zeros(tuple(pa.graph.shape("data")[1:]), np.int8)
    with MultiServer(burn_kw=dict(fast_window_s=1.0, slow_window_s=2.0,
                                  min_samples=4)) as ms:
        ms.add_model("a", pa, slo="gold", warmup=False)
        ms.add_model("b", pb, slo="best_effort", warmup=False)
        before = ms.stats()["requests"]["a"]
        [f.result(timeout=60) for f in [ms.submit("a", x) for _ in range(3)]]
        st = ms.stats()
    assert st["requests"]["a"] >= before + 3.0
    assert set(st["requests"]) == set(st["rejected"]) == {"a", "b"}
    assert st["burn"]["b"] is None
    assert set(st["burn"]["a"]) == {"fast", "slow", "n_fast", "n_slow"}
    assert st["burn"]["a"]["n_fast"] >= 3
    assert REGISTRY.get("slo.burn_rate{class=gold,model=a,window=fast}")


def test_gold_slo_violation_alerts_and_dumps(two_models, tmp_path):
    from repro_torch.obs.events import EventLog
    from repro_torch.obs.flight import FlightRecorder
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.runtime import MultiServer

    _, (pa, _) = two_models
    x = np.zeros(tuple(pa.graph.shape("data")[1:]), np.int8)
    events = EventLog()
    flight = FlightRecorder(capacity=64, events=events,
                            dump_dir=str(tmp_path))
    with MultiServer(flight=flight, events=events,
                     burn_kw=dict(fast_window_s=30.0, slow_window_s=60.0,
                                  min_samples=4, cooldown_s=0.0)) as ms:
        ms.add_model("a", pa, slo="gold", target_p99_ms=1e-6, warmup=False)
        [f.result(timeout=60) for f in [ms.submit("a", x) for _ in range(8)]]
    alerts = events.records(kind="slo.alert")
    assert alerts and alerts[0].fields["model"] == "a"
    assert alerts[0].fields["fast_burn"] >= 2.0
    dumps = [d for d in flight.dumps() if d["reason"] == "slo_violation"]
    assert dumps and dumps[0]["path"].startswith(str(tmp_path))
    ok = [r for r in dumps[-1]["records"] if r["status"] == "ok"]
    assert ok and all(r["queue_wait_s"] >= 0 and r["execute_s"] > 0
                      and r["batch_size"] >= 1 for r in ok)
    assert REGISTRY.get("slo.alerts{class=gold,model=a}").value >= 1.0


# ---------------------------------------------------- drift and the endpoint
def test_attach_drift_and_scrape_the_host(two_models):
    """A tenant's drift profiler labels its gauges with the model, the
    shared endpoint serves every tenant's series, and ``/explain/<model>``
    carries the drift section."""
    import json
    import urllib.request

    from repro_torch import tune
    from repro_torch.core.cost import SimulatorEvaluator
    from repro_torch.obs.export import find_samples, parse_openmetrics
    from repro_torch.runtime import MultiServer

    _, (pa, pb) = two_models
    x = np.zeros(tuple(pa.graph.shape("data")[1:]), np.int8)
    with MultiServer() as ms:
        ms.add_model("a", pa, slo="gold", warmup=False)
        ms.add_model("b", pb, warmup=False)
        http = ms.serve_metrics()
        sim = SimulatorEvaluator(pa.graph, pa.device_model)
        prof = tune.calibrate(pa.graph, pa.qm, pa.device_model,
                              measure_fn=lambda grp: sim(grp),
                              features="analytic").profile
        dp = ms.attach_drift("a", profile=prof, every=1,
                             measure_fn=lambda item: 1e-3)
        for name in ("a", "b", "a"):
            ms.submit(name, x).result(timeout=60)
        with urllib.request.urlopen(http.url("/metrics")) as r:
            fams = parse_openmetrics(r.read().decode())
        exp = json.loads(urllib.request.urlopen(
            http.url("/explain/a")).read().decode())
    pa.attach_drift(None)
    assert dp.n_sampled >= 2 and dp.labels == {"model": "a"}
    assert find_samples(fams, "serve_requests", model="a")
    assert find_samples(fams, "serve_requests", model="b")
    assert find_samples(fams, "drift_median_deviation", model="a")
    assert find_samples(fams, "drift_tripped", model="a")
    assert find_samples(fams, "slo_burn_rate", model="a", window="fast")
    assert "drift" in json.dumps(exp)


def test_multiserver_rebounds_shared_plan_cache():
    from repro_torch import asm
    from repro_torch.runtime import MultiServer

    old = asm.PLAN_CACHE.max_entries
    try:
        MultiServer(plan_cache_max_entries=5)
        assert asm.PLAN_CACHE.max_entries == 5
    finally:
        asm.PLAN_CACHE.max_entries = old
