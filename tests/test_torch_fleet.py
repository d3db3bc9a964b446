"""The port's serving fleet against the JAX package's: replicated Sessions on
a CPU ``torch.device``, health-driven failover under injected chaos (kill /
poison / hang / straggle), bounded retries with duplicate suppression,
deadlines, load shedding and re-admission after the warmup canary — the
reference's ``tests/test_fleet.py`` on ``repro_torch``, every answer
bit-equal to the reference's session — plus the heartbeat monitor and
retry policy (``distributed/health.py``, the reference's
``tests/test_distributed.py`` heartbeat tests) and the chaos log of one
script equal across the packages."""
import time

import numpy as np
import pytest

from torch_common import port_model, reference_model, strategy


@pytest.fixture(scope="module")
def toy_artifact():
    from repro_torch import asm
    from repro_torch.hw import ZU2

    g, qm, _ = port_model("toy", 16)
    return asm.compile_strategy(g, strategy("repro_torch", g), ZU2, qm=qm)


@pytest.fixture(scope="module")
def oracle():
    """The reference's single session (``backend="ref"``) and the request
    inputs: every fleet answer is held to it bit for bit."""
    from repro import asm as ref_asm
    from repro.hw import ZU2
    from repro.runtime import Session

    g, _, _, qm, _ = reference_model("toy", 16)
    sess = Session(g, strategy("repro", g), ZU2, qm, backend="ref",
                   cache=ref_asm.PlanCache())
    rng = np.random.default_rng(7)
    xs = [rng.integers(-128, 128, g.shape("data")[1:],
                       np.int64).astype(np.int8) for _ in range(24)]
    return xs, [sess.run(x) for x in xs]


def make_fleet(art, n=2, **kw):
    """A CPU fleet with test-speed knobs and its own registry and event
    log, as the reference's tests build theirs."""
    import torch

    from repro_torch.obs.events import EventLog
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.runtime import Fleet

    kw.setdefault("n_replicas", n)
    kw.setdefault("devices", [torch.device("cpu")])
    kw.setdefault("check_interval_s", 0.01)
    kw.setdefault("heartbeat_timeout_s", 0.5)
    kw.setdefault("retry_backoff_s", 0.005)
    kw.setdefault("attempt_timeout_s", 1.0)
    kw.setdefault("probe_interval_s", 0.03)
    kw.setdefault("probe_timeout_s", 2.0)
    kw.setdefault("registry", MetricsRegistry())
    kw.setdefault("events", EventLog())
    kw.setdefault("server_kw", {"max_batch": 4, "max_latency_s": 1e-3})
    return Fleet(art, **kw)


def assert_bit_exact(got, want):
    assert got is not None and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def wait_until(pred, timeout_s=8.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if pred():
            return True
        time.sleep(0.01)
    return False


# ----------------------------------------------------------------- healthy
def test_fleet_serves_bit_exact_across_replicas(toy_artifact, oracle):
    xs, wants = oracle
    with make_fleet(toy_artifact, n=2) as fleet:
        futs = [fleet.submit(x) for x in xs]
        for fut, want in zip(futs, wants):
            assert_bit_exact(fut.result(timeout=30), want)
        st = fleet.stats()
        assert st["completed"] == len(xs)
        assert sorted(st["active"]) == ["r0", "r1"]
        assert sum(r["n_served"] for r in st["replicas"].values()) >= len(xs)
        assert {r["device"] for r in st["replicas"].values()} == {"cpu"}
        for r in fleet.replicas().values():
            assert r.session.device.type == "cpu"
            assert r.session.backend == "fused"
            assert r.session.cache_hit          # seeded, not recompiled


def test_fleet_single_replica_matches_session(toy_artifact, oracle):
    xs, wants = oracle
    with make_fleet(toy_artifact, n=1) as fleet:
        for x, want in zip(xs[:6], wants[:6]):
            assert_bit_exact(fleet.submit(x).result(timeout=30), want)


def test_canary_is_compared_on_the_replica_device(toy_artifact):
    """The canary stays a numpy int8 input from ``default_rng(0)``; its
    expected answer is a tensor on replica 0's device, and a probe's answer
    is compared with ``torch.equal``."""
    import torch

    with make_fleet(toy_artifact, n=1) as fleet:
        assert fleet._canary_x.dtype == np.int8
        rng = np.random.default_rng(0)
        want = rng.integers(-128, 128, size=fleet._canary_x.shape,
                            dtype=np.int64).astype(np.int8)
        np.testing.assert_array_equal(fleet._canary_x, want)
        exp = fleet._canary_expected
        assert all(torch.is_tensor(v) and v.device.type == "cpu"
                   for v in exp.values())
        assert fleet._canary_ok({k: v.clone() for k, v in exp.items()})
        bad = {k: v.clone() for k, v in exp.items()}
        k0 = next(iter(bad))
        bad[k0].view(-1)[0] += 1
        assert not fleet._canary_ok(bad)


# -------------------------------------------------------------------- chaos
def test_kill_replica_failover_and_readmission(toy_artifact, oracle):
    from repro_torch.runtime import ChaosInjector

    xs, wants = oracle
    fleet = make_fleet(toy_artifact, n=2)
    chaos = ChaosInjector().attach(fleet)
    try:
        chaos.kill("r1")
        futs = [fleet.submit(x) for x in xs]
        for fut, want in zip(futs, wants):
            assert_bit_exact(fut.result(timeout=30), want)
        assert wait_until(lambda: "r1" not in fleet.active_replicas())
        st = fleet.stats()
        assert st["replicas"]["r1"]["state"] == "evicted"
        assert st["retries"] >= 1 and chaos.fired("kill") >= 1
        assert [e for e in fleet._events.records(kind="replica.evict")
                if e.fields["replica"] == "r1"]
        assert fleet._events.records(kind="request.retry")
        assert fleet.flight.dumps(), "eviction must freeze a flight dump"
        errors = [r for r in fleet.flight.records() if r.status == "error"]
        assert errors and all(r.error.startswith("ChaosError")
                              for r in errors)
        chaos.heal("r1")
        assert fleet.wait_active("r1", timeout_s=10)
        assert fleet.stats()["replicas"]["r1"]["admissions"] >= 1
        assert [e for e in fleet._events.records(kind="replica.admit")
                if e.fields["replica"] == "r1"
                and not e.fields.get("initial")]
        for x, want in zip(xs[:8], wants[:8]):
            assert_bit_exact(fleet.submit(x).result(timeout=30), want)
    finally:
        chaos.heal_all()
        fleet.close()


def test_poison_one_launch_is_retried_transparently(toy_artifact, oracle):
    from repro_torch.runtime import ChaosInjector

    xs, wants = oracle
    fleet = make_fleet(toy_artifact, n=2, max_consecutive_errors=3)
    chaos = ChaosInjector().attach(fleet)
    try:
        chaos.poison("r0", n_launches=1)
        chaos.poison("r1", n_launches=1)
        futs = [fleet.submit(x) for x in xs]
        for fut, want in zip(futs, wants):
            assert_bit_exact(fut.result(timeout=30), want)
        st = fleet.stats()
        assert st["retries"] >= 1
        assert chaos.fired("poison") == 2
        assert sorted(st["active"]) == ["r0", "r1"]
    finally:
        chaos.heal_all()
        fleet.close()


def test_hang_replica_attempt_timeout_drains_elsewhere(toy_artifact, oracle):
    from repro_torch.runtime import ChaosInjector

    xs, wants = oracle
    fleet = make_fleet(toy_artifact, n=2, attempt_timeout_s=0.3)
    chaos = ChaosInjector().attach(fleet)
    try:
        chaos.hang("r1")
        futs = [fleet.submit(x) for x in xs]
        for fut, want in zip(futs, wants):
            assert_bit_exact(fut.result(timeout=30), want)
        st = fleet.stats()
        assert st["completed"] == len(xs)
        assert st["retries"] >= 1
        assert wait_until(lambda: "r1" not in fleet.active_replicas())
    finally:
        chaos.heal_all()
        assert fleet.wait_active("r1", timeout_s=10)
        fleet.close()


def test_straggler_is_evicted(toy_artifact):
    fleet = make_fleet(toy_artifact, n=3)
    try:
        for _ in range(4):
            fleet.monitor.beat("r0", step_time_s=0.01)
            fleet.monitor.beat("r1", step_time_s=0.01)
            fleet.monitor.beat("r2", step_time_s=5.0)
        assert wait_until(lambda: fleet.replicas()["r2"].evictions >= 1)
        evs = [e for e in fleet._events.records(kind="replica.evict")
               if e.fields["replica"] == "r2"]
        assert evs and evs[0].fields["reason"] == "straggler"
    finally:
        fleet.close()


def test_deadline_exceeded_when_fleet_is_wedged(toy_artifact, oracle):
    from repro_torch.runtime import ChaosInjector, DeadlineExceeded

    xs, _ = oracle
    fleet = make_fleet(toy_artifact, n=1, request_deadline_s=0.3,
                       attempt_timeout_s=10.0, max_retries=100)
    chaos = ChaosInjector().attach(fleet)
    try:
        chaos.hang("r0")
        fut = fleet.submit(xs[0])
        with pytest.raises(DeadlineExceeded):
            fut.result(timeout=30)
        assert fleet.stats()["deadline_exceeded"] >= 1
    finally:
        chaos.heal_all()
        fleet.close()


# ----------------------------------------------------------- load shedding
def test_fleet_sheds_load_past_queue_bound(toy_artifact, oracle):
    from repro_torch.runtime import AdmissionError, ChaosInjector

    xs, wants = oracle
    fleet = make_fleet(toy_artifact, n=1, max_queue_per_replica=2)
    chaos = ChaosInjector().attach(fleet)
    try:
        chaos.slow("r0", 0.05)
        accepted, shed = [], 0
        for i, x in enumerate(xs):
            try:
                accepted.append((fleet.submit(x), i))
            except AdmissionError:
                shed += 1
        assert shed >= 1, "queue bound must shed some of the burst"
        assert accepted, "the bound must not shed everything"
        for fut, i in accepted:
            assert_bit_exact(fut.result(timeout=30), wants[i])
        assert fleet.stats()["rejected"] == shed
    finally:
        chaos.heal_all()
        fleet.close()


def test_no_active_replicas_rejects_not_hangs(toy_artifact, oracle):
    from repro_torch.runtime import AdmissionError, ChaosInjector

    xs, _ = oracle
    fleet = make_fleet(toy_artifact, n=2, request_deadline_s=2.0)
    chaos = ChaosInjector().attach(fleet)
    try:
        chaos.kill("r0")
        chaos.kill("r1")
        futs = []
        try:
            for x in xs[:8]:
                futs.append(fleet.submit(x))
        except AdmissionError:
            pass
        assert wait_until(lambda: not fleet.active_replicas())
        with pytest.raises(AdmissionError):
            fleet.submit(xs[0])
        for fut in futs:
            with pytest.raises(Exception):
                fut.result(timeout=30)
    finally:
        chaos.heal_all()
        fleet.close()


# ---------------------------------------------------------------- plumbing
def test_fleet_metrics_and_stats_shape(toy_artifact, oracle):
    from repro_torch.obs.metrics import MetricsRegistry

    xs, wants = oracle
    reg = MetricsRegistry()
    with make_fleet(toy_artifact, n=2, registry=reg) as fleet:
        for x, want in zip(xs[:4], wants[:4]):
            assert_bit_exact(fleet.submit(x).result(timeout=30), want)
        st = fleet.stats()
        assert st["submitted"] == 4 and st["completed"] == 4
        assert reg.get("fleet.submitted").value == 4
        assert reg.get("fleet.active_replicas").value == 2
        for rid in ("r0", "r1"):
            rs = st["replicas"][rid]
            assert rs["state"] == "active" and rs["strikes"] == 0
        assert any(h.step_ema > 0 for h in fleet.monitor.hosts.values())


def test_fleet_serve_metrics_scrapes(toy_artifact, oracle):
    import urllib.request

    from repro_torch.obs.export import find_samples, parse_openmetrics

    xs, wants = oracle
    with make_fleet(toy_artifact, n=2) as fleet:
        fleet.submit(xs[0]).result(timeout=30)
        with fleet.serve_metrics() as http:
            with urllib.request.urlopen(http.url("/metrics")) as r:
                fams = parse_openmetrics(r.read().decode())
    assert find_samples(fams, "fleet_completed")[0][2] == 1.0
    assert find_samples(fams, "fleet_active_replicas")[0][2] == 2.0


def _chaos_script(chaos, launch):
    """One scripted chaos run on replica r0: a poison armed after one
    healthy launch, a slow fault for two launches, a kill after three."""
    from repro_torch.runtime import ChaosError
    from repro.runtime import ChaosError as RefChaosError

    chaos.poison("r0", n_launches=2, after_launches=1)
    chaos.slow("r0", 0.0, n_launches=2, after_launches=3)
    outcomes = []
    for _ in range(6):
        try:
            launch()
            outcomes.append("ok")
        except (ChaosError, RefChaosError):
            outcomes.append("raised")
    chaos.kill("r0")
    try:
        launch()
    except (ChaosError, RefChaosError):
        outcomes.append("killed")
    return outcomes


def test_chaos_log_is_deterministic_and_equals_the_reference(toy_artifact):
    """The same chaos script through the port's fleet and through the
    reference's injector on a bare launch hook: the same log, in order."""
    from repro.runtime.chaos import ChaosInjector as RefChaos
    from repro_torch.runtime import ChaosInjector

    fleet = make_fleet(toy_artifact, n=1)
    chaos = ChaosInjector().attach(fleet)
    try:
        sess = fleet.replicas()["r0"].session
        x = np.zeros((1,) + tuple(sess.graph.shape("data"))[1:], np.int8)
        got = _chaos_script(chaos, lambda: sess._launch(x))
    finally:
        chaos.heal_all()
        fleet.close()
    ref = RefChaos(sleep=lambda s: None)
    hook = ref._hook("r0")
    want = _chaos_script(ref, lambda: hook(x))
    assert got == want == ["ok", "raised", "raised", "ok", "ok", "ok",
                           "killed"]
    assert chaos.log == ref.log
    assert [e["kind"] for e in chaos.log] == ["poison", "poison", "slow",
                                              "slow", "kill"]
    assert [e["launch"] for e in chaos.log] == [2, 3, 4, 5, 7]


def test_fleet_defaults_to_cuda_and_raises_without_it(toy_artifact,
                                                      monkeypatch):
    import torch

    from repro_torch.runtime import Fleet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Fleet(toy_artifact, n_replicas=2)


# ---------------------------------------------------------------- health
class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def test_heartbeat_timeout_and_revival():
    from repro_torch.distributed.health import HeartbeatMonitor

    clk = FakeClock()
    mon = HeartbeatMonitor(timeout_s=10.0, clock=clk)
    mon.beat("a")
    mon.beat("b")
    clk.advance(9.0)
    mon.beat("b")
    assert mon.dead() == []
    clk.advance(2.0)
    assert mon.dead() == ["a"]
    mon.beat("a")
    assert mon.dead() == []


def test_heartbeat_forget_drops_all_state():
    from repro_torch.distributed.health import HeartbeatMonitor

    clk = FakeClock()
    mon = HeartbeatMonitor(timeout_s=1.0, clock=clk)
    mon.beat("a", step_time_s=5.0)
    clk.advance(100.0)
    mon.forget("a")
    assert mon.dead() == []
    assert "a" not in mon.hosts
    mon.forget("a")


def test_step_ewma_first_beat_seeds_then_blends():
    from repro_torch.distributed.health import HeartbeatMonitor

    mon = HeartbeatMonitor(clock=FakeClock())
    mon.beat("a", step_time_s=1.0)
    assert mon.hosts["a"].step_ema == pytest.approx(1.0)
    mon.beat("a", step_time_s=2.0)
    assert mon.hosts["a"].step_ema == pytest.approx(1.2)


def test_straggler_needs_three_samples_and_beats_median():
    from repro_torch.distributed.health import HeartbeatMonitor

    mon = HeartbeatMonitor(clock=FakeClock())
    mon.beat("a", step_time_s=1.0)
    mon.beat("b", step_time_s=10.0)
    assert mon.stragglers(1.5) == []
    mon.beat("c", step_time_s=1.0)
    assert mon.stragglers(1.5) == ["b"]
    assert mon.stragglers(20.0) == []
    mon.beat("d")
    assert mon.stragglers(1.5) == ["b"]


def test_heartbeat_schedule_equals_the_reference():
    """One beat schedule on a fake clock through both packages' monitors:
    the same dead set, EWMAs and stragglers after every step."""
    from repro.distributed.health import HeartbeatMonitor as RefMonitor
    from repro_torch.distributed.health import HeartbeatMonitor

    clk = FakeClock()
    ref, port = (RefMonitor(timeout_s=3.0, clock=clk),
                 HeartbeatMonitor(timeout_s=3.0, clock=clk))
    rng = np.random.default_rng(0)
    hosts = ["h0", "h1", "h2", "h3"]
    for step in range(40):
        clk.advance(float(rng.uniform(0.1, 1.5)))
        for h in hosts:
            if rng.random() < 0.6:
                st = float(rng.exponential(1.0 + 3 * (h == "h3")))
                ref.beat(h, st)
                port.beat(h, st)
        assert port.dead() == ref.dead()
        assert port.stragglers(1.5) == ref.stragglers(1.5)
        assert {h: s.step_ema for h, s in port.hosts.items()} == \
            {h: s.step_ema for h, s in ref.hosts.items()}


def test_retry_policy_and_restart_loop():
    from repro_torch.distributed.health import RetryPolicy, run_with_retries

    clk = FakeClock()
    pol = RetryPolicy(max_restarts=2, window_s=100.0, clock=clk)
    assert pol.should_retry()
    pol.record()
    pol.record()
    assert not pol.should_retry()
    clk.advance(101.0)
    assert pol.should_retry()

    class Store:
        saved = None

        def restore_latest(self, abstract_state, device=None, *,
                           placements=None):    # the port store's call
            return self.saved

    store, attempts = Store(), []

    def run_fn(state, start):
        attempts.append((state, start))
        if len(attempts) < 3:
            store.saved = ({"w": len(attempts)}, 10 * len(attempts))
            raise RuntimeError("host lost")
        return state, True

    state, done = run_with_retries(lambda: {"w": 0}, run_fn, store,
                                   RetryPolicy(max_restarts=5, clock=clk),
                                   abstract_state=None)
    assert done and state == {"w": 2}
    assert attempts == [({"w": 0}, 0), ({"w": 1}, 10), ({"w": 2}, 20)]
