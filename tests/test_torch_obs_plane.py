"""The port's observability plane against the JAX package's: OpenMetrics
exposition + strict parser (documents byte-equal across the packages, each
parser reading the other's), the HTTP scrape endpoint, the flight
recorder's ring and trigger paths, event-log semantics, burn-rate window
math under synthetic schedules, the dump CLI, and the tracer's registry
gauges — the reference's ``tests/test_obs_plane.py`` on ``repro_torch``."""
import json
import urllib.request

import numpy as np
import pytest

from repro_torch.obs.events import EventLog
from repro_torch.obs.export import (CONTENT_TYPE, ObsHTTPServer, OpenMetricsError,
                              escape_label_value, find_samples,
                              parse_openmetrics, render_openmetrics,
                              sanitize_name)
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import MetricsRegistry, labeled, parse_labels
from repro_torch.obs.slo import BurnRateTracker
from repro_torch.obs.trace import Tracer


@pytest.fixture()
def reg():
    return MetricsRegistry()


@pytest.fixture()
def events(reg):
    return EventLog(registry=reg, tracer=Tracer(registry=reg))


# --------------------------------------------------------------- label plumbing
def test_parse_labels_round_trips_the_mangling_convention():
    name = labeled("serve.requests", {"model": "vgg16"})
    assert name == "serve.requests{model=vgg16}"
    assert parse_labels(name) == ("serve.requests", {"model": "vgg16"})
    assert parse_labels("plain") == ("plain", {})


def test_registry_labelled_indexes_per_label_value(reg):
    reg.counter("serve.rejected", {"model": "a"}).inc(2)
    reg.counter("serve.rejected", {"model": "b"}).inc(5)
    reg.counter("serve.rejected").inc()            # unlabelled variant
    by_model = reg.labelled("serve.rejected")
    assert by_model["a"].value == 2.0
    assert by_model["b"].value == 5.0
    assert by_model[None].value == 1.0
    assert reg.labelled("no.such.family") == {}


# ----------------------------------------------------------------- exposition
def test_render_golden_document(reg):
    reg.counter("serve.requests", {"model": "vgg16"}).inc(3)
    reg.gauge("serve.queue_depth").set(2)
    h = reg.histogram("lat.ms", [1.0, 10.0])
    h.observe(0.5)
    h.observe(5.0)
    h.observe(50.0)
    text = render_openmetrics(reg)
    assert text == (
        "# TYPE lat_ms histogram\n"
        'lat_ms_bucket{le="1.0"} 1\n'
        'lat_ms_bucket{le="10.0"} 2\n'
        'lat_ms_bucket{le="+Inf"} 3\n'
        "lat_ms_sum 55.5\n"
        "lat_ms_count 3\n"
        "# TYPE serve_queue_depth gauge\n"
        "serve_queue_depth 2\n"
        "# TYPE serve_requests counter\n"
        'serve_requests_total{model="vgg16"} 3\n'
        "# EOF\n")


def test_render_parse_round_trip_preserves_labels(reg):
    reg.counter("x", {"model": 'we"ird\\name'}).inc()
    reg.gauge("g", {"model": "line\nbreak"}).set(1.5)
    fams = parse_openmetrics(render_openmetrics(reg))
    assert find_samples(fams, "x", model='we"ird\\name')[0][2] == 1.0
    assert find_samples(fams, "g", model="line\nbreak")[0][2] == 1.5


def test_rendered_histogram_buckets_are_cumulative_and_monotone(reg):
    h = reg.histogram("h", [1.0, 2.0, 4.0], labels={"model": "m"})
    for v in (0.5, 1.5, 1.6, 3.0, 99.0):
        h.observe(v)
    fams = parse_openmetrics(render_openmetrics(reg))   # parser enforces both
    buckets = [v for n, ls, v in fams["h"]["samples"] if n == "h_bucket"]
    assert buckets == [1.0, 3.0, 4.0, 5.0]              # running totals
    assert find_samples(fams, "h", model="m")           # labels survived


def test_name_sanitization_and_escaping():
    assert sanitize_name("serve.latency_ms") == "serve_latency_ms"
    assert sanitize_name("9lives") == "_lives"
    assert escape_label_value('a"b\\c\nd') == 'a\\"b\\\\c\\nd'


def test_conflicting_family_types_refused(reg):
    reg.counter("thing", {"model": "a"})
    snap = reg.snapshot()
    snap["thing"] = {"type": "gauge", "value": 1.0}     # same family, gauge
    with pytest.raises(ValueError, match="conflicting types"):
        render_openmetrics(snap)


@pytest.mark.parametrize("doc,match", [
    ("# TYPE x counter\nx_total 1\n", "EOF"),
    ("x_total 1\n# EOF\n", "no preceding # TYPE"),
    ("# TYPE x counter\n# TYPE x counter\n# EOF\n", "declared twice"),
    ("# TYPE x histogram\nx_bucket 1\n# EOF\n", "without 'le'"),
    ('# TYPE x histogram\nx_bucket{le="1.0"} 5\nx_bucket{le="+Inf"} 3\n'
     "# EOF\n", "not cumulative"),
    ('# TYPE x histogram\nx_bucket{le="2.0"} 1\nx_bucket{le="1.0"} 2\n'
     'x_bucket{le="+Inf"} 2\n# EOF\n', "not increasing"),
    ('# TYPE x histogram\nx_bucket{le="1.0"} 1\n# EOF\n', "end at \\+Inf"),
    ('# TYPE x histogram\nx_bucket{le="+Inf"} 2\nx_count 3\n# EOF\n',
     "!= _count"),
    ('# TYPE x counter\nx_total{model=unquoted} 1\n# EOF\n', "not quoted"),
    ("# EOF\n# EOF\n", "before end"),
])
def test_strict_parser_rejects_malformed_documents(doc, match):
    with pytest.raises(OpenMetricsError, match=match):
        parse_openmetrics(doc)


# -------------------------------------------------------------- HTTP endpoint
def test_http_endpoint_serves_the_whole_plane(reg, events):
    flight = FlightRecorder(capacity=4, registry=reg, events=events)
    reg.counter("serve.requests", {"model": "m"}).inc()
    flight.record(req_id=1, tenant="m", latency_s=0.01)
    events.emit("unit.test", "hello", answer=42)
    with ObsHTTPServer(reg, flight=flight, events=events) as http:
        with urllib.request.urlopen(http.url("/metrics")) as r:
            assert r.headers["Content-Type"] == CONTENT_TYPE
            fams = parse_openmetrics(r.read().decode())
        assert find_samples(fams, "serve_requests", model="m")
        assert fams["obs_scrapes"]["samples"][0][2] == 1.0   # scrape counted
        fl = json.loads(urllib.request.urlopen(
            http.url("/flight")).read().decode())
        assert fl["records"][0]["req_id"] == 1
        lines = urllib.request.urlopen(
            http.url("/events")).read().decode().splitlines()
        assert any(json.loads(ln)["kind"] == "unit.test" for ln in lines)
        snap = json.loads(urllib.request.urlopen(
            http.url("/snapshot")).read().decode())
        assert set(snap) == {"metrics", "flight", "events", "trace"}
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(http.url("/nope"))


def test_dump_cli_scrapes_and_validates(reg, events, tmp_path):
    from repro_torch.obs import dump as obs_dump
    reg.counter("c").inc()
    with ObsHTTPServer(reg, events=events) as http:
        out = tmp_path / "snap.json"
        ejl = tmp_path / "events.jsonl"
        events.emit("dump.test")
        snap = obs_dump.main(["--url", http.url("/").rstrip("/"),
                              "--out", str(out),
                              "--events-jsonl", str(ejl)])
    assert snap["n_families"] >= 1
    assert json.loads(out.read_text())["scraped_from"].startswith("http://")
    assert any(json.loads(ln)["kind"] == "dump.test"
               for ln in ejl.read_text().splitlines())


# ------------------------------------------------------------ flight recorder
def test_flight_ring_is_bounded_and_evicts_oldest(reg, events):
    fr = FlightRecorder(capacity=3, registry=reg, events=events)
    for i in range(5):
        fr.record(req_id=i, tenant="m", latency_s=0.001)
    recs = fr.records()
    assert [r.req_id for r in recs] == [2, 3, 4]
    assert fr.n_recorded == 5
    assert reg.get("flight.records").value == 3.0


def test_flight_trigger_paths_and_rate_limit(reg, events, tmp_path):
    clock = FakeClock()
    fr = FlightRecorder(capacity=8, dump_dir=str(tmp_path), registry=reg,
                        events=events, min_interval_s=10.0, clock=clock)
    fr.set_context("m", slo_class="gold", target_p99_ms=10.0)
    # executor exception auto-dumps
    fr.record(req_id=1, tenant="m", status="error", error="Boom: x")
    # rejection records + dumps under its own reason
    fr.note_rejection("m", pending=9, bound=8)
    dumps = fr.dumps()
    assert [d["reason"] for d in dumps] == ["executor_exception",
                                            "admission_rejection"]
    assert dumps[0]["context"]["m"]["slo_class"] == "gold"
    assert dumps[1]["records"][-1]["status"] == "rejected"
    on_disk = sorted(p.name for p in tmp_path.iterdir())
    assert on_disk == ["flight-1-executor_exception.json",
                       "flight-2-admission_rejection.json"]
    # within min_interval_s the same reason is suppressed, others are not
    assert fr.trigger("executor_exception") is None
    assert reg.get("flight.dumps_suppressed").value == 1.0
    clock.t += 11.0
    assert fr.trigger("executor_exception") is not None
    # every dump emits a cross-referencing event
    kinds = [e.kind for e in events.records(kind="flight")]
    assert kinds == ["flight.dump"] * 3


def test_flight_bind_feeds_batcher_records_with_drift(reg, events):
    fr = FlightRecorder(capacity=4, registry=reg, events=events)
    state = {"aggregate": 0.2, "drifted": True}
    obs = fr.bind(tenant="m", drift_state=lambda: state)
    obs({"req_id": 7, "submit_s": 0.0, "queue_wait_s": 0.001,
         "execute_s": 0.002, "latency_s": 0.003, "batch_id": 1,
         "batch_size": 2, "batch_members": (7, 8), "status": "ok",
         "error": None})
    rec = fr.records()[-1]
    assert rec.tenant == "m" and rec.drift["drifted"] is True
    assert rec.batch_members == (7, 8)


# ------------------------------------------------------------------ event log
def test_event_log_severity_filter_capacity_and_span_correlation(reg):
    tr = Tracer(registry=reg)
    tr.enable()
    log = EventLog(capacity=3, registry=reg, tracer=tr)
    with pytest.raises(ValueError, match="unknown severity"):
        log.emit("x", severity="fatal")
    with tr.span("compiling", cat="test"):
        log.emit("inside", severity="debug")
    assert log.records()[-1].span == "compiling"
    log.emit("warn1", severity="warning")
    log.emit("err1", severity="error")
    log.emit("info1")                      # capacity 3: "inside" dropped
    assert len(log) == 3 and log.n_dropped == 1
    assert reg.get("events.dropped").value == 1.0
    assert [e.kind for e in log.records(min_severity="warning")] \
        == ["warn1", "err1"]
    assert reg.get("events.emitted{severity=warning}").value == 1.0
    # mirrored markers land on the trace's "events" track
    names = [s.name for s in tr.records() if s.track == "events"]
    assert set(names) >= {"inside", "warn1", "err1", "info1"}


def test_event_subscribers_are_notified_and_isolated(events):
    seen = []
    events.subscribe(lambda e: seen.append(e.kind))
    events.subscribe(lambda e: 1 / 0)      # broken subscriber is swallowed
    events.emit("tick")
    assert seen == ["tick"]
    events.unsubscribe(events._subs[1])
    events.emit("tock")
    assert seen == ["tick", "tock"]


def test_event_jsonl_round_trips(events, tmp_path):
    events.emit("a.b", "msg", severity="warning", n=3)
    path = events.to_jsonl(str(tmp_path / "ev.jsonl"))
    rec = json.loads(open(path).read().splitlines()[0])
    assert rec["kind"] == "a.b" and rec["fields"] == {"n": 3}
    assert rec["severity"] == "warning"


# ----------------------------------------------------------------- burn rates
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _tracker(reg, events, clock, **kw):
    kw.setdefault("budget", 0.01)
    kw.setdefault("fast_window_s", 30.0)
    kw.setdefault("slow_window_s", 300.0)
    kw.setdefault("alert_burn", 2.0)
    kw.setdefault("min_samples", 8)
    kw.setdefault("cooldown_s", 60.0)
    return BurnRateTracker(10.0, labels={"model": "m", "class": "gold"},
                           registry=reg, events=events, clock=clock, **kw)


def test_burn_rate_is_violation_fraction_over_budget(reg, events):
    clock = FakeClock()
    bt = _tracker(reg, events, clock)
    for i in range(10):                    # 2 of 10 violate -> 0.2/0.01 = 20x
        clock.t = float(i)
        bt.observe(100.0 if i < 2 else 1.0)
    rates = bt.burn_rates()
    assert rates["fast"] == pytest.approx(20.0)
    assert rates["slow"] == pytest.approx(20.0)
    assert rates["n_fast"] == 10
    g = reg.get("slo.burn_rate{class=gold,model=m,window=fast}")
    assert g is not None and g.value == pytest.approx(20.0)


def test_old_samples_age_out_of_the_fast_window(reg, events):
    clock = FakeClock()
    bt = _tracker(reg, events, clock, min_samples=4)
    for i in range(4):                     # all violations at t=0..3
        clock.t = float(i)
        bt.observe(100.0)
    clock.t = 100.0                        # fast window (30s) has moved on
    bt.observe(1.0)
    rates = bt.burn_rates()
    assert rates["n_fast"] == 1 and rates["fast"] == 0.0
    assert rates["n_slow"] == 5 and rates["slow"] > 0.0


def test_alert_requires_both_windows_min_samples_and_cooldown(reg, events):
    clock = FakeClock()
    bt = _tracker(reg, events, clock, min_samples=8, cooldown_s=60.0)
    fired = []
    bt.on_alert = lambda t, fast, slow: fired.append((fast, slow))
    # 7 violations: below min_samples, never fires
    for i in range(7):
        clock.t = float(i)
        assert not bt.observe(100.0)
    # 8th closes min_samples with both windows burning: fires once
    clock.t = 7.0
    assert bt.observe(100.0)
    assert bt.n_alerts == 1 and len(fired) == 1
    # still burning inside the cooldown: suppressed
    clock.t = 20.0
    assert not bt.observe(100.0)
    # keep the fast window populated; fires again once the cooldown passes
    for i in range(7):
        clock.t = 60.0 + i
        assert not bt.observe(100.0)       # n_fast < min_samples
    clock.t = 70.0
    assert bt.observe(100.0)
    assert bt.n_alerts == 2
    assert reg.get("slo.alerts{class=gold,model=m}").value == 2.0
    kinds = [e.kind for e in events.records(kind="slo")]
    assert kinds == ["slo.alert", "slo.alert"]
    assert events.records(kind="slo")[0].fields["model"] == "m"


def test_slow_window_vetoes_fast_transients(reg, events):
    clock = FakeClock()
    bt = _tracker(reg, events, clock, min_samples=4, cooldown_s=0.0)
    # long healthy history fills the slow window with zeros
    for i in range(200):
        clock.t = float(i)
        bt.observe(1.0)
    # a short burst of violations lights the fast window only
    for i in range(4):
        clock.t = 290.0 + i
        assert not bt.observe(100.0)       # slow window still diluted
    rates = bt.burn_rates()
    assert rates["fast"] >= 2.0                 # fast is hot...
    assert rates["slow"] < 2.0
    assert bt.n_alerts == 0                     # ...but nothing fired


def test_observer_skips_failed_requests(reg, events):
    clock = FakeClock()
    bt = _tracker(reg, events, clock)
    obs = bt.observer()
    obs({"status": "error", "latency_s": 9.9})
    assert bt.n_observed == 0
    obs({"status": "ok", "latency_s": 0.001})
    assert bt.n_observed == 1 and bt.n_violations == 0


def test_on_alert_exceptions_are_swallowed(reg, events):
    clock = FakeClock()
    bt = _tracker(reg, events, clock, min_samples=2, cooldown_s=0.0)
    bt.on_alert = lambda *a: 1 / 0
    clock.t = 0.0
    bt.observe(100.0)
    clock.t = 1.0
    assert bt.observe(100.0)               # alert fired despite broken hook


# --------------------------------------------------------------- tracer gauges
def test_tracer_exports_ring_occupancy_and_drop_gauges():
    reg = MetricsRegistry()
    tr = Tracer(capacity=2, registry=reg)
    tr.enable()
    for i in range(5):
        with tr.span(f"s{i}", cat="test"):
            pass
    assert reg.get("trace.spans").value == 2.0
    assert reg.get("trace.dropped").value == 3.0
    assert tr.n_dropped == 3
    tr.clear()
    assert reg.get("trace.spans").value == 0.0
    assert reg.get("trace.dropped").value == 0.0


# ------------------------------------------------------ across the packages
def _fill(metrics_mod):
    """The same registry content in one package's registry."""
    reg = metrics_mod.MetricsRegistry()
    reg.counter("serve.requests", {"model": "googlenet"}).inc(48)
    reg.counter("serve.requests", {"model": "resnet50"}).inc(16)
    reg.counter("serve.rejected", {"model": 'we"ird\\name'}).inc(2)
    reg.gauge("slo.burn_rate", {"class": "gold", "model": "googlenet",
                                "window": "fast"}).set(12.5)
    reg.gauge("drift.median_deviation", {"model": "googlenet"}).set(0.0625)
    reg.gauge("drift.tripped", {"model": "googlenet"}).set(0.0)
    reg.gauge("serve.queue_depth").set(3)
    h = reg.histogram("serve.latency_ms", [1.0, 10.0, 100.0],
                      labels={"model": "line\nbreak"})
    for v in (0.25, 5.0, 7.5, 250.0):
        h.observe(v)
    return reg


def test_rendered_documents_byte_equal_across_packages():
    from repro.obs import export as ref_export
    from repro.obs import metrics as ref_metrics
    from repro_torch.obs import metrics as port_metrics

    ref_doc = ref_export.render_openmetrics(_fill(ref_metrics))
    port_doc = render_openmetrics(_fill(port_metrics))
    assert port_doc == ref_doc
    assert port_doc.endswith("# EOF\n")


def test_each_parser_reads_the_other_packages_document():
    from repro.obs import export as ref_export
    from repro.obs import metrics as ref_metrics
    from repro_torch.obs import metrics as port_metrics

    ref_doc = ref_export.render_openmetrics(_fill(ref_metrics))
    port_doc = render_openmetrics(_fill(port_metrics))
    mine, theirs = parse_openmetrics(ref_doc), ref_export.parse_openmetrics(
        port_doc)
    assert mine == theirs
    assert find_samples(mine, "serve_requests", model="googlenet")[0][2] \
        == 48.0
    assert ref_export.find_samples(theirs, "slo_burn_rate",
                                   window="fast")[0][2] == 12.5


@pytest.mark.parametrize("doc,match", [
    ("# TYPE x counter\nx_total 1\n", "EOF"),
    ('# TYPE x histogram\nx_bucket{le="1.0"} 5\nx_bucket{le="+Inf"} 3\n'
     "# EOF\n", "not cumulative"),
    ('# TYPE x counter\nx_total{model=unquoted} 1\n# EOF\n', "not quoted"),
])
def test_both_parsers_reject_alike(doc, match):
    from repro.obs import export as ref_export
    with pytest.raises(ref_export.OpenMetricsError, match=match):
        ref_export.parse_openmetrics(doc)
    with pytest.raises(OpenMetricsError, match=match):
        parse_openmetrics(doc)


def test_burn_rates_equal_across_packages():
    """The same synthetic violation schedule, on a fake clock, through both
    packages' trackers: equal burn rates and alert decisions."""
    from repro.obs.events import EventLog as RefEventLog
    from repro.obs.metrics import MetricsRegistry as RefRegistry
    from repro.obs.slo import BurnRateTracker as RefTracker

    clocks = FakeClock(), FakeClock()
    kw = dict(labels={"model": "m", "class": "gold"}, budget=0.01,
              fast_window_s=30.0, slow_window_s=300.0, min_samples=4,
              cooldown_s=20.0)
    ref = RefTracker(10.0, registry=RefRegistry(), events=RefEventLog(),
                     clock=clocks[0], **kw)
    reg = MetricsRegistry()
    port = BurnRateTracker(10.0, registry=reg, events=EventLog(registry=reg),
                           clock=clocks[1], **kw)
    rng = np.random.default_rng(0)
    for i, lat in enumerate(rng.exponential(8.0, 200)):
        clocks[0].t = clocks[1].t = 0.5 * i
        assert port.observe(float(lat)) == ref.observe(float(lat))
    assert port.burn_rates() == ref.burn_rates()
    assert port.snapshot() == ref.snapshot()
    assert port.n_alerts == ref.n_alerts > 0


def test_server_endpoint_exposes_the_reference_families():
    """One toy request through each package's ``Server`` with labels and a
    flight recorder: the port's endpoint serves the same serving and flight
    metric families (name and type) as the reference's, ``/explain/<model>``
    and ``/flight`` answer, and closing the server closes the endpoint."""
    from repro import asm as ref_asm
    from repro.hw import ZU2 as REF_ZU2
    from repro.obs.export import parse_openmetrics as ref_parse
    from repro.obs.flight import FlightRecorder as RefFlight
    from repro.runtime import Session as RefSession
    from repro_torch import asm
    from repro_torch.hw import ZU2
    from repro_torch.runtime import Session
    from torch_common import port_model, reference_model, strategy

    g_ref, _, _, qm_ref, xq = reference_model("toy", 16)
    g, qm, _ = port_model("toy", 16)
    ref = RefSession(g_ref, strategy("repro", g_ref), REF_ZU2, qm_ref,
                     cache=ref_asm.PlanCache()).serve(
        labels={"model": "toy"}, flight=RefFlight(), warmup=False)
    port = Session(g, strategy("repro_torch", g), ZU2, qm, device="cpu",
                   cache=asm.PlanCache()).serve(
        labels={"model": "toy"}, flight=FlightRecorder(), warmup=False)
    docs = {}
    for side, srv, parse in (("ref", ref, ref_parse),
                             ("port", port, parse_openmetrics)):
        srv.submit(xq[0]).result(timeout=60)
        http = srv.serve_metrics()
        with urllib.request.urlopen(http.url("/metrics")) as r:
            docs[side] = parse(r.read().decode())
        if side == "port":
            explain = json.loads(urllib.request.urlopen(
                http.url("/explain/toy")).read().decode())
            flight = json.loads(urllib.request.urlopen(
                http.url("/flight")).read().decode())
            url = http.url("/metrics")
        srv.close()
    names = ("serve_requests", "serve_batches", "serve_errors",
             "serve_queue_depth", "serve_batch_size", "serve_latency_ms",
             "serve_queue_wait_ms", "serve_execute_ms", "flight_records")
    assert {k: docs["port"][k]["type"] for k in names} == \
        {k: docs["ref"][k]["type"] for k in names}
    assert find_samples(docs["port"], "serve_requests", model="toy")
    assert explain["model"] == "toy"
    assert flight["records"][-1]["tenant"] == "toy"
    with pytest.raises(OSError):
        urllib.request.urlopen(url, timeout=5)
