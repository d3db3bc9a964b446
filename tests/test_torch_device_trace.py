"""Device time in the port's tracer (CPU, with fake events): the device
clock's anchor, device spans pending until their end completes and resolved
without blocking, the batcher's completion-based records, the executor's
item spans, and the benchmark's readers of them."""
import math
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import harness, work
from repro_torch.core.executor import Int8Executor
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.core.lower import FusedLaunch
from repro_torch.kernels.conv_fused import ops as fused_ops
from repro_torch.obs.trace import (REANCHOR_IDLE_S, REANCHOR_MAX_S, TRACER,
                                   HostMark, Tracer)
from repro_torch.runtime.batching import DynamicBatcher
from torch_common import port_model, strategy


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class FakeDevice:
    """A stream of work with its own time: events record ``now``, complete
    once ``done`` reaches them, and waiting for one completes it (unless
    waiting is forbidden, to show a reader never blocks)."""

    def __init__(self):
        self.now, self.done = 0.0, -1.0
        self.drains = 0
        self.may_wait = True
        self.busy = False               # never idle, as under full load

    def record(self):
        return FakeEvent(self, self.now)

    def drain(self):
        self.drains += 1
        self.done = max(self.done, self.now)

    def idle(self) -> bool:
        return not self.busy and self.done >= self.now

    def fns(self):
        return self.record, self.drain, self.idle


class FakeEvent:
    def __init__(self, dev: FakeDevice, t: float):
        self.dev, self.t = dev, t

    def query(self) -> bool:
        return self.t <= self.dev.done

    def synchronize(self) -> None:
        if not self.dev.may_wait:
            raise AssertionError("waited for the device")
        self.dev.done = max(self.dev.done, self.t)

    def elapsed_time(self, other: "FakeEvent") -> float:
        assert self.query() and other.query()
        return (other.t - self.t) * 1e3


def _fake_tracer(dev: FakeDevice, host: FakeClock) -> Tracer:
    return Tracer(clock=host, registry=MetricsRegistry(),
                  event_factory=lambda d: (dev.fns() if str(d) == "cuda:0"
                                           else None))


def test_device_span_is_anchored_pending_and_resolved_without_blocking():
    dev, host = FakeDevice(), FakeClock(100.0)
    tr = _fake_tracer(dev, host)
    tr.enable()
    dev.now = 5.0
    with tr.device_span("item0:chain:conv1", "cuda:0", kind="chain"):
        dev.now = 5.002                 # the span's work, on the device
    assert dev.drains == 1              # the first mark took the anchor
    dev.may_wait = False
    assert tr.records() == []           # pending: its end has not completed
    dev.done = 5.01
    (rec,) = tr.records()
    assert rec.track == "device" and rec.args == {"kind": "chain"}
    assert rec.start == pytest.approx(100.0)
    assert rec.end == pytest.approx(100.002)
    assert tr.records() == [rec]        # recorded once

    # enabling again re-anchors; a mark keeps the anchor it was taken under
    old = tr.mark("cuda:0")             # device 5.002 under the first anchor
    tr.disable()
    dev.may_wait, dev.now, host.t = True, 50.0, 200.0
    tr.enable()
    assert dev.drains == 2
    assert old.seconds() == pytest.approx(100.002)
    dev.now = 50.5
    with tr.device_span("late", "cuda:0"):
        pass
    dev.done = 51.0
    late = [r for r in tr.records() if r.name == "late"]
    assert late[0].start == pytest.approx(200.5)


def test_host_device_spans_context_tags_and_chrome_origin():
    dev, host = FakeDevice(), FakeClock(10.0)
    tr = _fake_tracer(dev, host)
    assert tr.device_span("off", "cpu") is tr.span("off")   # both no-ops
    assert isinstance(tr.mark("cpu"), HostMark)
    tr.enable()
    with tr.context(batch_id=7):
        with tr.device_span("batch", "cpu", n=2):
            host.t = 10.25
        with tr.span("pad", track="batch", batch_id=8):
            pass
    with tr.span("after", track="batch"):
        pass
    assert dev.drains == 0              # nothing marked the fake card
    recs = {r.name: r for r in tr.records()}
    assert recs["batch"].duration == pytest.approx(0.25)
    assert recs["batch"].args == {"batch_id": 7, "n": 2}
    assert recs["pad"].args == {"batch_id": 8}      # a span's own arg wins
    assert recs["after"].args == {}
    chrome = tr.to_chrome()
    assert chrome["otherData"]["origin_s"] == pytest.approx(10.0)
    ts = [e["ts"] for e in chrome["traceEvents"] if e["ph"] == "X"]
    assert min(ts) == 0.0


def test_refresh_takes_the_anchor_again_once_it_is_old():
    dev, host = FakeDevice(), FakeClock()
    tr = _fake_tracer(dev, host)
    tr.refresh("cuda:0")                # no anchor yet: nothing to refresh
    tr.refresh("cpu")                   # the host clock times the CPU
    clock = tr.device_clock("cuda:0")
    assert clock._anchor is None
    tr.mark("cuda:0")                   # the first mark anchors (drained)
    anchored = lambda: clock._anchor[1]     # noqa: E731
    assert (dev.drains, anchored()) == (1, 0.0)
    host.t = dev.now = REANCHOR_IDLE_S / 2
    tr.refresh("cuda:0")                # young
    host.t = dev.now = REANCHOR_IDLE_S
    dev.busy = True
    tr.refresh("cuda:0")                # old, but work is queued
    assert anchored() == 0.0
    dev.busy, dev.done = False, dev.now
    tr.refresh("cuda:0")                # old and idle: anchored, not drained
    assert (dev.drains, anchored()) == (1, REANCHOR_IDLE_S)
    dev.busy = True
    host.t = dev.now = REANCHOR_IDLE_S + REANCHOR_MAX_S
    tr.refresh("cuda:0")                # too old to wait for an idle moment
    assert (dev.drains, anchored()) == (1, REANCHOR_IDLE_S + REANCHOR_MAX_S)


class LateEvent:
    """An event whose completion the host sees ``lag`` seconds after its
    record, as when another thread's copy slipped in ahead of it."""

    def __init__(self, host: FakeClock, lag: float):
        self.host, self.lag = host, lag

    def query(self) -> bool:
        self.host.t += self.lag
        return True

    def synchronize(self) -> None:
        pass


def test_an_anchor_seen_late_is_not_taken():
    from repro_torch.obs.trace import ANCHOR_SLACK_S, ANCHOR_TRIES, DeviceClock

    host, lags = FakeClock(), []

    def record():
        return LateEvent(host, lags.pop(0))

    clock = DeviceClock(record, lambda: None, lambda: True, clock=host)
    lags[:] = [3 * ANCHOR_SLACK_S, 2 * ANCHOR_SLACK_S] + [
        5 * ANCHOR_SLACK_S] * (ANCHOR_TRIES - 2)
    clock.anchor()                      # the first anchor: the closest try
    first = clock._anchor
    assert first[1] == pytest.approx(3 * ANCHOR_SLACK_S) and not lags
    lags[:] = [2 * ANCHOR_SLACK_S] * ANCHOR_TRIES
    clock.anchor(drain=False)           # every try late: the old one stays
    assert clock._anchor is first
    lags[:] = [2 * ANCHOR_SLACK_S, ANCHOR_SLACK_S / 2]
    t = host.t
    clock.anchor(drain=False)           # the second try is close: taken
    assert clock._anchor[1] == pytest.approx(t + 2 * ANCHOR_SLACK_S)
    assert not lags


RATE = 8e-6         # the fake card's clock runs 8 us a second slow
WORK_S = 0.04       # a batch's time on the card


@pytest.mark.parametrize("busy,gap_s", [(False, 120.0), (True, 7.0)],
                         ids=["idle_between_batches", "never_idle"])
def test_completion_latencies_keep_to_the_host_clock_over_long_uptimes(
        busy, gap_s):
    """A server that answers one request every ``gap_s`` for 300 requests
    (10 hours idle between batches; 35 minutes of a card that is never
    idle) on a card whose clock drifts: every ``latency_s`` stays within
    the drift over one anchor's life of the batch's true time, where
    anchoring once would be off by 0.3 s and 17 ms by the end."""
    dev, host = FakeDevice(), FakeClock()
    dev.busy = busy
    tr = _fake_tracer(dev, host)
    seen = []

    def run_batch(xs):
        tr.refresh("cuda:0")            # as Session.run_batch does
        host.t += WORK_S
        dev.now = host.t * (1 - RATE)
        return list(xs)

    def mark_done():
        m = tr.mark("cuda:0")
        dev.done = dev.now              # the card has finished the batch
        return m

    tr.mark("cuda:0")                   # the server's warm-up anchors
    b = DynamicBatcher(run_batch, max_batch=1, max_latency_s=0.0,
                       clock=host, registry=MetricsRegistry(), tracer=tr,
                       observers=[seen.append], mark_done=mark_done)
    try:
        for k in range(300):
            host.t += gap_s
            dev.now = host.t * (1 - RATE)
            assert b.submit(k).result(timeout=5) == k
            assert _until(lambda: len(seen) == k + 1)
    finally:
        b.close()
    # an anchor's age at a completion: the batch's work where each batch
    # finds the card idle, else up to the longest life of an anchor
    life = REANCHOR_MAX_S if busy else 0.0
    bound = RATE * (life + WORK_S) + 1e-9
    assert max(abs(r["latency_s"] - WORK_S) for r in seen) <= bound
    assert b.latencies[-1] == seen[-1]["latency_s"]
    assert dev.drains == 1              # only the warm-up drained the card


def test_pending_device_spans_stay_bounded_when_nobody_reads():
    dev, host = FakeDevice(), FakeClock()
    tr = Tracer(capacity=4, clock=host, registry=MetricsRegistry(),
                event_factory=lambda d: dev.fns())
    tr.enable()
    for i in range(10):
        dev.now = float(i + 1)
        with tr.device_span(f"s{i}", "cuda:0"):
            pass
    assert len(tr._pending) <= 4
    dev.done = 100.0
    assert [r.name for r in tr.records()][-1] == "s9"


class Mark:
    """A completion mark the test completes by hand."""

    def __init__(self):
        self.done, self.t = False, None

    def query(self) -> bool:
        return self.done

    def wait(self) -> None:
        if not self.done:
            self.done, self.t = True, time.monotonic()

    def seconds(self) -> float:
        return self.t


def _until(cond, timeout_s: float = 5.0) -> bool:
    end = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < end:
        time.sleep(1e-3)
    return cond()


def test_batcher_records_end_at_the_devices_completion():
    marks, seen, again = [], [], []
    tr = Tracer(enabled=True, registry=MetricsRegistry())
    reg = MetricsRegistry()

    def mark_done():
        marks.append(Mark())
        return marks[-1]

    t_start = time.monotonic()
    b = DynamicBatcher(lambda xs: [2 * x for x in xs], max_batch=2,
                       max_latency_s=0.0, registry=reg, tracer=tr,
                       observers=[seen.append, again.append],
                       mark_done=mark_done)
    futs = [b.submit(i) for i in range(2)]
    # futures resolve at enqueue, before the device has finished
    assert [f.result(timeout=5) for f in futs] == [0, 2]
    assert _until(lambda: len(marks) == 1)
    time.sleep(5e-3)
    assert seen == [] and not b.latencies and b.n_served == 0
    marks[0].t, marks[0].done = time.monotonic(), True
    assert _until(lambda: len(seen) == 2)
    for rec in seen:
        assert rec["done_s"] == marks[0].t
        assert rec["latency_s"] == rec["done_s"] - rec["submit_s"]
        assert rec["queue_wait_s"] >= 0 and rec["execute_s"] >= 0
    assert list(b.latencies) == [r["latency_s"] for r in seen]
    assert list(b.queue_waits) == [r["queue_wait_s"] for r in seen]
    assert reg.histogram("serve.latency_ms").count == 2

    futs = [b.submit(i) for i in range(2, 5)]
    assert [f.result(timeout=5) for f in futs] == [4, 6, 8]
    b.close()                           # completes every batch in flight
    assert not b._worker.is_alive()
    assert all(m.done for m in marks) and len(marks) == 3
    assert [r["req_id"] for r in seen] == [1, 2, 3, 4, 5]
    assert again == seen and b.n_served == 5
    assert reg.histogram("serve.latency_ms").count == 5

    spans = tr.records()
    assert not [s for s in spans if s.track.startswith("req")]
    assert {s.track for s in spans} == {"batch"}
    assert all("batch_id" in s.args for s in spans)
    by = {}
    for s in spans:
        by.setdefault(s.args["batch_id"], {})[s.name] = s
    assert sorted(by) == [1, 2, 3]
    prev_end = t_start
    for bid in sorted(by):
        sp = by[bid]
        assert set(sp) == {"batch_form", "batch_execute", "resolve",
                           "complete"}
        # batch_form: the worker's own wait, after it finished the previous
        # batch's launch and futures, up to the batch's formation
        assert prev_end <= sp["batch_form"].start <= sp["batch_form"].end
        assert sp["batch_form"].end == sp["batch_execute"].start
        assert sp["batch_execute"].end <= sp["resolve"].start
        prev_end = sp["resolve"].end


def test_batcher_without_a_mark_completes_at_the_executors_return():
    seen = []
    b = DynamicBatcher(lambda xs: list(xs), max_batch=4, max_latency_s=0.0,
                       registry=MetricsRegistry(),
                       tracer=Tracer(registry=MetricsRegistry()),
                       observers=[seen.append])
    try:
        assert b.submit(1).result(timeout=5) == 1
        # recorded before the future resolved, as the CPU path always was
        assert len(b.latencies) == 1 and len(seen) == 1
        rec = seen[0]
        assert rec["done_s"] == pytest.approx(
            rec["submit_s"] + rec["queue_wait_s"] + rec["execute_s"])
    finally:
        b.close()


class HeldMark(Mark):
    """A completion mark whose ``wait`` blocks until the test releases it."""

    def __init__(self):
        super().__init__()
        self.released = threading.Event()

    def query(self) -> bool:
        return self.released.is_set()

    def wait(self) -> None:
        self.released.wait(timeout=10)
        self.t = time.monotonic()

    def seconds(self) -> float:
        return self.t


def test_a_failed_batch_reaches_observers_after_the_batches_before_it():
    """An ok batch still on the device when the next batch fails: the
    observers see the ok batch's records first, the failure's after, and
    the failed batch's records carry the id its spans carry."""
    marks, seen = [], []
    tr = Tracer(enabled=True, registry=MetricsRegistry())

    def run_batch(xs):
        if xs[0] < 0:
            raise ValueError("poisoned")
        return list(xs)

    def mark_done():
        marks.append(HeldMark())
        return marks[-1]

    b = DynamicBatcher(run_batch, max_batch=1, max_latency_s=0.0,
                       registry=MetricsRegistry(), tracer=tr,
                       observers=[seen.append], mark_done=mark_done)
    try:
        assert b.submit(1).result(timeout=5) == 1       # enqueued, in flight
        bad = b.submit(-1)
        time.sleep(5e-3)
        assert seen == [] and not bad.done()    # waits for the batch before
        marks[0].released.set()
        with pytest.raises(ValueError):
            bad.result(timeout=5)
        assert [(r["batch_id"], r["status"]) for r in seen] == [
            (1, "ok"), (2, "error")]
        assert seen[1]["error"] == "ValueError: poisoned"
        with pytest.raises(ValueError):         # a second failure: its own id
            b.submit(-2).result(timeout=5)
        assert b.submit(3).result(timeout=5) == 3
        marks[1].released.set()
    finally:
        b.close()
    assert [(r["batch_id"], r["status"]) for r in seen] == [
        (1, "ok"), (2, "error"), (3, "error"), (4, "ok")]
    assert b.n_served == 2 and len(b.latencies) == 2
    forms = {s.args["batch_id"] for s in tr.records()
             if s.name == "batch_form"}
    assert forms == {1, 2, 3, 4}


def test_session_refreshes_the_device_clock_before_each_batch(monkeypatch):
    from repro_torch.hw import ZU2
    from repro_torch.runtime import Session

    g, qm, xq = port_model("toy", 16)
    sess = Session(g, strategy("repro_torch", g), ZU2, qm, device="cpu")
    seen = []
    monkeypatch.setattr(TRACER, "refresh", seen.append)
    sess.run_batch([xq[:1], xq[:1]])
    sess.run_batch([xq[:1]])
    assert seen == [sess.device, sess.device]


@pytest.fixture(scope="module")
def vgg_executor():
    g, qm, xq = port_model("vgg16", 32)
    ex = Int8Executor(g, qm, strategy=strategy("repro_torch", g),
                      backend="fused", device="cpu")
    return ex, np.concatenate([xq, xq])


def test_executor_items_are_profiler_ranges_and_device_spans(vgg_executor):
    ex, x = vgg_executor
    from torch.profiler import ProfilerActivity, profile

    items = ex.program.items
    TRACER.clear()
    TRACER.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with TRACER.context(batch_id=4):
                ex(x)
        spans = [r for r in TRACER.records() if r.track == "device"]
    finally:
        TRACER.disable()
        TRACER.clear()
    names = [f"item{i}:{it.kind if hasattr(it, 'kind') else 'fallback'}:"
             f"{it.nodes[0]}" for i, it in enumerate(items)]
    ranges = [e.name for e in prof.events() if e.name.startswith("item")]
    assert sorted(ranges) == sorted(names)
    assert [s.name for s in spans] == names
    for i, (s, it) in enumerate(zip(spans, items)):
        kind = getattr(it, "kind", "fallback")
        out = getattr(it, "out_name", "") or it.nodes[-1]
        plan = {}
        if kind == "chain":     # the planner's images a block and bytes
            plan = fused_ops.launch_plan_args(
                it, (2,) + tuple(ex.g.shape(it.in_name)[1:]),
                [ex.g.shape(st[1])[3] for st in it.stages
                 if st[0] == "conv"])
            assert plan["ni"] in (1, 2) and plan["w_fetch_bytes"] >= 0
            assert (plan["w_fetch_bytes"] > 0) == any(
                st[0] == "conv" for st in it.stages)
        assert s.args == {"batch_id": 4, "index": i, "kind": kind,
                          "out": out, "batch": 2, **plan}
        assert s.duration >= 0
    assert {s.args["kind"] for s in spans} == {"chain", "fallback"}

    # disabled: neither ranges nor spans
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ex(x)
    assert not [e for e in prof.events() if e.name.startswith("item")]
    assert TRACER.records() == []


def test_a_launch_span_encloses_the_kernel_alone(vgg_executor, monkeypatch):
    """``run_launch`` opens the item's span once, around the kernel (here
    its plain version) and after the launch's preparation."""
    ex, x = vgg_executor
    item, prep = next((it, p) for it, p in zip(ex.program.items,
                                               ex._prepared)
                      if isinstance(it, FusedLaunch))

    class Spy:
        entered, open = 0, False

        def __enter__(self):
            self.entered += 1
            self.open = True

        def __exit__(self, *exc):
            self.open = False

    spy, inside = Spy(), []
    plain = fused_ops.fused_chain_plain

    def watched(*a, **kw):
        inside.append(spy.open)
        return plain(*a, **kw)
    monkeypatch.setattr(fused_ops, "fused_chain_plain", watched)
    env = {item.in_name: torch.from_numpy(x)}
    out = fused_ops.run_launch(item, env, prepared=prep, span=spy)
    assert spy.entered == 1 and inside == [True] and not spy.open
    assert list(out) == [item.out_name]


# ----------------------------------------------------------------- readers
PEAK = {"int8_ops_per_s": 1e12, "bytes_per_s": 1e9}
SHAPES = {"x": (2, 2, 4), "h": (1, 1, 8)}
WEIGHTS = {"c1": (3, 3, 4, 8), "fc": (1, 1, 8, 4)}


def _launch(out, hw, stage):
    return SimpleNamespace(kind="chain", out_name=out, out_hw=hw,
                           in_name="x" if out == "h" else "h", sides=(),
                           fc_reshape=False, stages=(stage,))


CONV = _launch("h", (2, 2), ("conv", "c1", 3, 3, 1, 1, 1, 1, 1, 1, 0, True,
                            2, 2))
FC = _launch("o", (1, 1), ("conv", "fc", 1, 1, 1, 1, 0, 0, 1, 1, 0, False,
                          1, 1))


def _run(batches=(2, 2), peak=PEAK, records=()):
    return harness.Run(
        images_per_s=0.0, records=list(records), counts={}, trace={},
        traced_batches=list(batches), launches=[CONV, FC],
        shape=SHAPES.__getitem__, wshape=WEIGHTS.__getitem__, peak=peak,
        model_ops=0, calibrate_s=0.0, compile_s=0.0)


@pytest.fixture
def item_spans():
    """Two traced calls of the two launches and a fallback, as the
    executor records them: conv 3 ms, fc 1 ms a call."""
    TRACER.clear()
    TRACER.enable()
    t = 0.0
    for call in range(2):
        for i, (kind, out, dur) in enumerate([("chain", "h", 3e-3),
                                              ("chain", "o", 1e-3),
                                              ("fallback", "p", 5e-4)]):
            TRACER.add_span(f"item{i}", t, t + dur, track="device",
                            args={"index": i, "kind": kind, "out": out,
                                  "batch": 2, "batch_id": call})
            t += dur
    TRACER.disable()
    yield
    TRACER.clear()


def _reader(name):
    from portbench import cells
    return cells.reader(name)


def test_chain_rooflines_split_the_chain_launches(item_spans):
    fc, conv = _reader("chain_fc_roofline"), _reader("chain_conv_roofline")
    least_fc = work.least_seconds(*work.chain_work(
        FC, SHAPES.__getitem__, WEIGHTS.__getitem__, 2), PEAK)
    least_conv = work.least_seconds(*work.chain_work(
        CONV, SHAPES.__getitem__, WEIGHTS.__getitem__, 2), PEAK)
    assert fc(_run()) == pytest.approx(100 * 2 * least_fc / 2e-3)
    assert conv(_run()) == pytest.approx(100 * 2 * least_conv / 6e-3)
    # the counts must be the launches' times the traced calls'
    assert fc(_run(batches=(2,))) is None
    assert conv(_run(batches=(2, 2, 2))) is None
    assert fc(_run(batches=())) is None
    assert conv(_run(peak=None)) is None


def test_chain_rooflines_read_nothing_without_item_spans():
    TRACER.clear()
    assert _reader("chain_fc_roofline")(_run()) is None
    assert _reader("chain_conv_roofline")(_run()) is None


def test_answer_p95_reads_completion_latencies():
    read = _reader("answer_p95_ms")
    recs = [{"latency_s": (i + 1) * 1e-3, "done_s": 1.0} for i in range(40)]
    assert read(_run(records=recs)) == pytest.approx(
        1e3 * sorted(r["latency_s"] for r in recs)[math.ceil(0.95 * 40) - 1])
    # records of a program whose latencies end at the enqueue
    assert read(_run(records=[{"latency_s": 1e-3}])) is None
    assert read(_run(records=[])) is None


def test_batcher_completion_is_thread_safe_under_many_clients():
    """Eight clients at once: every request gets one record, each after its
    batch's mark completed, and the latency windows hold every sample."""
    import sys

    seen = []
    marks = []
    lock = threading.Lock()

    def mark_done():
        m = Mark()
        m.done, m.t = True, time.monotonic()
        with lock:
            marks.append(m)
        return m

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        b = DynamicBatcher(lambda xs: list(xs), max_batch=8,
                           max_latency_s=1e-4, registry=MetricsRegistry(),
                           tracer=Tracer(registry=MetricsRegistry()),
                           observers=[seen.append], mark_done=mark_done)

        def client(k):
            for i in range(50):
                assert b.submit(k * 100 + i).result(timeout=10) == k * 100 + i

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        b.close()
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert sorted(r["req_id"] for r in seen) == list(range(1, 401))
    assert len(b.latencies) == 400 and b.n_served == 400
    assert all(r["done_s"] >= r["submit_s"] for r in seen)
