"""The device trace of a bounded run of executor calls, and what it shows.

``Profiled.hook`` is installed as the session's launch hook, which the
serving worker calls before each executor call.  Once armed, it drains the
card and has ``torch.profiler`` (CPU and CUDA activity) and the program's
``TRACER`` started before a call, lets ``n_calls`` calls run, and before the
next one drains the card again and has both stopped.  So the trace holds
those calls' device work whole and nothing launched before them, and the
batch size of each traced call is known.  A marker recorded as the profiler
starts ties the trace's clock to ``time.monotonic``, the clock of
``TRACER``'s spans.

``summarize`` reduces the exported trace: device busy seconds (the union of
kernel, copy and set intervals) over the window's seconds, device seconds
and events by kernel name, the longest operations for the breakdown, and the
longest idle gaps, each labelled with the innermost span of ``TRACER``'s
batch track (``batch_form``, ``batch_execute``, ``pad``, ``launch``,
``resolve``: what the serving worker was doing) at the gap's middle.
"""
from __future__ import annotations

import json
import threading
import time

import torch

MARK = "portbench.window_start"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
SETTLE_S = 0.05         # after the profiler starts, before the traced calls


def kernel_name(event: str) -> str:
    """A trace event's kernel name without return type, namespace, template
    arguments or parameters: ``void ns::chain_kernel<4>(Params)`` ->
    ``chain_kernel``."""
    head = event.replace("(anonymous namespace)::", "")
    head = head.split("(")[0].split("<")[0].strip()
    return head.split()[-1].split("::")[-1] if head else event


def warm_profiler(dev) -> None:
    """Start and stop the profiler once around a trivial kernel, so the
    tracing library's first start-up falls in set-up."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=dev).add_(1)
        torch.cuda.synchronize(dev)


class Profiled:
    """The profiler over ``n_calls`` consecutive executor calls.  The
    profiler has to start and stop in the thread that runs the load, so the
    worker, at a call boundary, drains the card and waits while that thread
    (in ``service``) starts or stops it."""

    def __init__(self, n_calls: int, dev):
        self.n_calls, self.dev = n_calls, dev
        # idle -> armed -> start -> on -> stop -> done; the worker sets
        # start and stop, the load's thread answers them
        self.state = "idle"
        self.batches: list = []     # batch size of each traced call
        self.prof = None
        self.t0 = self.t1 = None
        self.spans: list = []
        self._go = threading.Event()

    def arm(self) -> None:
        if self.state == "idle":
            self.state = "armed"

    @property
    def active(self) -> bool:
        """The load's thread has to poll ``service``."""
        return self.state in ("armed", "start", "on", "stop")

    def hook(self, x) -> None:
        """The session's launch hook: runs on the worker before a call."""
        if self.state == "armed":
            self._wait_for("start")
        if self.state == "on":
            if len(self.batches) == self.n_calls:
                self._wait_for("stop")
            else:
                self.batches.append(int(x.shape[0]))

    def _wait_for(self, state: str) -> None:
        self._drain()
        self._go.clear()
        self.state = state
        self._go.wait()

    def service(self) -> None:
        """Start or stop the profiler where the worker waits for it."""
        if self.state == "start":
            self._start()
            self.state = "on"
            self._go.set()
        elif self.state == "stop":
            self._stop()
            self._go.set()

    def _drain(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        from repro_torch.obs.trace import TRACER

        TRACER.clear()
        TRACER.enable()
        acts = [ProfilerActivity.CPU]
        if self.dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        if self.dev.type == "cuda":
            # the first kernel after the start can be missing from the
            # trace: let a kernel of our own be that one
            torch.ones(1, device=self.dev).add_(1)
            self._drain()
            time.sleep(SETTLE_S)
        self.t0 = time.monotonic()
        with record_function(MARK):
            pass

    def _stop(self) -> None:
        from repro_torch.obs.trace import TRACER

        self.t1 = time.monotonic()
        self.prof.stop()
        TRACER.disable()
        self.spans = TRACER.records()
        self.state = "done"

    def finish(self) -> None:
        """After the load: stop a trace that the window closed on."""
        if self.state in ("on", "stop"):
            self._drain()
            self._stop()
        self.state = "done"
        self._go.set()

    @property
    def complete(self) -> bool:
        return self.prof is not None and len(self.batches) == self.n_calls


def _union(intervals) -> tuple[float, list]:
    """Length of the union of sorted (start, end) intervals, and the union's
    pieces."""
    busy, pieces = 0.0, []
    for a, b in intervals:
        if pieces and a <= pieces[-1][1]:
            if b > pieces[-1][1]:
                busy += b - pieces[-1][1]
                pieces[-1][1] = b
        else:
            pieces.append([a, b])
            busy += b - a
    return busy, pieces


def summarize(path: str, prof: Profiled) -> dict:
    """Busy and window seconds, device seconds and events by kernel name,
    the breakdown's longest operations and idle gaps (all in seconds)."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    mark = next((e for e in events if e.get("name") == MARK
                 and e.get("ph") == "X"), None)
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"], e["cat"])
                 for e in events if e.get("ph") == "X"
                 and e.get("cat") in DEVICE_CATS)
    if not dev:
        return {}
    window_s = prof.t1 - prof.t0
    w0 = mark["ts"] if mark else dev[0][0]
    w1 = w0 + window_s * 1e6 if mark else dev[-1][1]
    if not mark:
        window_s = (w1 - w0) / 1e6
    dev = [e for e in dev if e[1] > w0 and e[0] < w1]
    busy, pieces = _union((max(a, w0), min(b, w1)) for a, b, _, _ in dev)
    seconds: dict = {}
    by_op: dict = {}
    count: dict = {}
    for a, b, name, cat in dev:
        if cat == "kernel":
            base = kernel_name(name)
            seconds[base] = seconds.get(base, 0.0) + (b - a) / 1e6
            count[base] = count.get(base, 0) + 1
        else:
            base = name
        by_op[base] = by_op.get(base, 0.0) + (b - a) / 1e6
    edges = [w0] + [x for p in pieces for x in p] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]
    def label(a: float, b: float) -> str:
        if not mark:
            return "unaligned"
        mid = (a + b) / 2
        t = prof.t0 + (mid - w0) / 1e6
        spans = [s for s in prof.spans
                 if s.track == "batch" and s.start <= t <= s.end]
        return (min(spans, key=lambda s: s.end - s.start).name if spans
                else "no batch span")

    return {
        "busy_s": busy / 1e6,
        "window_s": window_s,
        "kernel_s": seconds,
        "kernel_events": count,
        "device_ops": [[k, v] for k, v in sorted(
            by_op.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[label(a, b), g / 1e6] for g, a, b in gaps],
    }
