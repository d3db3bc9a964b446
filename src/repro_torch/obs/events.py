# Copied from src/repro/obs/events.py; imports point at repro_torch.
"""Structured, severity-levelled event log: the runtime's flight journal.

Metrics answer "how much", spans answer "where did the time go"; the event
log answers "what *happened*" — discrete, nameable state changes an operator
or an alerting loop cares about: a compile stage finished, a cache or zoo
entry was evicted, the SLO controller resized a tenant's batch cap, a drift
profiler tripped, an error budget started burning.  Every emission is an
:class:`Event` with a wall-clock timestamp (external log correlation), a
monotonic timestamp on the tracer's clock, and the name of the innermost
open span on the emitting thread — so an event line can be matched back to
the exact Chrome-trace span it happened inside.  Enabled tracers also get a
mirrored instant on an ``events`` track, putting the event markers in the
Perfetto view itself.

Buffering is bounded (a deque of the newest ``capacity`` events; the dropped
count is scrapeable as ``events.dropped``), emission is thread-safe and
cheap, and subscribers — the flight recorder's dump-on-alert hook, a test
asserting an eviction fired — are notified synchronously with exceptions
swallowed (an observability bug must never take down serving).

``to_jsonl`` writes the log in the one-JSON-object-per-line format the CI
artifact uploader and ``python -m repro_torch.obs.dump`` expect.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import threading
import time

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace

SEVERITIES = ("debug", "info", "warning", "error")
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}


@dataclasses.dataclass(frozen=True)
class Event:
    """One discrete occurrence.  ``ts`` is wall-clock epoch seconds; ``mono``
    is the tracer's monotonic clock (trace correlation); ``span`` names the
    innermost open span on the emitting thread, if any."""
    seq: int
    ts: float
    mono: float
    severity: str
    kind: str                  # dotted event name: "slo.resize", "zoo.evict"
    message: str
    span: str | None
    fields: dict

    def to_json(self) -> dict:
        return {"seq": self.seq, "ts": self.ts, "mono": self.mono,
                "severity": self.severity, "kind": self.kind,
                "message": self.message, "span": self.span,
                **({"fields": self.fields} if self.fields else {})}


class EventLog:
    """Thread-safe bounded event buffer with severity filtering, synchronous
    subscribers, and tracer correlation."""

    def __init__(self, capacity: int = 2048, *, registry=None, tracer=None,
                 wall_clock=time.time):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._buf: collections.deque = collections.deque(maxlen=capacity)
        self._subs: list = []
        self._lock = threading.Lock()
        self._seq = 0
        self.n_emitted = 0
        self._registry = registry
        self._tracer = tracer
        self._wall = wall_clock

    def _reg(self):
        if self._registry is None:
            self._registry = obs_metrics.REGISTRY
        return self._registry

    def _trc(self):
        if self._tracer is None:
            self._tracer = obs_trace.TRACER
        return self._tracer

    @property
    def n_dropped(self) -> int:
        return self.n_emitted - len(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    # --------------------------------------------------------------- emission
    def emit(self, kind: str, message: str = "", *, severity: str = "info",
             **fields) -> Event:
        """Record one event; returns it.  ``fields`` must be JSON-friendly
        (they land verbatim in the JSONL log and the dump snapshots)."""
        if severity not in _SEV_RANK:
            raise ValueError(f"unknown severity {severity!r}; "
                             f"have {SEVERITIES}")
        tr = self._trc()
        open_span = tr.current_span()
        with self._lock:
            self._seq += 1
            ev = Event(seq=self._seq, ts=self._wall(), mono=tr.clock(),
                       severity=severity, kind=kind, message=message,
                       span=(open_span.name if open_span is not None
                             else None),
                       fields=dict(fields))
            self._buf.append(ev)
            self.n_emitted += 1
            subs = list(self._subs)
        reg = self._reg()
        reg.counter("events.emitted", {"severity": severity}).inc()
        reg.gauge("events.dropped").set(self.n_dropped)
        # mirror into the trace: the event marker sits on an "events" track
        # next to the spans it correlates with
        tr.add_span(kind, ev.mono, ev.mono, cat="event", track="events",
                    args={"seq": ev.seq, "severity": severity, **fields})
        for fn in subs:
            try:
                fn(ev)
            except Exception:       # a broken subscriber must not stop serving
                pass
        return ev

    def subscribe(self, fn) -> None:
        """Register ``fn(event)`` to run synchronously on every emission."""
        with self._lock:
            self._subs.append(fn)

    def unsubscribe(self, fn) -> None:
        with self._lock:
            if fn in self._subs:
                self._subs.remove(fn)

    # ---------------------------------------------------------------- reading
    def records(self, *, min_severity: str | None = None,
                kind: str | None = None, n: int | None = None) -> list[Event]:
        """Newest-last snapshot, optionally filtered by minimum severity
        and/or kind prefix, truncated to the newest ``n``."""
        with self._lock:
            evs = list(self._buf)
        if min_severity is not None:
            floor = _SEV_RANK[min_severity]
            evs = [e for e in evs if _SEV_RANK[e.severity] >= floor]
        if kind is not None:
            evs = [e for e in evs
                   if e.kind == kind or e.kind.startswith(kind + ".")]
        if n is not None:
            evs = evs[-n:]
        return evs

    def snapshot(self, **kw) -> list[dict]:
        return [e.to_json() for e in self.records(**kw)]

    def to_jsonl(self, path: str, **kw) -> str:
        """Write the (filtered) log as JSON Lines; returns the path."""
        with open(path, "w") as f:
            for e in self.records(**kw):
                f.write(json.dumps(e.to_json()) + "\n")
        return path

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self.n_emitted = 0
            self._seq = 0


# Shared default log; runtime/compile wiring emits here unless handed its own.
EVENTS = EventLog()
