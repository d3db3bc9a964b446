# Copied from src/repro/obs/trace.py; imports point at repro_torch.
"""Structured tracing: thread-safe spans + Chrome-trace/Perfetto export.

The validation environment answers "is the output right"; this module answers
"where did the milliseconds go".  A :class:`Tracer` records :class:`SpanRecord`
entries — named, nestable time intervals on logical *tracks* grouped into
*processes* — into a bounded ring buffer (a long-running server must not grow
without bound; the newest spans win).  Spans come from three sources:

* ``tracer.span("pathsearch", cat="compile")`` — a context manager timing the
  enclosed code with the tracer's monotonic clock; nesting is tracked per
  thread, and a child inherits its parent's track so the compile pipeline
  (frontend -> pathsearch -> lower -> memory plan -> tile search -> assemble)
  renders as one stacked flame;
* ``tracer.add_span(...)`` — an externally-timed interval (the serving path
  computes queue-wait from the batcher's own timestamps after the fact);
* ``tracer.add_engine_windows(...)`` — the cycle simulator's per-engine
  occupancy timeline (``simulator.engine_windows`` /
  ``PipelineReport.engine_timeline``) rescaled to seconds, rendered as a
  parallel "modeled" process so the predicted engine overlap sits next to the
  measured wall time in one Perfetto view.

``to_chrome()`` emits the Chrome trace-event JSON (``ph:"X"`` complete events
in microseconds + ``ph:"M"`` process/thread name metadata), loadable by
Perfetto (https://ui.perfetto.dev) and ``chrome://tracing``.

The module-level :data:`TRACER` starts *disabled*: ``span()`` then returns a
shared no-op context manager and ``add_span`` returns immediately, so
instrumented hot paths pay one attribute check and nothing else.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One completed interval.  ``start``/``end`` are seconds on the tracer's
    clock; ``process``/``track`` place it on a Perfetto row; ``depth`` is the
    per-thread nesting level at record time (0 = top level)."""
    name: str
    start: float
    end: float
    cat: str = ""
    process: str = "measured"
    track: str = ""
    depth: int = 0
    args: dict = dataclasses.field(default_factory=dict)

    @property
    def duration(self) -> float:
        return self.end - self.start


class _NullSpan:
    """Shared do-nothing context manager for the disabled tracer."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **kw) -> None:
        pass


_NULL_SPAN = _NullSpan()


class _Span:
    """Live span handle: records itself into the tracer on ``__exit__``."""
    __slots__ = ("_tracer", "name", "cat", "process", "track", "args",
                 "_start", "_depth")

    def __init__(self, tracer: "Tracer", name: str, cat: str, process: str,
                 track: str | None, args: dict):
        self._tracer = tracer
        self.name, self.cat, self.process = name, cat, process
        self.track = track
        self.args = args

    def set(self, **kw) -> None:
        """Attach/override args while the span is open."""
        self.args.update(kw)

    def __enter__(self):
        stack = self._tracer._stack()
        if self.track is None:       # inherit the enclosing span's track
            self.track = (stack[-1].track if stack
                          else f"thread-{threading.current_thread().name}")
        self._depth = len(stack)
        stack.append(self)
        self._start = self._tracer.clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = self._tracer.clock()
        stack = self._tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self._tracer._record(SpanRecord(
            name=self.name, start=self._start, end=end, cat=self.cat,
            process=self.process, track=self.track, depth=self._depth,
            args=self.args))
        return False


class Tracer:
    """Thread-safe span recorder with a bounded ring buffer.

    ``capacity`` bounds retained spans; once full, recording a new span evicts
    the oldest (``n_dropped`` counts evictions).  ``clock`` must be monotonic;
    externally-timed spans (:meth:`add_span`) should use timestamps from the
    same clock or alignment across tracks is lost.
    """

    def __init__(self, capacity: int = 65536, clock=time.monotonic,
                 enabled: bool = False, registry=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.clock = clock
        self._enabled = enabled
        self._lock = threading.Lock()
        self._buf: list[SpanRecord | None] = [None] * capacity
        self._head = 0                  # next write position
        self._size = 0
        self.n_recorded = 0
        self._local = threading.local()
        # span-loss gauges, bound lazily on first record: ring occupancy and
        # drop count become scrapeable instead of living only inside the
        # Chrome export's otherData
        self._registry = registry
        self._g_spans = self._g_dropped = None

    # ----------------------------------------------------------- state
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    @property
    def n_dropped(self) -> int:
        return self.n_recorded - self._size

    def __len__(self) -> int:
        return self._size

    def clear(self) -> None:
        with self._lock:
            self._buf = [None] * self.capacity
            self._head = self._size = 0
            self.n_recorded = 0
        if self._g_spans is not None:
            self._g_spans.set(0)
            self._g_dropped.set(0)

    # ----------------------------------------------------------- recording
    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _record(self, rec: SpanRecord) -> None:
        with self._lock:
            self._buf[self._head] = rec
            self._head = (self._head + 1) % self.capacity
            self._size = min(self._size + 1, self.capacity)
            self.n_recorded += 1
            size, dropped = self._size, self.n_recorded - self._size
        if self._g_spans is None:
            if self._registry is None:
                from repro_torch.obs.metrics import REGISTRY
                self._registry = REGISTRY
            self._g_spans = self._registry.gauge("trace.spans")
            self._g_dropped = self._registry.gauge("trace.dropped")
        self._g_spans.set(size)
        self._g_dropped.set(dropped)

    def current_span(self):
        """The calling thread's innermost open span (None outside any) — the
        event log reads it to correlate events with in-flight spans."""
        stack = self._stack()
        return stack[-1] if stack else None

    def span(self, name: str, *, cat: str = "", process: str = "measured",
             track: str | None = None, **args):
        """Context manager timing the enclosed code.  No-op when disabled."""
        if not self._enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, process, track, args)

    def add_span(self, name: str, start: float, end: float, *, cat: str = "",
                 process: str = "measured", track: str = "",
                 args: dict | None = None) -> None:
        """Record an externally-timed interval (timestamps on this tracer's
        clock).  No-op when disabled."""
        if not self._enabled:
            return
        self._record(SpanRecord(name=name, start=float(start), end=float(end),
                                cat=cat, process=process, track=track,
                                args=dict(args or {})))

    def instant(self, name: str, *, cat: str = "", process: str = "measured",
                track: str = "", **args) -> None:
        if not self._enabled:
            return
        now = self.clock()
        self._record(SpanRecord(name=name, start=now, end=now, cat=cat,
                                process=process, track=track, args=args))

    def add_engine_windows(self, windows: dict, freq_hz: float, *,
                           origin: float | None = None,
                           process: str = "modeled",
                           cat: str = "modeled") -> int:
        """Render a cycle-level engine timeline as spans.

        ``windows`` is ``simulator.engine_windows`` output (or a
        ``PipelineReport.engine_timeline``): engine -> [(start_cycles,
        end_cycles, opcode, tag)].  Cycles are rescaled by ``freq_hz`` to
        seconds and anchored at ``origin`` (default: now), one track per
        engine — the predicted LOAD(i+1)-inside-CONV(i) overlap sits beside
        the measured serve spans in the same exported view.  Returns the
        number of spans recorded."""
        if not self._enabled:
            return 0
        origin = self.clock() if origin is None else origin
        n = 0
        for engine, rows in windows.items():
            for s, e, opcode, tag in rows:
                self._record(SpanRecord(
                    name=f"{opcode}:{tag}", start=origin + s / freq_hz,
                    end=origin + e / freq_hz, cat=cat, process=process,
                    track=str(engine),
                    args={"cycles": int(e - s), "tag": tag}))
                n += 1
        return n

    # ------------------------------------------------------------- reading
    def records(self) -> list[SpanRecord]:
        """Snapshot of the ring buffer, oldest first."""
        with self._lock:
            if self._size < self.capacity:
                return [r for r in self._buf[:self._size]]
            return (self._buf[self._head:] + self._buf[:self._head])  # type: ignore[return-value]

    # -------------------------------------------------------------- export
    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable).

        Processes map to pids, tracks to tids (named via ``ph:"M"`` metadata
        events); spans become ``ph:"X"`` complete events with microsecond
        ``ts``/``dur`` relative to the earliest recorded span."""
        recs = self.records()
        t0 = min((r.start for r in recs), default=0.0)
        pids: dict[str, int] = {}
        tids: dict[tuple, int] = {}
        events: list[dict] = []
        for proc in sorted({r.process for r in recs}):
            pids[proc] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[proc], "tid": 0,
                           "args": {"name": proc}})
        for key in sorted({(r.process, r.track) for r in recs}):
            tids[key] = len(tids) + 1
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pids[key[0]], "tid": tids[key],
                           "args": {"name": key[1]}})
        for r in recs:
            events.append({
                "ph": "X", "name": r.name, "cat": r.cat or "default",
                "pid": pids[r.process], "tid": tids[(r.process, r.track)],
                "ts": (r.start - t0) * 1e6,
                "dur": max(0.0, r.duration) * 1e6,
                "args": dict(r.args),
            })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"n_dropped": self.n_dropped,
                              "clock": "monotonic-relative"}}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


# --------------------------------------------------------------- module-level
TRACER = Tracer()


def span(name: str, **kw):
    """``TRACER.span`` shorthand for instrumentation sites."""
    return TRACER.span(name, **kw)


def traced(name: str, *, cat: str = "", process: str = "measured",
           track: str | None = None):
    """Decorator: run the wrapped function inside a span (no-op when the
    module tracer is disabled)."""
    def deco(fn):
        import functools

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            if not TRACER.enabled:
                return fn(*a, **kw)
            with TRACER.span(name, cat=cat, process=process, track=track):
                return fn(*a, **kw)
        return wrapper
    return deco
