# Port of src/repro/obs/trace.py: device spans and the device clock are the
# port's own; the reference's engine-window rendering has no caller here.
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
* ``tracer.device_span("item3:chain:conv4", device)`` — the *device's* time
  for the enclosed work: a pair of CUDA events recorded on the device's
  current stream around it, mapped onto the tracer's clock by the device's
  :class:`DeviceClock`.  The span stays pending until its end event has
  completed and is resolved, without blocking, when :meth:`Tracer.records`
  or :meth:`Tracer.to_chrome` reads the ring.  On a device whose work is
  synchronous (the CPU) it is timed by the tracer's clock.

A device's clock drifts against the host's (a few us a second on an
H100), so a long-running server bounds the error with
:meth:`Tracer.refresh`, which takes the anchor again once it is old.

``tracer.context(batch_id=7)`` tags every span the calling thread records
inside it (the serving worker tags each batch's spans with its id).

``to_chrome()`` emits the Chrome trace-event JSON (``ph:"X"`` complete events
in microseconds + ``ph:"M"`` process/thread name metadata), loadable by
Perfetto (https://ui.perfetto.dev) and ``chrome://tracing``.  Its
``otherData["origin_s"]`` is the time of ``ts`` 0 on the tracer's clock, so
an exported trace can be laid on the axis of a ``torch.profiler`` trace that
marks a known time of the same clock.

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


# A device clock's anchor is taken again once it is this old and the
# device's stream is idle, and at the latest once it is REANCHOR_MAX_S old.
REANCHOR_IDLE_S = 1.0
REANCHOR_MAX_S = 10.0
# An anchor's event must complete within ANCHOR_SLACK_S of its record, in
# one of ANCHOR_TRIES tries, for the anchor to be taken.
ANCHOR_SLACK_S = 50e-6
ANCHOR_TRIES = 4


def cuda_events(device):
    """The default event factory: for a CUDA device, ``(record, drain,
    idle)`` — ``record()`` records a timing event on the device's current
    stream and returns it, ``drain()`` waits for all of the device's work,
    ``idle()`` says whether that stream has finished all its work.  None
    for any other device: its work is synchronous, and the host clock times
    it."""
    if getattr(device, "type", str(device).split(":")[0]) != "cuda":
        return None
    import torch

    def record():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev
    return (record, lambda: torch.cuda.synchronize(device),
            lambda: torch.cuda.current_stream(device).query())


class HostMark:
    """A point of a device whose work is synchronous: the host time it was
    taken.  Complete as soon as it exists."""
    __slots__ = ("_t",)

    def __init__(self, t: float):
        self._t = t

    def query(self) -> bool:
        return True

    def wait(self) -> None:
        pass

    def seconds(self) -> float:
        return self._t


class DeviceMark:
    """A point in a device's stream of work: an event, and the anchor of the
    :class:`DeviceClock` it was recorded under."""
    __slots__ = ("event", "_anchor", "_t_anchor")

    def __init__(self, event, anchor, t_anchor: float):
        self.event, self._anchor, self._t_anchor = event, anchor, t_anchor

    def query(self) -> bool:
        """Has the device reached this point (without blocking)?"""
        return self.event.query()

    def wait(self) -> None:
        self.event.synchronize()

    def seconds(self) -> float:
        """When the device reached this point, on the host clock of the
        :class:`DeviceClock` that recorded it.  Valid once :meth:`query` is
        true."""
        return self._t_anchor + self._anchor.elapsed_time(self.event) / 1e3


class DeviceClock:
    """Maps a device's events onto a host clock.  The anchor is an event
    recorded on an idle stream, which the device reaches as it is recorded
    (within about 10 us on an H100); its host time is the clock read just
    before the record.  An event's host time is then the anchor's plus the
    device time between the two (``elapsed_time``).  ``record``, ``drain``
    and ``idle`` come from an event factory (:func:`cuda_events`, or fakes
    in tests).

    The device's clock drifts against the host's (an H100's ran 1-6 us a
    second off ``time.monotonic``, either way), so the error grows with
    the anchor's age: :meth:`refresh` keeps it young."""

    def __init__(self, record, drain, idle, clock=time.monotonic):
        self._record, self._drain, self._idle = record, drain, idle
        self.clock = clock
        self._anchor = None             # (event, host seconds)

    def anchor(self, drain: bool = True) -> None:
        """Take the anchor again, after all of the device's work
        (``drain``: set-up, enabling a trace) or the work queued on the
        current stream.  Another thread's work (a copy of answers, say) can
        slip in ahead of the anchor, so the host clock is read again as
        the event completes:
        an anchor is kept only if that took ``ANCHOR_SLACK_S`` or less, of
        ``ANCHOR_TRIES`` tries; otherwise the old one stays (the first
        anchor keeps the closest try)."""
        if drain:
            self._drain()
        best = None
        for _ in range(ANCHOR_TRIES):
            if not self._idle():
                self._record().synchronize()
            t = self.clock()
            ev = self._record()
            while not ev.query():       # no blocking wait: a thread that
                pass                    # blocks can run again much later
            slack = self.clock() - t
            if best is None or slack < best[2]:
                best = (ev, t, slack)
            if slack <= ANCHOR_SLACK_S:
                break
        if self._anchor is None or best[2] <= ANCHOR_SLACK_S:
            self._anchor = best[:2]

    def refresh(self) -> None:
        """Take the anchor again if it is ``REANCHOR_IDLE_S`` old and the
        stream has nothing queued (an event and a wait of about 20 us), or
        ``REANCHOR_MAX_S`` old whatever is queued (the wait then lasts until
        the queued work has run).  The error from drift stays under the
        drift's rate times ``REANCHOR_MAX_S``, and times ``REANCHOR_IDLE_S``
        where the device goes idle that often.  Marks taken earlier keep
        the anchor they were taken under."""
        if self._anchor is None:
            return
        age = self.clock() - self._anchor[1]
        if age >= REANCHOR_MAX_S or (age >= REANCHOR_IDLE_S
                                     and self._idle()):
            self.anchor(drain=False)

    def mark(self) -> DeviceMark:
        """Record an event now; the first mark takes the anchor."""
        if self._anchor is None:
            self.anchor()
        return DeviceMark(self._record(), *self._anchor)


class _Span:
    """Live span handle: records itself into the tracer on ``__exit__``."""
    __slots__ = ("_tracer", "name", "cat", "process", "track", "args",
                 "_start", "_depth")

    def __init__(self, tracer: "Tracer", name: str, cat: str, process: str,
                 track: str | None, args: dict):
        self._tracer = tracer
        self.name, self.cat, self.process = name, cat, process
        self.track = track
        self.args = tracer._tagged(args)

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


class _DeviceSpan:
    """Live device span: marks the device's stream on entry and exit and
    hands the pair to the tracer, which resolves it once the end mark has
    completed."""
    __slots__ = ("_tracer", "_device", "name", "cat", "process", "track",
                 "args", "_start")

    def __init__(self, tracer: "Tracer", name: str, device, cat: str,
                 process: str, track: str, args: dict):
        self._tracer, self._device = tracer, device
        self.name, self.cat, self.process = name, cat, process
        self.track = track
        self.args = tracer._tagged(args)

    def __enter__(self):
        self._start = self._tracer.mark(self._device)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self._tracer._add_pending(
            (self._start, self._tracer.mark(self._device), self.name,
             self.cat, self.process, self.track, self.args))
        return False


class _Context:
    """Tags every span the calling thread records while it is open."""
    __slots__ = ("_tracer", "_args", "_saved")

    def __init__(self, tracer: "Tracer", args: dict):
        self._tracer, self._args = tracer, args

    def __enter__(self):
        local = self._tracer._local
        self._saved = getattr(local, "tags", None)
        local.tags = {**(self._saved or {}), **self._args}
        return self

    def __exit__(self, *exc):
        self._tracer._local.tags = self._saved
        return False


class Tracer:
    """Thread-safe span recorder with a bounded ring buffer.

    ``capacity`` bounds retained spans; once full, recording a new span evicts
    the oldest (``n_dropped`` counts evictions).  ``clock`` must be monotonic;
    externally-timed spans (:meth:`add_span`) should use timestamps from the
    same clock or alignment across tracks is lost.

    ``event_factory(device)`` gives a device's ``(record, drain, idle)``
    for its :class:`DeviceClock`, or None for a device timed by ``clock``
    (default :func:`cuda_events`).  Each device's clock is anchored at its
    first mark, again each time the tracer is enabled, so a trace starts
    from a fresh anchor, and wherever :meth:`refresh` finds it old.
    """

    def __init__(self, capacity: int = 65536, clock=time.monotonic,
                 enabled: bool = False, registry=None,
                 event_factory=cuda_events):
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
        self._event_factory = event_factory
        self._clocks: dict = {}         # str(device) -> DeviceClock | None
        self._pending: list = []        # device spans not yet complete
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
        """Start recording; re-anchors every device clock (each drains its
        device)."""
        for clock in list(self._clocks.values()):
            if clock is not None:
                clock.anchor()
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
            self._pending = []
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
                                args=self._tagged(dict(args or {}))))

    def instant(self, name: str, *, cat: str = "", process: str = "measured",
                track: str = "", **args) -> None:
        if not self._enabled:
            return
        now = self.clock()
        self._record(SpanRecord(name=name, start=now, end=now, cat=cat,
                                process=process, track=track, args=args))

    def context(self, **args):
        """Context manager: every span the calling thread records inside it
        carries ``args`` (a span's own args win).  Tags even while disabled,
        so a trace enabled in the middle of the block still sees them."""
        return _Context(self, args)

    def _tagged(self, args: dict) -> dict:
        tags = getattr(self._local, "tags", None)
        return {**tags, **args} if tags else args

    # ------------------------------------------------------- device time
    def device_clock(self, device) -> DeviceClock | None:
        """``device``'s clock (made on first use), or None where the device
        is timed by the host clock."""
        key = str(device)
        try:
            return self._clocks[key]
        except KeyError:
            fns = self._event_factory(device)
            clock = (DeviceClock(*fns, clock=self.clock) if fns is not None
                     else None)
            return self._clocks.setdefault(key, clock)

    def refresh(self, device) -> None:
        """Bound the drift of ``device``'s clock (:meth:`DeviceClock.refresh`;
        nothing where the host clock times the device).  Call it where a
        short wait is harmless, as the session does before each batch."""
        clock = self.device_clock(device)
        if clock is not None:
            clock.refresh()

    def mark(self, device):
        """A mark of ``device``'s stream of work now (whether or not the
        tracer is enabled): a :class:`DeviceMark`, or a :class:`HostMark`
        where the host clock times the device."""
        clock = self.device_clock(device)
        return clock.mark() if clock is not None else HostMark(self.clock())

    def device_span(self, name: str, device, *, cat: str = "device",
                    process: str = "measured", track: str = "device",
                    **args):
        """Context manager timing the enclosed work on ``device`` (see the
        module docstring).  No-op when disabled."""
        if not self._enabled:
            return _NULL_SPAN
        return _DeviceSpan(self, name, device, cat, process, track, args)

    def _add_pending(self, span: tuple) -> None:
        if isinstance(span[1], HostMark):
            self._resolve_one(span)
            return
        with self._lock:
            self._pending.append(span)
            n = len(self._pending)
        if n > self.capacity:           # nobody reads: keep memory bounded
            self._resolve()
            with self._lock:
                lost = len(self._pending) - self.capacity
                if lost > 0:
                    del self._pending[:lost]
                    self.n_recorded += lost

    def _resolve_one(self, span: tuple) -> None:
        start, end, name, cat, process, track, args = span
        self._record(SpanRecord(name=name, start=start.seconds(),
                                end=end.seconds(), cat=cat, process=process,
                                track=track, args=args))

    def _resolve(self) -> None:
        """Record the pending device spans whose end has completed; never
        waits for the device."""
        with self._lock:
            pending, self._pending = self._pending, []
        still = []
        for span in pending:
            if span[1].query():
                self._resolve_one(span)
            else:
                still.append(span)
        if still:
            with self._lock:
                self._pending[:0] = still

    # ------------------------------------------------------------- reading
    def records(self) -> list[SpanRecord]:
        """Snapshot of the ring buffer, oldest first, after recording the
        device spans that have completed."""
        if self._pending:
            self._resolve()
        with self._lock:
            if self._size < self.capacity:
                return [r for r in self._buf[:self._size]]
            return (self._buf[self._head:] + self._buf[:self._head])  # type: ignore[return-value]

    # -------------------------------------------------------------- export
    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object (Perfetto-loadable).

        Processes map to pids, tracks to tids (named via ``ph:"M"`` metadata
        events); spans become ``ph:"X"`` complete events with microsecond
        ``ts``/``dur`` relative to the earliest recorded span, whose start on
        the tracer's clock is ``otherData["origin_s"]``."""
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
                              "clock": "monotonic-relative",
                              "origin_s": t0}}

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
