# Port of src/repro/obs/flight.py; records also carry done_s.
"""Per-request flight recorder: the last N requests, ready for forensics.

Latency histograms tell you *that* a gold tenant blew its p99; they cannot
tell you *which* request, behind *which* batch, after *how much* queue wait.
The :class:`FlightRecorder` keeps a bounded ring of :class:`FlightRecord`
entries — one per served request, fed by the batcher's observer hook — each
carrying the request id, tenant, queue-wait/execute windows, the batch it
rode in (id, size, co-members), and the tenant's drift state at completion
time.  Static per-tenant context (SLO class and target, the launched tile
shapes of the tenant's compiled plan) is registered once via
:meth:`set_context` rather than copied into every record.

``trigger(reason)`` freezes the ring into a forensic dump — a JSON document
with the recent records, per-tenant context, and the trigger's detail — and
three conditions auto-trigger it:

* an **executor exception** (a record arrives with ``status="error"``);
* an **admission rejection** (:meth:`note_rejection`, called by the
  multi-tenant front door when it sheds load);
* an **SLO violation** (the burn-rate tracker's alert hook calls
  :meth:`trigger` with ``reason="slo_violation"``).

Dumps are retained in a bounded deque (``/flight`` serves them), optionally
written to ``dump_dir`` as ``flight-<seq>-<reason>.json``, and rate-limited
per reason (``min_interval_s``) so an error storm produces one dump, not a
disk full of them.  Every dump also emits an ``flight.dump`` event, so the
JSONL log cross-references the forensic file.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import threading
import time


@dataclasses.dataclass(frozen=True)
class FlightRecord:
    """One request's flight data.  Times are seconds on the batcher's
    monotonic clock (``submit_s``) and window durations."""
    req_id: int
    tenant: str | None
    submit_s: float
    queue_wait_s: float
    execute_s: float
    latency_s: float
    batch_id: int
    batch_size: int
    batch_members: tuple          # req_ids that shared the launch
    status: str                   # "ok" | "error" | "rejected"
    error: str | None = None
    drift: dict | None = None     # tenant drift summary at record time
    done_s: float | None = None   # the batch's completion on the clock

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["batch_members"] = list(self.batch_members)
        return d


class FlightRecorder:
    """Bounded ring of per-request records with auto-dumping triggers."""

    def __init__(self, capacity: int = 512, *, dump_dir: str | None = None,
                 max_dumps: int = 16, min_interval_s: float = 1.0,
                 registry=None, events=None, clock=time.monotonic):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.dump_dir = dump_dir
        self.min_interval_s = min_interval_s
        self._records: collections.deque = collections.deque(maxlen=capacity)
        self._dumps: collections.deque = collections.deque(maxlen=max_dumps)
        self._context: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._clock = clock
        self._last_dump: dict[str, float] = {}     # reason -> clock() of last
        self.n_recorded = 0
        self.n_dumps = 0
        self._registry = registry
        self._events = events

    def _reg(self):
        if self._registry is None:
            from repro_torch.obs import metrics as obs_metrics
            self._registry = obs_metrics.REGISTRY
        return self._registry

    def _evt(self):
        if self._events is None:
            from repro_torch.obs.events import EVENTS
            self._events = EVENTS
        return self._events

    # ---------------------------------------------------------------- context
    def set_context(self, tenant: str, **ctx) -> None:
        """Attach static per-tenant context (SLO class/target, tile shapes of
        the compiled plan, ...) that every dump should carry once."""
        with self._lock:
            self._context.setdefault(tenant, {}).update(ctx)

    def bind(self, tenant: str | None = None, drift_state=None):
        """A batcher observer feeding this recorder: called with the per-
        request record dict the :class:`~repro_torch.runtime.batching
        .DynamicBatcher` emits.  ``drift_state`` is a zero-arg callable
        returning the tenant's current drift summary (or None)."""
        def observe(rec: dict) -> None:
            self.record(tenant=tenant,
                        drift=(drift_state() if drift_state is not None
                               else None),
                        **rec)
        return observe

    # -------------------------------------------------------------- recording
    def record(self, *, req_id: int, tenant: str | None = None,
               submit_s: float = 0.0, queue_wait_s: float = 0.0,
               execute_s: float = 0.0, latency_s: float = 0.0,
               batch_id: int = -1, batch_size: int = 0,
               batch_members=(), status: str = "ok",
               error: str | None = None, drift: dict | None = None,
               done_s: float | None = None) -> FlightRecord:
        rec = FlightRecord(req_id=req_id, tenant=tenant, submit_s=submit_s,
                           queue_wait_s=queue_wait_s, execute_s=execute_s,
                           latency_s=latency_s, batch_id=batch_id,
                           batch_size=batch_size,
                           batch_members=tuple(batch_members), status=status,
                           error=error, drift=drift, done_s=done_s)
        with self._lock:
            self._records.append(rec)
            self.n_recorded += 1
        self._reg().gauge("flight.records").set(len(self._records))
        if status == "error":
            self.trigger("executor_exception", tenant=tenant,
                         detail={"req_id": req_id, "error": error})
        return rec

    def note_rejection(self, tenant: str, pending: int, bound: int
                       ) -> FlightRecord:
        """Admission control shed a request: record it (no batch, no
        latency) and dump — rejections are exactly the moments an operator
        wants the recent-request picture for."""
        rec = self.record(req_id=-1, tenant=tenant, status="rejected",
                          error=f"admission bound {bound} hit "
                                f"({pending} pending)")
        self.trigger("admission_rejection", tenant=tenant,
                     detail={"pending": pending, "bound": bound})
        return rec

    # ----------------------------------------------------------------- dumps
    def trigger(self, reason: str, *, tenant: str | None = None,
                detail: dict | None = None) -> dict | None:
        """Freeze the ring into a forensic dump.  Rate-limited per reason;
        returns the dump dict (None when suppressed by the rate limit)."""
        now = self._clock()
        with self._lock:
            last = self._last_dump.get(reason)
            if last is not None and now - last < self.min_interval_s:
                self._reg().counter("flight.dumps_suppressed").inc()
                return None
            self._last_dump[reason] = now
            self.n_dumps += 1
            dump = {
                "seq": self.n_dumps,
                "reason": reason,
                "tenant": tenant,
                "detail": dict(detail or {}),
                "ts": time.time(),
                "mono": now,
                "n_recorded": self.n_recorded,
                "context": {t: dict(c) for t, c in self._context.items()},
                "records": [r.to_json() for r in self._records],
            }
            self._dumps.append(dump)
        path = None
        if self.dump_dir:
            os.makedirs(self.dump_dir, exist_ok=True)
            path = os.path.join(self.dump_dir,
                                f"flight-{dump['seq']}-{reason}.json")
            with open(path, "w") as f:
                json.dump(dump, f, indent=2, default=str)
            dump["path"] = path
        self._reg().counter("flight.dumps").inc()
        self._evt().emit("flight.dump", severity="error", reason=reason,
                         tenant=tenant, n_records=len(dump["records"]),
                         **({"path": path} if path else {}))
        return dump

    # ---------------------------------------------------------------- reading
    def records(self, n: int | None = None) -> list[FlightRecord]:
        with self._lock:
            recs = list(self._records)
        return recs[-n:] if n is not None else recs

    def dumps(self) -> list[dict]:
        with self._lock:
            return list(self._dumps)

    def snapshot(self) -> dict:
        """JSON-friendly view for the ``/flight`` endpoint and the dump CLI."""
        with self._lock:
            return {
                "capacity": self.capacity,
                "n_recorded": self.n_recorded,
                "n_dumps": self.n_dumps,
                "context": {t: dict(c) for t, c in self._context.items()},
                "records": [r.to_json() for r in self._records],
                "dumps": [dict(d) for d in self._dumps],
            }

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._dumps.clear()
            self._last_dump.clear()
            self.n_recorded = 0
            self.n_dumps = 0
