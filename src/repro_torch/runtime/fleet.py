"""Fault-tolerant serving fleet: replicated Sessions with health-driven
failover.

Port of ``src/repro/runtime/fleet.py``.  A serving plane must keep answering
when a replica dies mid-batch, so the :class:`Fleet` places N data-parallel
:class:`~repro_torch.runtime.session.Session` replicas across the CUDA
devices (``torch.device("cuda", i)``; a CPU device in the tests; with fewer
devices than replicas the placement wraps, several replicas to a card; each
replica's plan cache seeded from ONE shared
:class:`~repro_torch.asm.artifact.CompiledArtifact`, so the fleet compiles
nothing) and puts a failover router in front of their per-replica
:class:`~repro_torch.runtime.server.Server`s:

* **routing** — each request goes to the active replica with the smallest
  expected drain time, ``(queue depth + 1) x recent p99`` (cold replicas tie
  at zero and round-robin on depth alone);
* **health** — the :class:`~repro_torch.distributed.health.
  HeartbeatMonitor` is wired into the serve loop: every completed batch
  beats its replica with the measured execute time, idle healthy replicas
  are beaten by the monitor thread, and a replica sitting on work without
  completing goes heartbeat-dead.  Dead replicas, replicas with consecutive
  failed batches, straggling replicas (step-time EWMA beyond ``factor`` x
  the fleet median, >= 3 replicas), and replicas failing a health probe are
  **evicted**: routing stops, their in-flight requests are transparently
  re-dispatched to survivors, a ``replica.evict`` event fires and the flight
  recorder freezes a forensic dump;
* **retries** — a failed or timed-out attempt is retried on a different
  replica with exponential backoff, bounded by ``max_retries`` and a
  per-request deadline.  Whichever attempt completes FIRST resolves the
  client future; late completions (a hung replica finally answering) are
  suppressed by request id (``fleet.duplicates_suppressed``);
* **re-admission** — an evicted replica is probed with a warmup canary
  through its own serve queue; once the probe answers bit-exactly it is
  elastically re-admitted (``replica.admit``) and traffic flows back;
* **load shedding** — when capacity shrinks below demand, ``submit`` raises
  :class:`~repro_torch.runtime.multitenant.AdmissionError` past
  ``max_queue_per_replica x active replicas`` pending requests: degraded,
  not wedged.

Everything is observable on the ``repro_torch.obs`` plane: ``fleet.*``
labelled metrics, ``replica.evict`` / ``replica.admit`` / ``request.retry``
events, and flight dumps on every eviction.  The deterministic fault
injector that drives chaos runs lives in :mod:`repro_torch.runtime.chaos`:
its faults are host-side exceptions and sleeps in the launch hook.  A real
CUDA error poisons the card's context for every replica on it, and no retry
on that card hides it.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from repro_torch.distributed.health import HeartbeatMonitor
from repro_torch.runtime.multitenant import AdmissionError
from repro_torch.runtime.server import Server
from repro_torch.runtime.session import Session


class FleetError(RuntimeError):
    """A request could not be completed by any replica."""


class RetriesExhausted(FleetError):
    """Every allowed attempt failed (last cause in the message)."""


class DeadlineExceeded(FleetError):
    """The request's deadline passed before any attempt completed."""


@dataclasses.dataclass
class Replica:
    """One Session + Server pair, placed on one device."""
    rid: str
    index: int
    device: object
    session: Session
    server: Server
    state: str = "active"               # "active" | "evicted"
    strikes: int = 0                    # consecutive failed batches
    last_error_batch: int | None = None
    inflight: dict = dataclasses.field(default_factory=dict)  # req_id -> req
    lat: deque = dataclasses.field(default_factory=lambda: deque(maxlen=128))
    evictions: int = 0
    admissions: int = 0
    evict_reason: str | None = None
    probe: tuple | None = None          # (future, expires_at)
    next_probe: float = 0.0

    def p99_s(self) -> float:
        lats = sorted(self.lat)
        if not lats:
            return 0.0
        return lats[min(len(lats) - 1, int(0.99 * (len(lats) - 1)))]


@dataclasses.dataclass
class _Request:
    req_id: int
    x: object
    future: Future
    deadline: float
    attempts: int = 0                   # dispatches so far
    attempt_no: int = 0                 # monotonically superseding id
    current_rid: str | None = None
    attempt_expires: float = 0.0
    tried: set = dataclasses.field(default_factory=set)
    done: bool = False


class Fleet:
    """N data-parallel Session replicas behind one failover front door."""

    def __init__(self, artifact, *, n_replicas: int | None = None,
                 devices=None, backend: str = "fused",
                 max_retries: int = 3, retry_backoff_s: float = 0.01,
                 request_deadline_s: float = 60.0,
                 attempt_timeout_s: float = 10.0,
                 heartbeat_timeout_s: float = 2.0,
                 straggler_factor: float = 3.0,
                 max_consecutive_errors: int = 2,
                 check_interval_s: float = 0.02,
                 probe_interval_s: float = 0.25,
                 probe_timeout_s: float = 5.0,
                 max_queue_per_replica: int = 64,
                 session_kw: dict | None = None,
                 server_kw: dict | None = None,
                 monitor: HeartbeatMonitor | None = None,
                 flight=None, events=None, registry=None,
                 clock=time.monotonic):
        """``artifact`` is the one shared compiled model every replica serves
        (each replica's plan cache is seeded from it — no recompilation).
        ``devices`` are ``torch.device``s (default: every CUDA device, which
        raises where CUDA is absent).  ``n_replicas`` defaults to
        ``len(devices)``; with fewer devices than replicas, placement wraps
        round-robin (multi-session-per-device).
        ``max_retries`` bounds RE-dispatches per request (so a request runs
        at most ``1 + max_retries`` attempts); ``retry_backoff_s`` doubles
        per attempt.  ``attempt_timeout_s`` is the hang detector: an attempt
        not answered within it is retried elsewhere without waiting for the
        replica to be declared dead.  ``monitor`` defaults to a
        :class:`HeartbeatMonitor` with ``heartbeat_timeout_s``."""
        from repro_torch.obs import events as obs_events
        from repro_torch.obs import metrics as obs_metrics
        from repro_torch.obs.flight import FlightRecorder

        self.devices = ([torch.device(d) for d in devices]
                        if devices is not None else _cuda_devices())
        self.n_replicas = int(n_replicas if n_replicas is not None
                              else len(self.devices))
        if self.n_replicas < 1:
            raise ValueError("a fleet needs at least one replica")
        self.backend = backend
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.request_deadline_s = request_deadline_s
        self.attempt_timeout_s = attempt_timeout_s
        self.straggler_factor = straggler_factor
        self.max_consecutive_errors = max_consecutive_errors
        self.check_interval_s = check_interval_s
        self.probe_interval_s = probe_interval_s
        self.probe_timeout_s = probe_timeout_s
        self.max_queue_per_replica = max_queue_per_replica
        self._clock = clock
        self._registry = (registry if registry is not None
                          else obs_metrics.REGISTRY)
        self._events = events if events is not None else obs_events.EVENTS
        self.flight = flight if flight is not None else FlightRecorder(
            registry=self._registry, events=self._events)
        self.monitor = monitor if monitor is not None else HeartbeatMonitor(
            timeout_s=heartbeat_timeout_s, clock=clock)

        self._lock = threading.RLock()
        self._replicas: dict[str, Replica] = {}
        self._requests: dict[int, _Request] = {}
        self._retry_due: list = []      # [due_s, req, exclude, reason]
        self._seq = 0
        self._closed = False
        self.n_duplicates = 0

        self._m_submitted = self._registry.counter("fleet.submitted")
        self._m_completed = self._registry.counter("fleet.completed")
        self._m_rejected = self._registry.counter("fleet.rejected")
        self._m_retries = self._registry.counter("fleet.retries")
        self._m_duplicates = self._registry.counter(
            "fleet.duplicates_suppressed")
        self._m_deadline = self._registry.counter("fleet.deadline_exceeded")
        self._m_active = self._registry.gauge("fleet.active_replicas")
        self._m_pending = self._registry.gauge("fleet.pending")

        session_kw = dict(session_kw or {})
        server_kw = dict(server_kw or {})
        for i in range(self.n_replicas):
            rid = f"r{i}"
            dev = self.devices[i % len(self.devices)]
            session = Session.from_artifact(
                artifact, backend=backend, cache=_fresh_plan_cache(),
                device=dev, **session_kw)
            server = Server(session,
                            labels={"replica": rid},
                            observers=[self._observer(rid),
                                       self.flight.bind(
                                           tenant=rid,
                                           drift_state=session.drift_state)],
                            events=self._events, **server_kw)
            self._replicas[rid] = Replica(rid=rid, index=i, device=dev,
                                          session=session, server=server)
            self.flight.set_context(rid, device=str(dev), backend=backend)
            self.monitor.beat(rid)
            self._events.emit(
                "replica.admit", replica=rid, initial=True,
                device=str(dev),
                message=f"replica {rid} placed on {dev} (initial)")
        self._m_active.set(self.n_replicas)

        # warmup canary: the probe input every health check replays (numpy
        # int8), and the bit-exact expected answer (replica 0's executor,
        # pre-chaos, on its device)
        shape = artifact.rebuild_graph().shape(
            next(nd["name"] for nd in artifact.graph_nodes
                 if nd["op"] == "input"))
        rng = np.random.default_rng(0)
        self._canary_x = rng.integers(-128, 128, size=(1,) + tuple(shape[1:]),
                                      dtype=np.int64).astype(np.int8)
        # through the replica's launch path (its device, no hook attached
        # yet), as every probe runs
        self._canary_expected = self._replicas["r0"].session._launch(
            self._canary_x)

        self._stop = threading.Event()
        # construction (warmups, canary) can take longer than the heartbeat
        # timeout: staleness must be measured from serving start, not from
        # each replica's own creation instant
        for rid in self._replicas:
            self.monitor.beat(rid)
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, daemon=True, name="dnnvm-fleet-monitor")
        self._monitor_thread.start()

    # ----------------------------------------------------------------- client
    def submit(self, x) -> Future:
        """Enqueue one request; returns a future that resolves with the first
        successful attempt's output dict (or raises :class:`FleetError` /
        :class:`AdmissionError`)."""
        with self._lock:
            if self._closed:
                raise FleetError("fleet is closed")
            active = self._active()
            if not active:
                self._shed("no active replicas", 0, 0)
            bound = self.max_queue_per_replica * len(active)
            if len(self._requests) >= bound:
                self._shed(f"{len(self._requests)} pending >= bound {bound} "
                           f"({len(active)} active replicas)",
                           len(self._requests), bound)
            self._seq += 1
            req = _Request(req_id=self._seq, x=x, future=Future(),
                           deadline=self._clock() + self.request_deadline_s)
            self._requests[req.req_id] = req
            self._m_submitted.inc()
            self._m_pending.set(len(self._requests))
            self._dispatch(req)
        return req.future

    def _shed(self, why: str, pending: int, bound: int):
        self._m_rejected.inc()
        self._events.emit("admission.reject", severity="warning",
                          scope="fleet", pending=pending, bound=bound,
                          message=f"fleet shed a request: {why}")
        raise AdmissionError(f"fleet overloaded: {why}")

    # ---------------------------------------------------------------- routing
    def _active(self) -> list[Replica]:
        return [r for r in self._replicas.values() if r.state == "active"]

    @staticmethod
    def _score(r: Replica) -> float:
        """Expected drain time: queue depth x recent p99 (epsilon floor so
        cold replicas still order by depth)."""
        return (r.server.pending + len(r.inflight) + 1) * max(r.p99_s(), 1e-6)

    def _dispatch(self, req: _Request, *, exclude: set | None = None,
                  reason: str | None = None) -> None:
        """Route one attempt.  Called under the lock for fresh submits; takes
        it for retries."""
        with self._lock:
            if req.done:
                return
            active = self._active()
            if not active:
                # no capacity right now: park the request for the monitor to
                # re-dispatch once a replica is re-admitted (deadline still
                # applies, so an empty fleet fails requests at the deadline)
                self._retry_due.append([self._clock() + self.check_interval_s,
                                        req, set(exclude or ()), "no_replica"])
                return
            pool = ([r for r in active if r.rid not in (exclude or ())
                     and r.rid not in req.tried]
                    or [r for r in active if r.rid not in (exclude or ())]
                    or active)
            r = min(pool, key=self._score)
            req.attempts += 1
            req.attempt_no += 1
            req.current_rid = r.rid
            req.tried.add(r.rid)
            req.attempt_expires = self._clock() + self.attempt_timeout_s
            r.inflight[req.req_id] = req
            attempt = req.attempt_no
        if reason is not None:
            self._m_retries.inc()
            self._events.emit(
                "request.retry", severity="warning", req_id=req.req_id,
                attempt=req.attempts, to_replica=r.rid, reason=reason,
                message=f"request {req.req_id} attempt {req.attempts} "
                        f"-> {r.rid} ({reason})")
        try:
            fut = r.server.submit(req.x)
        except Exception as e:          # replica refused outright
            self._attempt_failed(req, r.rid, attempt, e, "submit_failed")
            return
        fut.add_done_callback(
            lambda f, rid=r.rid, a=attempt: self._attempt_done(req, rid, a, f))

    # -------------------------------------------------------------- attempts
    def _attempt_done(self, req: _Request, rid: str, attempt: int,
                      fut: Future) -> None:
        """Runs on the completing replica's batcher worker."""
        with self._lock:
            r = self._replicas.get(rid)
            if r is not None:
                r.inflight.pop(req.req_id, None)
            stale = attempt != req.attempt_no
        err = fut.exception()
        if err is None:
            self._resolve(req, result=fut.result())
        elif not stale and not req.done:
            self._attempt_failed(req, rid, attempt, err, "error")
        # a stale failed attempt is already being retried — nothing to do

    def _attempt_failed(self, req: _Request, rid: str, attempt: int,
                        err: BaseException, reason: str) -> None:
        now = self._clock()
        with self._lock:
            if req.done or attempt != req.attempt_no:
                return
            if now > req.deadline:
                self._m_deadline.inc()
                self._resolve(req, error=DeadlineExceeded(
                    f"request {req.req_id} missed its deadline after "
                    f"{req.attempts} attempts (last: {err!r})"))
                return
            if req.attempts > self.max_retries:
                self._resolve(req, error=RetriesExhausted(
                    f"request {req.req_id} failed after {req.attempts} "
                    f"attempts (last on {rid}: {err!r})"))
                return
            backoff = self.retry_backoff_s * (2 ** (req.attempts - 1))
            self._retry_due.append([now + backoff, req, {rid}, reason])

    def _resolve(self, req: _Request, result=None,
                 error: BaseException | None = None) -> bool:
        """First writer wins; late successes are duplicate-suppressed."""
        with self._lock:
            if req.done:
                if error is None:
                    self.n_duplicates += 1
                    self._m_duplicates.inc()
                return False
            req.done = True
            self._requests.pop(req.req_id, None)
            self._m_pending.set(len(self._requests))
        if error is None:
            self._m_completed.inc()
            req.future.set_result(result)
        else:
            req.future.set_exception(error)
        return True

    # -------------------------------------------------------------- observer
    def _observer(self, rid: str):
        """Per-request completion hook on the replica's batcher: heartbeats,
        latency window, consecutive-error strikes (per batch, not per
        request — one poisoned batch of 8 is ONE strike)."""
        def observe(rec: dict) -> None:
            with self._lock:
                r = self._replicas.get(rid)
                if r is None:
                    return
                if rec["status"] == "ok":
                    self.monitor.beat(rid, step_time_s=rec["execute_s"])
                    r.strikes = 0
                    r.last_error_batch = None
                    r.lat.append(rec["latency_s"])
                elif rec["batch_id"] != r.last_error_batch:
                    r.last_error_batch = rec["batch_id"]
                    r.strikes += 1
        return observe

    # --------------------------------------------------------------- monitor
    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            try:
                self._tick()
            except Exception:           # the fleet must outlive its monitor
                pass

    def _tick(self) -> None:
        now = self._clock()
        with self._lock:
            active = self._active()
            # unsuspected replicas beat by proxy: a replica stops being
            # beaten once it is striking out or holding an attempt past its
            # window (a long-but-legitimate batch is NOT stale — the attempt
            # timeout, not wall silence, is what marks work as stuck)
            for r in active:
                if r.strikes == 0 and all(now <= q.attempt_expires
                                          for q in r.inflight.values()):
                    self.monitor.beat(r.rid)
            dead = set(self.monitor.dead())
            stragglers = (set(self.monitor.stragglers(self.straggler_factor))
                          if len(active) > 1 else set())
            to_evict = []
            for r in active:
                if r.rid in dead:
                    to_evict.append((r, "heartbeat_timeout"))
                elif r.strikes >= self.max_consecutive_errors:
                    to_evict.append((r, "consecutive_errors"))
                elif r.rid in stragglers:
                    to_evict.append((r, "straggler"))
        for r, reason in to_evict:
            self._evict(r, reason)

        # per-attempt timeouts + per-request deadlines
        with self._lock:
            reqs = list(self._requests.values())
        for req in reqs:
            timed_out = None
            with self._lock:
                if req.done:
                    continue
                if now > req.deadline:
                    self._m_deadline.inc()
                    self._resolve(req, error=DeadlineExceeded(
                        f"request {req.req_id} missed its deadline after "
                        f"{req.attempts} attempts"))
                    continue
                if (req.current_rid is not None
                        and now > req.attempt_expires
                        and req.attempts <= self.max_retries):
                    timed_out = req.current_rid
                    r = self._replicas.get(timed_out)
                    if r is not None and r.state == "active":
                        r.strikes += 1
                    req.attempt_no += 1     # supersede the stuck attempt
            if timed_out is not None:
                self._dispatch(req, exclude={timed_out},
                               reason="attempt_timeout")

        # due retries (backoff elapsed / parked for capacity)
        with self._lock:
            due = [e for e in self._retry_due if e[0] <= now]
            self._retry_due = [e for e in self._retry_due if e[0] > now]
        for _, req, exclude, reason in due:
            self._dispatch(req, exclude=exclude, reason=reason)

        # health probes: suspect-active (strikes but no verdict yet) and
        # evicted replicas awaiting re-admission
        with self._lock:
            probees = [r for r in self._replicas.values()
                       if (r.state == "evicted" or r.strikes > 0)]
        for r in probees:
            self._check_probe(r, now)

    # ----------------------------------------------------------- probe/evict
    def _check_probe(self, r: Replica, now: float) -> None:
        with self._lock:
            probe = r.probe
            if probe is None:
                if now >= r.next_probe and r.server is not None:
                    try:
                        fut = r.server.submit(self._canary_x)
                    except Exception:
                        r.next_probe = now + self.probe_interval_s
                        return
                    r.probe = (fut, now + self.probe_timeout_s)
                    self._registry.counter("fleet.probes",
                                           {"replica": r.rid}).inc()
                return
            fut, expires = probe
        if fut.done():
            err = fut.exception()
            ok = err is None and self._canary_ok(fut.result())
            with self._lock:
                r.probe = None
                r.next_probe = now + self.probe_interval_s
            if ok:
                if r.state == "evicted":
                    self._admit(r)
                else:                   # suspect replica vindicated
                    with self._lock:
                        r.strikes = 0
                        r.last_error_batch = None
                        self.monitor.beat(r.rid)
            else:
                self._registry.counter("fleet.probe_failures",
                                       {"replica": r.rid}).inc()
                if r.state == "active":
                    self._evict(r, "probe_failed")
        elif now > expires:
            # probe hung: drop it (a late answer is just a canary output);
            # an active replica that cannot answer a canary is evicted
            with self._lock:
                r.probe = None
                r.next_probe = now + self.probe_interval_s
            self._registry.counter("fleet.probe_failures",
                                   {"replica": r.rid}).inc()
            if r.state == "active":
                self._evict(r, "probe_timeout")

    def _canary_ok(self, out: dict) -> bool:
        exp = self._canary_expected
        return all(torch.equal(exp[k], out[k].to(exp[k].device))
                   for k in exp)

    def _evict(self, r: Replica, reason: str) -> None:
        with self._lock:
            if r.state != "active":
                return
            r.state = "evicted"
            r.evictions += 1
            r.evict_reason = reason
            r.strikes = 0
            r.probe = None
            r.next_probe = self._clock() + self.probe_interval_s
            self.monitor.forget(r.rid)
            migrated = [req for req in r.inflight.values() if not req.done]
            r.inflight.clear()
            for req in migrated:
                req.attempt_no += 1     # supersede the doomed attempt
            n_active = len(self._active())
            self._m_active.set(n_active)
        self._registry.counter("fleet.evictions", {"replica": r.rid}).inc()
        self._events.emit(
            "replica.evict", severity="error", replica=r.rid, reason=reason,
            migrated=len(migrated), active=n_active,
            message=f"replica {r.rid} evicted ({reason}); "
                    f"{len(migrated)} in-flight migrated, "
                    f"{n_active} active remain")
        self.flight.trigger("replica_evict", tenant=r.rid,
                            detail={"reason": reason,
                                    "migrated": len(migrated),
                                    "active_replicas": n_active})
        for req in migrated:
            self._dispatch(req, exclude={r.rid}, reason="replica_evicted")

    def _admit(self, r: Replica) -> None:
        with self._lock:
            if r.state == "active":
                return
            r.state = "active"
            r.strikes = 0
            r.last_error_batch = None
            r.evict_reason = None
            r.admissions += 1
            self.monitor.beat(r.rid)
            n_active = len(self._active())
            self._m_active.set(n_active)
        self._registry.counter("fleet.admissions", {"replica": r.rid}).inc()
        self._events.emit(
            "replica.admit", replica=r.rid, initial=False, active=n_active,
            message=f"replica {r.rid} re-admitted after warmup probe "
                    f"({n_active} active)")

    # ---------------------------------------------------------------- stats
    def replicas(self) -> dict[str, Replica]:
        with self._lock:
            return dict(self._replicas)

    def active_replicas(self) -> list[str]:
        with self._lock:
            return [r.rid for r in self._active()]

    def wait_active(self, rid: str, timeout_s: float = 10.0) -> bool:
        """Block until ``rid`` is active again (tests and orchestration);
        False on timeout."""
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout_s:
            with self._lock:
                r = self._replicas.get(rid)
                if r is not None and r.state == "active":
                    return True
            time.sleep(self.check_interval_s)
        return False

    def stats(self) -> dict:
        with self._lock:
            per = {}
            for rid, r in self._replicas.items():
                st = r.server.stats()
                per[rid] = {
                    "state": r.state,
                    "device": str(r.device),
                    "pending": r.server.pending,
                    "inflight": len(r.inflight),
                    "strikes": r.strikes,
                    "n_served": st["n_served"],
                    "n_batches": st["n_batches"],
                    "p99_ms": r.p99_s() * 1e3,
                    "evictions": r.evictions,
                    "admissions": r.admissions,
                    "evict_reason": r.evict_reason,
                    "step_ema_s": (self.monitor.hosts[rid].step_ema
                                   if rid in self.monitor.hosts else None),
                }
            return {
                "replicas": per,
                "n_replicas": self.n_replicas,
                "active": [r.rid for r in self._active()],
                "pending": len(self._requests),
                "submitted": self._m_submitted.value,
                "completed": self._m_completed.value,
                "rejected": self._m_rejected.value,
                "retries": self._m_retries.value,
                "duplicates_suppressed": self.n_duplicates,
                "deadline_exceeded": self._m_deadline.value,
            }

    def serve_metrics(self, host: str = "127.0.0.1", port: int = 0):
        """Mount the fleet's observability plane (shared registry + this
        fleet's flight recorder and event log)."""
        from repro_torch.obs.export import ObsHTTPServer
        return ObsHTTPServer(self._registry, flight=self.flight,
                             events=self._events, host=host, port=port)

    # ---------------------------------------------------------------- close
    def close(self, wait: bool = True) -> None:
        """Stop the monitor, drain the replicas, fail anything left.  Every
        join is bounded: a replica wedged inside a fault (heal chaos first
        for a clean drain) cannot hang the fleet's own shutdown."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        self._monitor_thread.join(timeout=5.0)
        for r in self.replicas().values():
            r.server.close(wait=wait,
                           timeout_s=5.0 if r.state == "active" else 0.5)
        with self._lock:
            leftovers = [req for req in self._requests.values()
                         if not req.done]
        for req in leftovers:
            self._resolve(req, error=FleetError(
                f"fleet closed with request {req.req_id} unresolved"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _fresh_plan_cache():
    from repro_torch.asm import PlanCache
    return PlanCache()


def _cuda_devices() -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass devices=[torch.device"
                           "('cpu')] to run the fleet on the CPU")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
