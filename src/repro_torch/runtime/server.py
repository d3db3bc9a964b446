"""Serving front end: Session + DynamicBatcher + metrics.

Port of ``src/repro/runtime/server.py``.  ``Server.submit`` is the whole
client API — hand in one int8 image, get a future for its output dict.
Queued requests are flushed as batches (see
:mod:`repro_torch.runtime.batching`), each batch padded up to the nearest
*allowed* size so only a handful of batch shapes is ever launched.  A
request's completion on the device (the session's ``mark_done``, a CUDA
event after the batch's last item) ends its latency: the percentiles of
``stats()``, the SLO cap's window, the histograms and the observer records
all measure submit to the answer, not to the batch's enqueue.  Labelled
metrics, the flight recorder, the event log and the OpenMetrics endpoint
(``serve_metrics``) are the observability plane of ``repro_torch.obs``.
"""
from __future__ import annotations

import numpy as np


def _default_sizes(max_batch: int) -> list[int]:
    sizes, s = [], 1
    while s < max_batch:
        sizes.append(s)
        s *= 2
    sizes.append(max_batch)
    return sorted(set(sizes))


class Server:
    def __init__(self, session, *, max_batch: int = 8,
                 max_latency_s: float = 2e-3, allowed_sizes=None,
                 warmup: bool = True, target_p99_ms: float | None = None,
                 slo_window: int = 64, labels: dict | None = None,
                 observers=None, flight=None, events=None):
        """``target_p99_ms`` turns on latency-SLO-aware batch sizing: the
        server watches the p99 of the batcher's bounded latency window
        (last ``slo_window`` submit->completion samples) and walks the
        effective max batch down the allowed-size ladder while the SLO is
        violated — a smaller cap both shortens the batch-forming wait and
        the batched launch itself — then back up once p99 clears the target
        with margin.
        ``max_batch`` stays the hard ceiling.  ``labels`` tags every metric
        this server emits (multi-tenant hosts label per-model).

        ``observers`` forwards per-request completion observers to the
        batcher (see :class:`~repro_torch.runtime.batching.DynamicBatcher`).
        ``flight`` attaches an :class:`~repro_torch.obs.flight.FlightRecorder`:
        the server binds it as an observer (tenant = ``labels["model"]``),
        seeds its per-tenant context with the session's launched tile shapes
        and the SLO target, and keeps request records stamped with the
        drift profiler's latest state.  ``events`` overrides the shared
        :data:`~repro_torch.obs.events.EVENTS` log the SLO resizer reports to."""
        from repro_torch.obs import events as obs_events
        from repro_torch.obs import metrics as obs_metrics
        from repro_torch.runtime.batching import DynamicBatcher

        self.session = session
        self.allowed_sizes = (sorted(set(allowed_sizes)) if allowed_sizes
                              else _default_sizes(max_batch))
        if self.allowed_sizes[-1] < max_batch:
            self.allowed_sizes.append(max_batch)
        self.max_batch = max_batch
        self.target_p99_ms = target_p99_ms
        self._slo_window = max(8, slo_window)
        self._slo_mark = 0              # n_served at the last cap change
        self.slo_shrinks = 0
        self.slo_grows = 0
        # shrink causes, from the batcher's split timings: queue-bound means
        # the p99 violation lived in batch-forming wait, launch-bound in the
        # batched execute itself (different remedies: the first wants a
        # smaller forming window / more replicas, the second a smaller batch)
        self.slo_shrinks_queue_bound = 0
        self.slo_shrinks_launch_bound = 0
        self._registry = obs_metrics.REGISTRY
        self._events = events if events is not None else obs_events.EVENTS
        self.labels = dict(labels) if labels else None
        self.flight = flight
        self._obs_http = None
        obs = list(observers) if observers else []
        if flight is not None:
            tenant = (self.labels or {}).get("model")
            flight.set_context(tenant, tiles=session.tile_summary(),
                               target_p99_ms=target_p99_ms,
                               allowed_sizes=list(self.allowed_sizes))
            obs.append(flight.bind(tenant=tenant,
                                   drift_state=session.drift_state))
        if warmup:
            self._warmup()
        self._batcher = DynamicBatcher(self._run, max_batch=max_batch,
                                       max_latency_s=max_latency_s,
                                       labels=self.labels, observers=obs,
                                       mark_done=session.mark_done)

    def _warmup(self) -> None:
        """Run every allowed batch shape once through the session's launch
        path (on its device), so first-use costs (the kernel build, CUDA
        context and allocator growth) never land inside a latency-sensitive
        flush.  Warmup does not count as served traffic (``_launch`` bumps
        no counters).  Its last mark anchors the device clock here, not at
        the first served batch."""
        shape = self.session.graph.shape(
            next(n.name for n in self.session.graph if n.op == "input"))
        for s in self.allowed_sizes:
            self.session._launch(np.zeros((s,) + tuple(shape[1:]), np.int8))
        self.session.mark_done()

    def _pad_size(self, n: int) -> int:
        for s in self.allowed_sizes:
            if s >= n:
                return s
        return n

    def _run(self, xs):
        self._adjust_for_slo()
        return self.session.run_batch(xs, pad_to=self._pad_size(len(xs)))

    # ------------------------------------------------- SLO-aware batch cap
    @property
    def effective_max_batch(self) -> int:
        return self._batcher.max_batch if hasattr(self, "_batcher") \
            else self.max_batch

    @staticmethod
    def _p99_ms(samples) -> float | None:
        lats = sorted(samples)
        if not lats:
            return None
        return lats[min(len(lats) - 1, int(0.99 * (len(lats) - 1)))] * 1e3

    def _recent_p99_ms(self, n_fresh: int) -> float | None:
        """p99 over the freshest ``n_fresh`` samples of the bounded window —
        never over latencies recorded before the last cap change, which
        describe a batch size that no longer exists."""
        lats = list(self._batcher.latencies)[-min(self._slo_window, n_fresh):]
        if len(lats) < 4:
            return None
        return self._p99_ms(lats)

    def _classify_violation(self, n_fresh: int) -> str:
        """Which half of the fresh latency window dominates its p99: the
        per-request queue wait or the batched launch."""
        k = min(self._slo_window, n_fresh)
        wait = self._p99_ms(list(self._batcher.queue_waits)[-k:]) or 0.0
        execute = self._p99_ms(list(self._batcher.execute_s)[-k:]) or 0.0
        return "queue" if wait > execute else "launch"

    def _adjust_for_slo(self) -> None:
        """Runs on the batcher worker before each launch (single-threaded
        with batch formation, so the cap never changes mid-batch).  Each cap
        change starts a cooldown: no further move until enough requests have
        been served *under the new cap* to judge it — otherwise one transient
        violation cascades the cap straight to the floor on stale samples."""
        if self.target_p99_ms is None:
            return
        cur = self._batcher.max_batch
        n_fresh = self._batcher.n_served - self._slo_mark
        if n_fresh < max(4, cur):
            return
        p99 = self._recent_p99_ms(n_fresh)
        if p99 is None:
            return
        if p99 > self.target_p99_ms:
            smaller = [s for s in self.allowed_sizes if s < cur]
            if smaller:
                self._batcher.set_max_batch(smaller[-1])
                self._slo_mark = self._batcher.n_served
                self.slo_shrinks += 1
                cause = self._classify_violation(n_fresh)
                if cause == "queue":
                    self.slo_shrinks_queue_bound += 1
                else:
                    self.slo_shrinks_launch_bound += 1
                self._registry.counter(f"serve.slo_shrink.{cause}_bound",
                                       self.labels).inc()
                self._events.emit(
                    "slo.resize", severity="warning",
                    message=f"p99 {p99:.2f}ms over {self.target_p99_ms}ms "
                            f"target; batch cap {cur} -> {smaller[-1]} "
                            f"({cause}-bound)",
                    direction="shrink", cause=cause, old_cap=cur,
                    new_cap=smaller[-1], p99_ms=p99,
                    target_p99_ms=self.target_p99_ms,
                    **(self.labels or {}))
                if self.flight is not None:
                    self.flight.trigger(
                        "slo_violation", tenant=(self.labels or {}).get("model"),
                        detail={"p99_ms": p99,
                                "target_p99_ms": self.target_p99_ms,
                                "cause": cause, "old_cap": cur,
                                "new_cap": smaller[-1]})
        elif p99 < 0.5 * self.target_p99_ms and cur < self.max_batch:
            bigger = [s for s in self.allowed_sizes
                      if cur < s <= self.max_batch]
            if bigger:
                self._batcher.set_max_batch(bigger[0])
                self._slo_mark = self._batcher.n_served
                self.slo_grows += 1
                self._registry.counter("serve.slo_grow", self.labels).inc()
                self._events.emit(
                    "slo.resize", severity="info",
                    message=f"p99 {p99:.2f}ms well under "
                            f"{self.target_p99_ms}ms target; batch cap "
                            f"{cur} -> {bigger[0]}",
                    direction="grow", old_cap=cur, new_cap=bigger[0],
                    p99_ms=p99, target_p99_ms=self.target_p99_ms,
                    **(self.labels or {}))

    # ---------------------------------------------------------------- client
    def submit(self, x):
        return self._batcher.submit(x)   # the batcher timestamps + records

    @property
    def pending(self) -> int:
        """Requests queued but not yet formed into a batch (the admission
        and fleet-routing signal)."""
        return self._batcher.pending

    def serve_metrics(self, host: str = "127.0.0.1", port: int = 0):
        """Mount the OpenMetrics scrape endpoint (plus /flight, /events,
        /snapshot, /explain) for this server's plane; returns the running
        :class:`~repro_torch.obs.export.ObsHTTPServer` (closed with the server)."""
        from repro_torch.obs.export import ObsHTTPServer
        if self._obs_http is None:
            self._obs_http = ObsHTTPServer(
                self._registry, flight=self.flight, events=self._events,
                host=host, port=port)
            # /explain/<model>: the served session's compile report, joined
            # with its live drift samples on every scrape
            model = ((self.labels or {}).get("model")
                     or self.session.graph.name)
            self._obs_http.add_explain(model, self.session.explain)
        return self._obs_http

    def close(self, wait: bool = True, timeout_s: float | None = None) -> None:
        self._batcher.close(wait=wait, timeout_s=timeout_s)
        if self._obs_http is not None:
            self._obs_http.close()
            self._obs_http = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # --------------------------------------------------------------- metrics
    def stats(self) -> dict:
        lats = sorted(self._batcher.latencies)
        pct = (lambda q: lats[min(len(lats) - 1,
                                  int(q * (len(lats) - 1)))] * 1e3) \
            if lats else (lambda q: 0.0)
        hist = dict(sorted(self._batcher.batch_sizes.items()))
        n = self._batcher.n_served
        return {
            "n_served": n,
            "n_batches": sum(hist.values()),
            "batch_histogram": hist,
            "mean_batch": (n / sum(hist.values())) if hist else 0.0,
            "p50_ms": pct(0.50),
            "p99_ms": pct(0.99),
            "queue_wait_p99_ms": self._p99_ms(self._batcher.queue_waits),
            "execute_p99_ms": self._p99_ms(self._batcher.execute_s),
            "allowed_sizes": list(self.allowed_sizes),
            "target_p99_ms": self.target_p99_ms,
            "effective_max_batch": self.effective_max_batch,
            "slo_shrinks": self.slo_shrinks,
            "slo_grows": self.slo_grows,
            "slo_shrinks_queue_bound": self.slo_shrinks_queue_bound,
            "slo_shrinks_launch_bound": self.slo_shrinks_launch_bound,
        }
