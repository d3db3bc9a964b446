# Copied from src/repro/runtime/batching.py; imports point at repro_torch.
"""Async dynamic-batching front end for the runtime supporter.

Requests arrive one image at a time; the accelerator is happiest launching
once per *batch* (one kernel grid covers all N images).  The
:class:`DynamicBatcher` sits between the two: ``submit`` enqueues a request
and returns a future immediately, a single worker drains the queue into
batches bounded by two knobs —

* ``max_batch``     — never launch more than this many images at once;
* ``max_latency_s`` — never hold the *oldest* queued request longer than
  this before flushing a partial batch.

The worker owns all executor calls (device dispatch stays single-threaded);
completion is delivered through ``concurrent.futures.Future``, so callers can
block, poll, or chain callbacks.  ``close()`` drains outstanding requests and
joins the worker; submitting after close raises :class:`BatcherClosed`.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import DEFAULT_BATCH_BUCKETS


class BatcherClosed(RuntimeError):
    """submit() after close()."""


class DynamicBatcher:
    def __init__(self, run_batch, *, max_batch: int = 8,
                 max_latency_s: float = 2e-3, clock=time.monotonic,
                 latency_window: int = 16384, registry=None, tracer=None,
                 labels: dict | None = None, observers=None):
        """``run_batch(xs) -> list[result]`` executes one batch (one result
        per request, same order).  ``latency_window`` bounds the retained
        latency samples (a long-running server must not grow without bound).

        Besides end-to-end ``latencies`` (submit -> result), the batcher keeps
        ``queue_waits`` (submit -> batch formed, per request) and
        ``execute_s`` (batch formed -> results back, per batch) so an SLO
        controller can tell a queue-bound p99 violation from a launch-bound
        one.  When the shared tracer is enabled, each request gets a
        queue-wait + execute track and each batch a batch-track span.
        ``labels`` tags every emitted metric (multi-tenant serving labels
        per-model: ``serve.requests{model=vgg16}``).

        ``observers`` are callables invoked on the worker thread once per
        request after its batch completes (and on batch failure), with one
        record dict: ``req_id``, ``submit_s``, ``queue_wait_s``,
        ``execute_s``, ``latency_s``, ``batch_id``, ``batch_size``,
        ``batch_members``, ``status`` ("ok" | "error"), ``error``.  The
        flight recorder and the SLO burn-rate tracker plug in here; observer
        exceptions are swallowed — observability must not break serving."""
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._run_batch = run_batch
        self.max_batch = max_batch
        self.max_latency_s = max_latency_s
        self._clock = clock
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: collections.deque = collections.deque()
        self._closed = False
        self._seq = 0                    # request sequence id (trace tracks)
        self._n_batches = 0
        self.batch_sizes: collections.Counter = collections.Counter()
        self.n_served = 0
        # submit -> result per request, most recent latency_window samples;
        # recorded BEFORE the future resolves, so a caller reading stats
        # right after result() returns never sees a partial sample set
        self.latencies: collections.deque = collections.deque(
            maxlen=latency_window)
        # submit -> batch formation, per request (same window discipline)
        self.queue_waits: collections.deque = collections.deque(
            maxlen=latency_window)
        # batch formation -> results back, per BATCH
        self.execute_s: collections.deque = collections.deque(
            maxlen=latency_window)
        self._registry = (registry if registry is not None
                          else obs_metrics.REGISTRY)
        self._tracer = tracer if tracer is not None else obs_trace.TRACER
        self.labels = dict(labels) if labels else None
        self._observers = list(observers) if observers else []
        self._m_requests = self._registry.counter("serve.requests", self.labels)
        self._m_batches = self._registry.counter("serve.batches", self.labels)
        self._m_errors = self._registry.counter("serve.errors", self.labels)
        self._m_depth = self._registry.gauge("serve.queue_depth", self.labels)
        self._m_batch = self._registry.histogram("serve.batch_size",
                                                 DEFAULT_BATCH_BUCKETS,
                                                 labels=self.labels)
        self._m_latency = self._registry.histogram("serve.latency_ms",
                                                   labels=self.labels)
        self._m_wait = self._registry.histogram("serve.queue_wait_ms",
                                                labels=self.labels)
        self._m_exec = self._registry.histogram("serve.execute_ms",
                                                labels=self.labels)
        self._worker = threading.Thread(target=self._loop, daemon=True,
                                        name="dnnvm-batcher")
        self._worker.start()

    # --------------------------------------------------------------- client
    def submit(self, x) -> Future:
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise BatcherClosed("batcher is closed")
            self._seq += 1
            self._queue.append((x, fut, self._clock(), self._seq))
            self._m_depth.set(len(self._queue))
            self._cv.notify_all()
        self._m_requests.inc()
        return fut

    def set_max_batch(self, n: int) -> None:
        """Retarget the batch-size cap (latency-SLO-aware serving shrinks and
        regrows it at run time).  Takes effect for the next formed batch; the
        worker is woken in case the queue already satisfies the new cap."""
        if n < 1:
            raise ValueError("max_batch must be >= 1")
        with self._cv:
            self.max_batch = n
            self._cv.notify_all()

    def close(self, wait: bool = True, timeout_s: float | None = None) -> None:
        """Flush whatever is queued, then stop the worker.  Idempotent; with
        an empty queue this returns as soon as the worker observes the flag.
        ``timeout_s`` bounds the join (the fleet closes possibly-wedged
        replicas without hanging its own shutdown)."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if wait:
            self._worker.join(timeout=timeout_s)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    # --------------------------------------------------------------- worker
    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if not self._queue:      # closed and drained
                    return
                # batch-forming window: flush when full, when the OLDEST
                # request has waited max_latency_s since submit (it may
                # already have waited out a previous batch's execution), or
                # at shutdown
                deadline = self._queue[0][2] + self.max_latency_s
                while (len(self._queue) < self.max_batch
                       and not self._closed):
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                batch = [self._queue.popleft()
                         for _ in range(min(self.max_batch,
                                            len(self._queue)))]
                self._m_depth.set(len(self._queue))
            self._execute(batch)

    def add_observer(self, fn) -> None:
        """Register a per-request completion observer (see ``observers``)."""
        self._observers.append(fn)

    def _notify(self, batch, t_form: float, t_done: float, status: str,
                error: str | None) -> None:
        if not self._observers:
            return
        members = tuple(seq for _, _, _, seq in batch)
        bid = self._n_batches
        for _, _, t0, seq in batch:
            rec = {"req_id": seq, "submit_s": t0,
                   "queue_wait_s": t_form - t0,
                   "execute_s": t_done - t_form,
                   "latency_s": t_done - t0,
                   "batch_id": bid, "batch_size": len(batch),
                   "batch_members": members,
                   "status": status, "error": error}
            for fn in self._observers:
                try:
                    fn(rec)
                except Exception:    # observers must never break serving
                    pass

    def _execute(self, batch) -> None:
        t_form = self._clock()
        xs = [x for x, _, _, _ in batch]
        try:
            results = self._run_batch(xs)
        except Exception as e:  # surface the failure on every waiting future
            self._m_errors.inc(len(batch))
            self._notify(batch, t_form, self._clock(), "error",
                         f"{type(e).__name__}: {e}")
            for _, fut, _, _ in batch:
                fut.set_exception(e)
            return
        t_done = self._clock()
        self.batch_sizes[len(batch)] += 1
        self.n_served += len(batch)
        self._n_batches += 1
        self.execute_s.append(t_done - t_form)
        self._m_batches.inc()
        self._m_batch.observe(len(batch))
        self._m_exec.observe((t_done - t_form) * 1e3)
        for _, _, t0, _ in batch:
            self.queue_waits.append(t_form - t0)
            self.latencies.append(t_done - t0)
            self._m_wait.observe((t_form - t0) * 1e3)
            self._m_latency.observe((t_done - t0) * 1e3)
        for (_, fut, _, _), res in zip(batch, results):
            fut.set_result(res)
        self._notify(batch, t_form, t_done, "ok", None)
        if self._tracer.enabled:
            self._trace_batch(batch, t_form, t_done, self._clock())

    def _trace_batch(self, batch, t_form: float, t_done: float,
                     t_resolved: float) -> None:
        """Emit serve spans for one completed batch: per-request queue-wait +
        execute on a ``req<seq>`` track, plus batch-form / launch / resolve on
        the shared batch track.  Timestamps are the batcher's own clock
        (``time.monotonic`` by default — the tracer's default clock too, so
        these land on the same axis as compile spans)."""
        tr = self._tracer
        bid = self._n_batches
        for _, _, t0, seq in batch:
            track = f"req{seq}"
            tr.add_span("queue_wait", t0, t_form, cat="serve", track=track,
                        args={"batch": bid})
            tr.add_span("execute", t_form, t_done, cat="serve", track=track,
                        args={"batch": bid})
        oldest = min(t0 for _, _, t0, _ in batch)
        tr.add_span("batch_form", oldest, t_form, cat="serve", track="batch",
                    args={"batch": bid, "size": len(batch)})
        tr.add_span("batch_execute", t_form, t_done, cat="serve",
                    track="batch", args={"batch": bid, "size": len(batch)})
        tr.add_span("resolve", t_done, t_resolved, cat="serve", track="batch",
                    args={"batch": bid})
