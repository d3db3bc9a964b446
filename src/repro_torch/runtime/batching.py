# Port of src/repro/runtime/batching.py; completion is the device's, below.
"""Async dynamic-batching front end for the runtime supporter.

Requests arrive one image at a time; the accelerator is happiest launching
once per *batch* (one kernel grid covers all N images).  The
:class:`DynamicBatcher` sits between the two: ``submit`` enqueues a request
and returns a future immediately, a single worker drains the queue into
batches bounded by two knobs —

* ``max_batch``     — never launch more than this many images at once;
* ``max_latency_s`` — never hold the *oldest* queued request longer than
  this before flushing a partial batch.

The worker owns all executor calls (device dispatch stays single-threaded).
A future resolves once its batch is enqueued, with results that may still
be computing on the device (reading them waits for it).  A request's
*completion* is the device's: with a ``mark_done`` the worker marks the
device's stream after each batch and keeps the batch in flight until the
mark has passed, checking at the top of each loop iteration, without
blocking; without one (the CPU) completion is the executor's return.  Only
then are the request's record, latency windows, histograms and observers
fed.  ``close()`` drains outstanding requests, completes every batch in
flight and joins the worker; submitting after close raises
:class:`BatcherClosed`.
"""
from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import DEFAULT_BATCH_BUCKETS

# how often an idle worker with batches in flight checks their completion
POLL_S = 1e-3


class BatcherClosed(RuntimeError):
    """submit() after close()."""


class DynamicBatcher:
    def __init__(self, run_batch, *, max_batch: int = 8,
                 max_latency_s: float = 2e-3, clock=time.monotonic,
                 latency_window: int = 16384, registry=None, tracer=None,
                 labels: dict | None = None, observers=None,
                 mark_done=None):
        """``run_batch(xs) -> list[result]`` executes one batch (one result
        per request, same order).  ``mark_done()``, called right after it,
        returns a mark of the device's stream (``query()``, ``wait()``,
        ``seconds()`` on ``clock``; ``Session.mark_done``) or None where
        the batch is done when ``run_batch`` returns.  ``latency_window``
        bounds the retained latency samples (a long-running server must not
        grow without bound).

        Besides end-to-end ``latencies`` (submit -> device completion), the
        batcher keeps ``queue_waits`` (submit -> batch formed, per request)
        and ``execute_s`` (batch formed -> executor return, per batch: host
        time) so an SLO controller can tell a queue-bound p99 violation
        from a launch-bound one.  All three, the histograms and the
        observers are fed from one record per request when its batch
        completes.  ``labels`` tags every emitted metric (multi-tenant
        serving labels per-model: ``serve.requests{model=vgg16}``).

        When the shared tracer is enabled, the ``batch`` track holds what
        the worker thread does: ``batch_form`` (from the moment it starts
        waiting for a batch's requests until it pops them),
        ``batch_execute`` (the executor call; the session adds ``pad`` and
        ``launch`` inside it), ``resolve`` (resolving the futures) and
        ``complete`` (building a completed batch's records and running the
        observers).  Every span of a batch, the executor's device spans
        too, carries its ``batch_id``; each formed batch takes the next id,
        a failed one too.

        ``observers`` are callables invoked on the worker thread once per
        request when its batch completes, in the order the batches were
        formed (a failed batch completes when it fails, after waiting for
        the batches before it), with one record dict: ``req_id``, ``submit_s``, ``queue_wait_s``,
        ``execute_s``, ``latency_s`` (submit -> completion), ``done_s``
        (the completion on ``clock``; it can precede the executor's return,
        which the host reaches after enqueuing), ``batch_id``,
        ``batch_size``, ``batch_members``, ``status`` ("ok" | "error"),
        ``error``.  The flight recorder and the SLO burn-rate tracker plug
        in here; observer exceptions are swallowed — observability must
        not break serving."""
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
        self._seq = 0                    # request sequence id (req_id)
        self._n_batches = 0
        self._mark_done = mark_done
        self._inflight: collections.deque = collections.deque()
        self.batch_sizes: collections.Counter = collections.Counter()
        self.n_served = 0
        # submit -> completion per request, most recent latency_window
        # samples; without a mark_done recorded BEFORE the future resolves,
        # so a caller reading stats right after result() returns never sees
        # a partial sample set
        self.latencies: collections.deque = collections.deque(
            maxlen=latency_window)
        # submit -> batch formation, per request (same window discipline)
        self.queue_waits: collections.deque = collections.deque(
            maxlen=latency_window)
        # batch formation -> executor return, per BATCH
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
        """Flush whatever is queued, complete every batch in flight (waiting
        for the device), then stop the worker.  Idempotent; with an empty
        queue and nothing in flight this returns as soon as the worker
        observes the flag.  ``timeout_s`` bounds the join (the fleet closes
        possibly-wedged replicas without hanging its own shutdown)."""
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
        t_wait = None
        while True:
            self._complete_ready()
            if t_wait is None:          # the worker starts waiting for a batch
                t_wait = self._clock()
            with self._cv:
                if not self._queue and not self._closed:
                    # while batches are in flight, wake to complete them
                    self._cv.wait(timeout=POLL_S if self._inflight else None)
                if not self._queue:
                    if self._closed:     # closed and drained
                        break
                    continue
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
            self._execute(batch, t_wait)
            t_wait = None
        self._complete_ready(wait=True)

    def add_observer(self, fn) -> None:
        """Register a per-request completion observer (see ``observers``)."""
        self._observers.append(fn)

    def _execute(self, batch, t_wait: float) -> None:
        tr = self._tracer
        t_form = self._clock()
        self._n_batches += 1
        b = _Batch(batch, self._n_batches, t_form)
        tr.add_span("batch_form", t_wait, t_form, cat="serve", track="batch",
                    args={"batch_id": b.bid, "size": len(batch)})
        try:
            with tr.context(batch_id=b.bid):
                results = self._run_batch([x for x, _, _, _ in batch])
                if self._mark_done is not None:
                    b.mark = self._mark_done()
        except Exception as e:  # surface the failure on every waiting future
            b.t_ret = self._clock()
            b.error = f"{type(e).__name__}: {e}"
            self._m_errors.inc(len(batch))
            # observers see it after every earlier batch, in launch order
            self._inflight.append(b)
            self._complete_ready(wait=True)
            for _, fut, _, _ in batch:
                fut.set_exception(e)
            return
        b.t_ret = self._clock()
        tr.add_span("batch_execute", t_form, b.t_ret, cat="serve",
                    track="batch", args={"batch_id": b.bid,
                                         "size": len(batch)})
        self._inflight.append(b)
        if b.mark is None:              # done when the executor returned
            self._complete_ready()
        t0 = self._clock()
        for (_, fut, _, _), res in zip(batch, results):
            fut.set_result(res)
        tr.add_span("resolve", t0, self._clock(), cat="serve", track="batch",
                    args={"batch_id": b.bid})

    def _complete_ready(self, wait: bool = False) -> None:
        """Complete the batches in flight whose device work has finished, in
        launch order; with ``wait``, all of them.  A batch without a mark
        (failed, or done when the executor returned) is complete once the
        batches before it are."""
        while self._inflight:
            b = self._inflight[0]
            if b.mark is not None:
                if wait:
                    b.mark.wait()
                elif not b.mark.query():
                    return
            self._inflight.popleft()
            self._complete(b)

    def _complete(self, b: "_Batch") -> None:
        """One batch's device work has finished (or the batch failed): build
        each request's record and feed the latency windows, the histograms
        and the observers (a failed batch only the observers)."""
        t0 = self._clock()
        done_s = b.mark.seconds() if b.mark is not None else b.t_ret
        if b.error is not None:
            recs = self._records(b, done_s, "error", b.error)
        else:
            recs = self._records(b, done_s, "ok", None)
            self.batch_sizes[len(recs)] += 1
            self.n_served += len(recs)
            self.execute_s.append(b.t_ret - b.t_form)
            self._m_batches.inc()
            self._m_batch.observe(len(recs))
            self._m_exec.observe((b.t_ret - b.t_form) * 1e3)
            for rec in recs:
                self.queue_waits.append(rec["queue_wait_s"])
                self.latencies.append(rec["latency_s"])
                self._m_wait.observe(rec["queue_wait_s"] * 1e3)
                self._m_latency.observe(rec["latency_s"] * 1e3)
        self._notify(recs)
        self._tracer.add_span("complete", t0, self._clock(), cat="serve",
                              track="batch", args={"batch_id": b.bid})

    @staticmethod
    def _records(b: "_Batch", done_s: float, status: str,
                 error: str | None) -> list[dict]:
        members = tuple(seq for _, _, _, seq in b.batch)
        return [{"req_id": seq, "submit_s": t0,
                 "queue_wait_s": b.t_form - t0,
                 "execute_s": b.t_ret - b.t_form,
                 "latency_s": done_s - t0, "done_s": done_s,
                 "batch_id": b.bid, "batch_size": len(b.batch),
                 "batch_members": members, "status": status, "error": error}
                for _, _, t0, seq in b.batch]

    def _notify(self, recs: list[dict]) -> None:
        for rec in recs:
            for fn in self._observers:
                try:
                    fn(rec)
                except Exception:    # observers must never break serving
                    pass


class _Batch:
    """A formed batch on its way through the worker: its requests, id,
    formation and executor-return times, its completion mark, and its
    error if it failed."""
    __slots__ = ("batch", "bid", "t_form", "t_ret", "mark", "error")

    def __init__(self, batch: list, bid: int, t_form: float):
        self.batch, self.bid, self.t_form = batch, bid, t_form
        self.t_ret = t_form
        self.mark = self.error = None
