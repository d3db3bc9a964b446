"""The closed loop keeps ``outstanding`` requests of one image each in flight
through ``Server.submit``, as a client labelling a corpus does.  When the
oldest request's future resolves, it takes it and every request after it
whose future has resolved too (a batch's futures resolve together), copies
their outputs to the host in one copy (a user receives the class scores
there; a future resolves once its batch is enqueued, so the copy is what
waits for the card), and submits as many next images of the pool.  One copy
per group, not one per answer: each copy waits for all the work enqueued
before it, so answer-by-answer copies wait on the batches launched after
theirs and leave the batcher forming partial batches at random.  Load runs
``warm_s`` before the window opens; the window counts the requests whose
output reached the host inside it.

A load generator is ``loads/<loop>.py``, named by a traffic file's ``loop``;
its ``Load(server, output, pool, traffic)`` has ``run``.
"""
from __future__ import annotations

import collections
import concurrent.futures
import gc
import time

from portbench import serving


class Load:
    def __init__(self, server, output: str, pool: list, traffic: dict):
        if traffic["images_per_request"] != 1:
            raise ValueError("the closed loop sends one-image requests; "
                             f"traffic asks for {traffic}")
        self.server, self.output = server, output
        self.pool, self.outstanding = pool, traffic["outstanding"]

    def run(self, warm_s: float, seconds: float, at=(),
            service=None) -> serving.LoadResult:
        """Load for ``warm_s`` and then the window of ``seconds``.  ``at``
        lists (seconds after the window opens, callable), each called once
        from this thread when a request completes after that time.  While
        ``service.active``, this thread waits in short polls and calls
        ``service.service()`` between them."""
        pending = sorted(at, key=lambda e: e[0])
        inflight: collections.deque = collections.deque()
        lat, answers, failed, completions = [], [], [], []
        n_sent = 0

        def submit():
            nonlocal n_sent
            k = n_sent % len(self.pool)
            n_sent += 1
            inflight.append((self.server.submit(self.pool[k]),
                             time.monotonic(), k))

        gc.collect()
        gc.freeze()         # set-up's objects out of the collector's walks
        t_open = time.monotonic() + warm_s
        t_close = t_open + seconds
        for _ in range(self.outstanding):
            submit()
        while inflight:
            fut = inflight[0][0]
            while service is not None and service.active and not fut.done():
                service.service()
                concurrent.futures.wait([fut], timeout=serving.POLL_S)
            concurrent.futures.wait(
                [fut], timeout=max(0.0, t_close + serving.LATE_S - time.monotonic()))
            if not fut.done():
                break
            group = []
            while inflight and inflight[0][0].done():
                group.append(inflight.popleft())
            ok = []
            for f, t0, k in group:
                if f.exception() is None:
                    ok.append((t0, k, f.result()[self.output]))
                else:
                    e = f.exception()
                    failed.append((k, f"{type(e).__name__}: {e}"))
            host = serving.to_host([a for _, _, a in ok])
            t1 = time.monotonic()
            in_window = t_open <= t1 < t_close
            answers.extend(host(k for _, k, _ in ok))
            if in_window:
                lat.extend(t1 - t0 for t0, _, _ in ok)
                completions.append((t1, len(ok)))
            while pending and t1 >= t_open + pending[0][0]:
                pending.pop(0)[1]()
            if t1 < t_close:
                for _ in group:
                    submit()
        gc.unfreeze()
        return serving.LoadResult(t_open, t_close, lat, answers, failed, len(inflight),
                          completions)
