# Copied from src/repro/distributed/health.py; imports point at repro_torch;
# ``shardings`` reaches the port's store as ``placements=``.
"""Fault-tolerance plumbing: heartbeats, straggler detection, retry loop.

At thousand-node scale the failure model is: (a) hosts vanish (heartbeat
timeout -> elastic re-mesh + checkpoint restore), (b) hosts straggle
(step-time outliers -> flagged for replacement before they stall the
collectives).  Both detectors are deterministic pure-python on injectable
clocks, so they unit-test without a cluster; the launcher
(``run_with_retries``) is the loop a cluster scheduler would call per-host.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict


@dataclasses.dataclass
class HostState:
    last_beat: float
    step_ema: float = 0.0
    beats: int = 0


class HeartbeatMonitor:
    def __init__(self, timeout_s: float = 60.0, clock=time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        self.hosts: dict[str, HostState] = {}

    def beat(self, host: str, step_time_s: float | None = None) -> None:
        now = self.clock()
        st = self.hosts.setdefault(host, HostState(last_beat=now))
        st.last_beat = now
        st.beats += 1
        if step_time_s is not None:
            a = 0.2 if st.step_ema else 1.0
            st.step_ema = (1 - a) * st.step_ema + a * step_time_s

    def forget(self, host: str) -> None:
        """Drop a host's state entirely.  An evicted replica must leave the
        fleet's statistics — its stale EWMA would otherwise skew the straggler
        median and its stale beat would keep re-reporting it dead."""
        self.hosts.pop(host, None)

    def dead(self) -> list[str]:
        now = self.clock()
        return [h for h, s in self.hosts.items()
                if now - s.last_beat > self.timeout]

    def stragglers(self, factor: float = 1.5) -> list[str]:
        """Hosts whose step-time EWMA exceeds factor x the fleet median."""
        emas = sorted(s.step_ema for s in self.hosts.values() if s.step_ema)
        if len(emas) < 3:
            return []
        median = emas[len(emas) // 2]
        return [h for h, s in self.hosts.items()
                if s.step_ema > factor * median]


class RetryPolicy:
    def __init__(self, max_restarts: int = 10, window_s: float = 3600.0,
                 clock=time.monotonic):
        self.max_restarts, self.window = max_restarts, window_s
        self.clock = clock
        self.restarts: list[float] = []

    def should_retry(self) -> bool:
        now = self.clock()
        self.restarts = [t for t in self.restarts if now - t < self.window]
        return len(self.restarts) < self.max_restarts

    def record(self) -> None:
        self.restarts.append(self.clock())


def run_with_retries(make_state, run_fn, ckpt_store, policy: RetryPolicy,
                     abstract_state, shardings=None):
    """Launcher loop: run -> on failure restore latest checkpoint -> retry.

    ``run_fn(state, start_step) -> (state, completed)`` raises on failure.
    ``shardings`` (``shard.named(...)`` of the state's specs) places the
    restored state on the mesh they name.
    """
    restored = ckpt_store.restore_latest(abstract_state,
                                         placements=shardings)
    state, start = restored if restored is not None else (make_state(), 0)
    while True:
        try:
            return run_fn(state, start)
        except Exception:
            if not policy.should_retry():
                raise
            policy.record()
            restored = ckpt_store.restore_latest(abstract_state,
                                                 placements=shardings)
            state, start = (restored if restored is not None
                            else (make_state(), 0))
