# Copied from src/repro/obs/slo.py; imports point at repro_torch.
"""Per-tenant SLO error-budget burn-rate tracking (fast + slow windows).

A latency SLO of the form "99% of requests complete under ``target_ms``"
grants an *error budget*: 1% of requests may violate.  The operational
question is never "did one request violate" (one always will) but "how fast
is the budget burning": a burn rate of 1.0 consumes exactly the budget; 10.0
exhausts a day's budget in 2.4 hours.  :class:`BurnRateTracker` implements
the standard multi-window form — the violation fraction over a short *fast*
window (seconds of serving: catches pages-worthy regressions quickly) and a
longer *slow* window (smooths blips) — and alerts only when **both** exceed
``alert_burn``: the fast window gives low detection latency, the slow window
vetoes one-batch transients.

Every observation updates the ``slo.burn_rate{...,window=fast|slow}`` gauges
(the labels carry the tenant's ``model`` and SLO ``class``), so the scrape
endpoint exposes live burn next to the latency histograms.  An alert emits
an ``slo.alert`` event (severity ``error``), bumps ``slo.alerts``, and calls
the ``on_alert`` hook — the multi-tenant server wires that to the flight
recorder, so the forensic dump lands the moment the budget catches fire.
Alerts are rate-limited by ``cooldown_s``; clocks are injectable so the
window math is unit-testable under synthetic violation schedules.
"""
from __future__ import annotations

import collections
import threading
import time


class BurnRateTracker:
    """Error-budget burn rate for one (tenant, SLO target) pair."""

    def __init__(self, target_ms: float, *, budget: float = 0.01,
                 fast_window_s: float = 30.0, slow_window_s: float = 300.0,
                 alert_burn: float = 2.0, min_samples: int = 8,
                 cooldown_s: float = 30.0, max_samples: int = 16384,
                 labels: dict | None = None, registry=None, events=None,
                 on_alert=None, clock=time.monotonic):
        if target_ms <= 0:
            raise ValueError("target_ms must be > 0")
        if not 0 < budget < 1:
            raise ValueError("budget must be in (0, 1)")
        if fast_window_s >= slow_window_s:
            raise ValueError("fast window must be shorter than slow window")
        self.target_ms = float(target_ms)
        self.budget = float(budget)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.alert_burn = float(alert_burn)
        self.min_samples = min_samples
        self.cooldown_s = cooldown_s
        self.labels = dict(labels) if labels else None
        self.on_alert = on_alert
        self._clock = clock
        self._samples: collections.deque = collections.deque(
            maxlen=max_samples)                     # (t, violated)
        self._lock = threading.Lock()
        self._last_alert: float | None = None
        self.n_observed = 0
        self.n_violations = 0
        self.n_alerts = 0
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

    # ------------------------------------------------------------ window math
    def _rate(self, window_s: float, now: float) -> tuple[float, int]:
        """(burn rate, samples considered) over the trailing window — the
        violation fraction divided by the error budget."""
        lo = now - window_s
        n = bad = 0
        for t, violated in reversed(self._samples):
            if t < lo:
                break
            n += 1
            bad += violated
        if n == 0:
            return 0.0, 0
        return (bad / n) / self.budget, n

    def burn_rates(self, now: float | None = None) -> dict:
        """Current fast/slow burn rates (and their sample counts)."""
        now = self._clock() if now is None else now
        with self._lock:
            fast, n_fast = self._rate(self.fast_window_s, now)
            slow, n_slow = self._rate(self.slow_window_s, now)
        return {"fast": fast, "slow": slow,
                "n_fast": n_fast, "n_slow": n_slow}

    # ------------------------------------------------------------ observation
    def observe(self, latency_ms: float, *, t: float | None = None) -> bool:
        """Fold one served request in; returns True when this observation
        fired an alert (both windows burning past ``alert_burn``, enough
        samples, outside the cooldown)."""
        now = self._clock() if t is None else t
        violated = latency_ms > self.target_ms
        with self._lock:
            self._samples.append((now, violated))
            self.n_observed += 1
            self.n_violations += violated
            fast, n_fast = self._rate(self.fast_window_s, now)
            slow, n_slow = self._rate(self.slow_window_s, now)
            firing = (n_fast >= self.min_samples
                      and fast >= self.alert_burn
                      and slow >= self.alert_burn
                      and (self._last_alert is None
                           or now - self._last_alert >= self.cooldown_s))
            if firing:
                self._last_alert = now
                self.n_alerts += 1
        reg = self._reg()
        reg.gauge("slo.burn_rate",
                  {**(self.labels or {}), "window": "fast"}).set(fast)
        reg.gauge("slo.burn_rate",
                  {**(self.labels or {}), "window": "slow"}).set(slow)
        if firing:
            reg.counter("slo.alerts", self.labels).inc()
            self._evt().emit(
                "slo.alert", severity="error",
                message=f"error budget burning at {fast:.1f}x (fast) / "
                        f"{slow:.1f}x (slow); target {self.target_ms} ms",
                target_ms=self.target_ms, fast_burn=fast, slow_burn=slow,
                latency_ms=latency_ms, **(self.labels or {}))
            if self.on_alert is not None:
                try:
                    self.on_alert(self, fast, slow)
                except Exception:   # alerting must never take down serving
                    pass
        return firing

    def observer(self):
        """A batcher observer feeding this tracker: reads ``latency_s`` off
        the per-request record dict."""
        def observe(rec: dict) -> None:
            if rec.get("status") == "ok":
                self.observe(rec["latency_s"] * 1e3)
        return observe

    # --------------------------------------------------------------- reporting
    def snapshot(self) -> dict:
        rates = self.burn_rates()
        return {"target_ms": self.target_ms, "budget": self.budget,
                "alert_burn": self.alert_burn,
                "fast_window_s": self.fast_window_s,
                "slow_window_s": self.slow_window_s,
                "n_observed": self.n_observed,
                "n_violations": self.n_violations,
                "n_alerts": self.n_alerts, **rates}
