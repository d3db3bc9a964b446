"""Modeled-vs-measured drift detection: the live calibration check.

Port of ``src/repro/obs/drift.py``.  A :class:`DeviceProfile` is a
snapshot — it priced one device on the day ``tune.calibrate`` ran.
Thermal state, a power cap, a CUDA or PyTorch upgrade, a noisy neighbour,
or a changed artifact all silently invalidate it, and a plan searched under
a stale profile is quietly mis-ranked.  :class:`DriftProfiler` watches for
that at serve time: every ``every``-th launch it re-times each unit of the
compiled plan (``FusedLaunch`` chains/horizontals and ``RefFallback``
groups, through the same ``tune.measure.build_item_callable`` path
calibration used, on the session's ``torch.device`` and with its executor's
prepared launch weights, so a sampling pass uploads none) and compares
against ``tune.evaluator.predict_item_seconds`` — the prediction the plan
was actually ranked by, searched tile shapes included.  On a CUDA device a
unit's time is CUDA-event device time (``tune.measure.time_callable``).

The resulting :class:`DriftReport` carries per-unit relative deviation, the
aggregate (median absolute) deviation versus the paper's 5-10% learned-model
calibration band, and the profile-hash provenance check (does the profile we
are judging against even match the one the artifact was planned under?).
``drifted`` is the boolean the ROADMAP's continuous-autotuning loop consumes
as its re-tune trigger.

Everything heavy is lazy: tune/measure imports happen at first sample, and
:meth:`DriftProfiler.prepare` exists so benchmarks can pay the first-call
costs (kernel build, allocator growth) outside their timed window.
"""
from __future__ import annotations

import dataclasses
import statistics

import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


@dataclasses.dataclass(frozen=True)
class UnitDrift:
    """One plan unit's modeled-vs-measured comparison."""
    key: str                   # "+".join(nodes)
    kind: str                  # "chain" | "horizontal" | "fallback"
    predicted: float           # profile-predicted seconds
    measured: float            # median of recent measured seconds
    n_samples: int

    @property
    def deviation(self) -> float:
        """Signed relative error: (measured - predicted) / predicted."""
        return (self.measured - self.predicted) / self.predicted

    def to_json(self) -> dict:
        return {"key": self.key, "kind": self.kind,
                "predicted": self.predicted, "measured": self.measured,
                "deviation": self.deviation, "n_samples": self.n_samples}


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """Aggregate drift verdict for one (artifact, profile) pair."""
    units: tuple               # UnitDrift per comparable unit
    skipped: tuple             # (key, reason) for units with no prediction
    aggregate: float | None    # median |deviation| across units
    band: float                # drift threshold the verdict uses
    calibration_band: tuple    # the paper's learned-model band (5-10%)
    profile_deviation: float   # the profile's own fit residual
    profile_hash: str
    artifact_profile_hash: str | None
    n_observed: int            # launches seen by observe_launch()
    n_sampled: int             # sampling passes actually taken

    @property
    def profile_match(self) -> bool:
        return (self.artifact_profile_hash is None
                or self.artifact_profile_hash == self.profile_hash)

    @property
    def drifted(self) -> bool:
        """True when measured unit times left the acceptance band — the
        signal that the profile (and any plan ranked under it) is stale."""
        if self.aggregate is None:
            return not self.profile_match
        return self.aggregate > self.band or not self.profile_match

    def to_json(self) -> dict:
        return {
            "units": [u.to_json() for u in self.units],
            "skipped": [list(s) for s in self.skipped],
            "aggregate_deviation": self.aggregate,
            "band": self.band,
            "calibration_band": list(self.calibration_band),
            "profile_deviation": self.profile_deviation,
            "profile_hash": self.profile_hash,
            "artifact_profile_hash": self.artifact_profile_hash,
            "profile_match": self.profile_match,
            "drifted": self.drifted,
            "n_observed": self.n_observed,
            "n_sampled": self.n_sampled,
        }


def _unit_key(item) -> str:
    return "+".join(item.nodes)


def _unit_kind(item) -> str:
    from repro_torch.core import lower
    if isinstance(item, lower.RefFallback):
        return "fallback"
    return item.kind


class DriftProfiler:
    """Sampling per-unit profiler for a compiled plan.

    ``observe_launch()`` is the serve-path hook: cheap counter bump, and every
    ``every``-th call runs one :meth:`sample` pass timing each plan unit.
    ``measure_fn(item) -> seconds`` can be injected for deterministic tests
    (e.g. the cycle simulator that generated the profile, or a perturbed
    version of it); the default times the real unit callables on
    ``device`` (None: CUDA, resolved at the first measurement).

    ``dev`` is the planning ``DeviceModel`` the predictions price under;
    ``prepared`` is the executor's prepared launch weights, one entry per
    program item (``Int8Executor._prepared``), reused by every sampling pass.
    """

    def __init__(self, g, qm, artifact, dev, profile, *, every: int = 64,
                 warmup: int = 1, repeats: int = 3, band: float | None = None,
                 measure_fn=None, device=None, prepared=None,
                 window: int = 8, registry=None, labels: dict | None = None):
        if every < 1:
            raise ValueError("every must be >= 1")
        if artifact.program is None:
            raise ValueError("artifact carries no lowered program "
                             "(ref-backend plans have no units to profile)")
        self.g, self.qm, self.artifact = g, qm, artifact
        self.dev, self.profile = dev, profile
        self.every = every
        self.warmup, self.repeats = warmup, repeats
        self.measure_fn = measure_fn
        self.device = device
        self._prep = {}
        if prepared is not None:
            self._prep = {_unit_key(item): p for item, p in
                          zip(artifact.program.items, prepared)
                          if p is not None}
        self.window = window
        self.registry = (registry if registry is not None
                         else obs_metrics.REGISTRY)
        # ``labels`` tags every emitted gauge (multi-tenant serving labels
        # per-model: ``drift.median_deviation{model=vgg16}``)
        self.labels = dict(labels) if labels else None
        # cheap summary of the most recent report — the flight recorder
        # attaches this to request records without re-pricing any unit
        self.last: dict | None = None
        self._was_drifted = False
        # acceptance: twice the profile's own fit residual, floored at the
        # calibrate ACCEPT_BAND — jitter within the fit's noise is not drift
        if band is None:
            from repro_torch.tune.calibrate import ACCEPT_BAND
            band = max(ACCEPT_BAND, 2.0 * profile.deviation)
        self.band = band
        self.n_observed = 0
        self.n_sampled = 0
        self._callables: dict[str, tuple] = {}
        self._predicted: dict[str, float] = {}
        self._skipped: list[tuple] = []
        self._samples: dict[str, list] = {}
        self._units: list | None = None     # resolved lazily

    @classmethod
    def from_session(cls, session, **kw):
        """Build from a runtime ``Session``: its graph, quant map, artifact,
        planning device model (``device_model``), resolved profile, and the
        ``torch.device`` and prepared launch weights of its executor."""
        profile = kw.pop("profile", None) or session.profile
        if profile is None:
            raise ValueError("session has no device profile; pass profile=")
        kw.setdefault("device", session.device)
        kw.setdefault("prepared", session.executor._prepared)
        return cls(session.graph, session.qm, session.artifact,
                   session.device_model, profile, **kw)

    # ------------------------------------------------------------ unit setup
    def _resolve_units(self) -> list:
        """Plan units with a finite prediction; the rest go to ``skipped``."""
        if self._units is not None:
            return self._units
        from repro_torch.tune.evaluator import predict_item_seconds
        units = []
        for item in self.artifact.program.items:
            key = _unit_key(item)
            pred = predict_item_seconds(self.profile, self.g, self.dev, item)
            if pred is None or pred <= 0:
                self._skipped.append((key, "no finite prediction"))
                continue
            self._predicted[key] = pred
            units.append(item)
        self._units = units
        return units

    def _callable(self, item) -> tuple:
        from repro_torch.tune.measure import build_item_callable
        key = _unit_key(item)
        if key not in self._callables:
            self._callables[key] = build_item_callable(
                self.g, self.qm, item, device=self.device,
                prepared=self._prep.get(key))
        return self._callables[key]

    def prepare(self) -> None:
        """Build + warm every unit callable now, so the first sampling pass
        inside a timed serving window measures steady-state kernels rather
        than first-call costs."""
        if self.measure_fn is not None:
            return
        from repro_torch.core.executor import resolve_device
        dev = resolve_device(self.device)
        for item in self._resolve_units():
            fn, ins = self._callable(item)
            for _ in range(max(1, self.warmup)):
                fn(*ins)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # -------------------------------------------------------------- sampling
    def observe_launch(self) -> bool:
        """Serve-path hook; returns True when this call triggered a sampling
        pass (the ``every``-th observation, starting at the ``every``-th)."""
        self.n_observed += 1
        if self.n_observed % self.every:
            return False
        self.sample()
        return True

    def _measure(self, item) -> float:
        if self.measure_fn is not None:
            return float(self.measure_fn(item))
        from repro_torch.tune.measure import time_callable
        fn, ins = self._callable(item)
        seconds, _, _, _, _ = time_callable(fn, ins, warmup=self.warmup,
                                            repeats=self.repeats)
        return seconds

    def sample(self) -> None:
        """Time every unit once and fold into the per-unit sample windows."""
        with obs_trace.TRACER.span("drift_sample", cat="drift",
                                   track="drift"):
            for item in self._resolve_units():
                key = _unit_key(item)
                sec = self._measure(item)
                buf = self._samples.setdefault(key, [])
                buf.append(sec)
                del buf[:-self.window]
        self.n_sampled += 1
        self.registry.counter("drift.samples", self.labels).inc()
        rep = self.report()
        if rep.aggregate is not None:
            self.registry.gauge("drift.aggregate_deviation",
                                self.labels).set(rep.aggregate)
            self.registry.gauge("drift.drifted",
                                self.labels).set(float(rep.drifted))
            # the scrape-facing pair: per-model median deviation + trip bit,
            # so MultiServer tenants expose drift without anyone polling
            # report() objects
            self.registry.gauge("drift.median_deviation",
                                self.labels).set(rep.aggregate)
            self.registry.gauge("drift.tripped",
                                self.labels).set(float(rep.drifted))
        self.last = {"aggregate": rep.aggregate, "drifted": rep.drifted,
                     "band": rep.band, "profile_match": rep.profile_match,
                     "n_sampled": rep.n_sampled}
        if rep.drifted and not self._was_drifted:
            from repro_torch.obs.events import EVENTS
            EVENTS.emit("drift.trip", severity="warning",
                        message="measured unit times left the acceptance "
                                "band; plan ranking may be stale",
                        aggregate=rep.aggregate, band=rep.band,
                        profile_match=rep.profile_match,
                        **(self.labels or {}))
        self._was_drifted = bool(rep.drifted)

    # --------------------------------------------------------------- verdict
    def report(self) -> DriftReport:
        from repro_torch.tune.calibrate import PAPER_MODEL_BAND
        units = []
        for item in self._resolve_units():
            key = _unit_key(item)
            samples = self._samples.get(key)
            if not samples:
                continue
            units.append(UnitDrift(
                key=key, kind=_unit_kind(item),
                predicted=self._predicted[key],
                measured=statistics.median(samples),
                n_samples=len(samples)))
        aggregate = (statistics.median(abs(u.deviation) for u in units)
                     if units else None)
        return DriftReport(
            units=tuple(units), skipped=tuple(self._skipped),
            aggregate=aggregate, band=self.band,
            calibration_band=tuple(PAPER_MODEL_BAND),
            profile_deviation=self.profile.deviation,
            profile_hash=self.profile.hash(),
            artifact_profile_hash=self.artifact.profile_hash,
            n_observed=self.n_observed, n_sampled=self.n_sampled)
