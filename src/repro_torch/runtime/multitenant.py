"""Multi-tenant serving: many compiled models, one device, one front door.

Port of ``src/repro/runtime/multitenant.py``.  The zoo makes artifacts cheap
to hold; this module makes them cheap to *serve together*.  A
:class:`MultiServer` routes per-model request streams to per-model
:class:`~repro_torch.runtime.session.Session`/:class:`~repro_torch.runtime.
server.Server` pairs that share one device — one ``torch.device`` where the
kernels run and one planning ``DeviceModel`` (a session's ``device_model``,
ZU2 on the main path) whose DDR the plans are carved from:

* **DDR partitioning** — every resident model's memory plan claims a
  disjoint region of the planning device's DDR (base offset + its planned
  ``peak_ddr_bytes``); ``add_model`` refuses a model whose footprint would
  overflow the planning device's (or a configured) budget, so co-residency
  is checked at admission time, not discovered as corruption at run time.
  These are the *planned* bytes of the DNNVM memory plan, not the card's
  allocator's;
* **per-tenant SLO classes** — ``slo="gold" | "silver" | "best_effort"``
  maps to a target p99 per Server; the Server's SLO controller then walks each
  tenant's batch cap independently, and its queue-bound vs launch-bound
  shrink split tells an operator *which* tenant needs smaller batches vs
  more capacity;
* **admission control** — beyond ``max_queue`` pending requests a tenant's
  ``submit`` raises :class:`AdmissionError` instead of queueing (counted
  under ``serve.rejected{model=...}``): under overload the backlog is
  bounded and the SLO classes stay meaningful.

All per-model metrics are labelled (``serve.requests{model=vgg16}``), so one
registry snapshot shows every tenant side by side.
"""
from __future__ import annotations


class AdmissionError(RuntimeError):
    """submit() refused: the tenant's queue is at its admission bound."""


# SLO class -> target p99 (ms) handed to the per-tenant Server controller.
# best_effort runs uncontrolled (no target: largest batches, no shrink).
SLO_CLASSES = {"gold": 10.0, "silver": 50.0, "best_effort": None}


class MultiServer:
    """Serve several compiled models on one shared device."""

    def __init__(self, *, ddr_budget_bytes: int | None = None,
                 max_queue: int = 256, slo_classes: dict | None = None,
                 plan_cache_max_entries: int | None = None,
                 flight=None, events=None, burn_kw: dict | None = None):
        """``ddr_budget_bytes`` caps the summed planned footprints of all
        resident models (default: the planning device's ``ddr_bytes``).
        ``max_queue`` is the default per-tenant admission bound.
        ``plan_cache_max_entries`` rebounds the shared ``asm.PLAN_CACHE`` —
        a many-model host sets it to cap resident compiled artifacts.

        The host owns one observability plane for all tenants: ``flight`` is
        the shared :class:`~repro_torch.obs.flight.FlightRecorder` (one is
        created when not given), ``events`` overrides the shared event log, and
        ``burn_kw`` forwards to every per-tenant
        :class:`~repro_torch.obs.slo.BurnRateTracker` (window lengths, budget,
        alert threshold — tests shorten the windows)."""
        from repro_torch.obs.events import EVENTS
        from repro_torch.obs.flight import FlightRecorder
        from repro_torch.obs.metrics import REGISTRY

        self.ddr_budget_bytes = ddr_budget_bytes
        self.max_queue = max_queue
        self.slo_classes = dict(SLO_CLASSES)
        if slo_classes:
            self.slo_classes.update(slo_classes)
        self._models: dict[str, dict] = {}
        # pinned by the first add_model: the planning DeviceModel and the
        # torch.device every tenant's kernels run on
        self._device = None
        self._torch_device = None
        self._registry = REGISTRY
        self._events = events if events is not None else EVENTS
        self.flight = flight if flight is not None else FlightRecorder()
        self._burn_kw = dict(burn_kw) if burn_kw else {}
        self._obs_http = None
        if plan_cache_max_entries is not None:
            from repro_torch import asm
            asm.PLAN_CACHE.max_entries = plan_cache_max_entries

    # ---------------------------------------------------------------- models
    def _as_session(self, model, backend, session_kw):
        """Accept a stages.Compiled, a CompiledArtifact, or a live Session."""
        from repro_torch.asm.artifact import CompiledArtifact
        from repro_torch.runtime.session import Session

        if isinstance(model, Session):
            return model
        if isinstance(model, CompiledArtifact):
            return Session.from_artifact(model, backend=backend, **session_kw)
        art = getattr(model, "artifact", None)      # stages.Compiled
        if isinstance(art, CompiledArtifact):
            return Session.from_artifact(art, backend=backend, **session_kw)
        raise TypeError(f"cannot serve {type(model).__name__}; expected a "
                        "Session, CompiledArtifact, or stages.Compiled")

    def add_model(self, name: str, model, *, slo: str = "best_effort",
                  target_p99_ms: float | None = None,
                  max_queue: int | None = None, backend: str = "fused",
                  session_kw: dict | None = None, **server_kw):
        """Admit one model under ``name`` and start serving it.

        ``slo`` picks the tenant's SLO class (an explicit ``target_p99_ms``
        overrides the class target).  A model given as an artifact or a
        ``stages.Compiled`` opens a session on ``session_kw["device"]``
        (None: CUDA, which raises where CUDA is absent).  Raises
        :class:`MemoryError` when the model's planned DDR footprint does not
        fit the remaining partition budget, and ``ValueError`` on name
        conflicts and on a planning device model or ``torch.device`` other
        than the resident models'."""
        if name in self._models:
            raise ValueError(f"model {name!r} already registered")
        if slo not in self.slo_classes:
            raise ValueError(f"unknown SLO class {slo!r}; have "
                             f"{sorted(self.slo_classes)}")
        session = self._as_session(model, backend, session_kw or {})
        if self._device is None:
            self._device = session.device_model
            self._torch_device = session.device
        elif session.device_model.name != self._device.name:
            raise ValueError(
                f"model {name!r} targets device {session.device_model.name!r}"
                f" but this server hosts {self._device.name!r}")
        elif not _same_device(session.device, self._torch_device):
            raise ValueError(
                f"model {name!r} runs on {session.device} but this server "
                f"hosts {self._torch_device}")

        budget = self.ddr_budget_bytes or self._device.ddr_bytes
        used = sum(m["ddr_bytes"] for m in self._models.values())
        need = int(session.artifact.peak_ddr_bytes)
        if used + need > budget:
            raise MemoryError(
                f"model {name!r} needs {need} B of DDR but only "
                f"{budget - used} of {budget} B remain "
                f"({len(self._models)} resident models)")

        if target_p99_ms is None:
            target_p99_ms = self.slo_classes[slo]
        # per-tenant error-budget burn tracking: every completed request
        # feeds the tracker through the batcher's observer hook; an alert
        # (fast AND slow windows burning hot) freezes the flight ring
        burn = None
        observers = []
        if target_p99_ms is not None:
            from repro_torch.obs.slo import BurnRateTracker
            burn = BurnRateTracker(
                target_p99_ms, labels={"model": name, "class": slo},
                registry=self._registry, events=self._events,
                on_alert=lambda tracker, fast, slow, _n=name:
                    self.flight.trigger(
                        "slo_violation", tenant=_n,
                        detail={"fast_burn": fast, "slow_burn": slow,
                                "target_p99_ms": tracker.target_ms}),
                **self._burn_kw)
            observers.append(burn.observer())
        server = session.serve(target_p99_ms=target_p99_ms,
                               labels={"model": name}, flight=self.flight,
                               events=self._events, observers=observers,
                               **server_kw)
        self.flight.set_context(name, slo_class=slo)
        self._models[name] = {
            "session": session, "server": server, "slo": slo,
            "burn": burn,
            "ddr_base": used, "ddr_bytes": need,
            "max_queue": max_queue if max_queue is not None
            else self.max_queue,
        }
        self._events.emit("tenant.admit", model=name, slo=slo,
                          message=f"model {name!r} admitted "
                                  f"({need} B DDR, class {slo})",
                          ddr_bytes=need, ddr_base=used)
        if self._obs_http is not None:
            self._obs_http.add_explain(name, session.explain)
        return server

    def remove_model(self, name: str, wait: bool = True) -> None:
        m = self._models.pop(name)
        m["server"].close(wait=wait)
        if self._obs_http is not None:
            self._obs_http.remove_explain(name)
        self._events.emit("tenant.remove", model=name,
                          message=f"model {name!r} removed")
        # re-pack the partition: survivors keep their order, bases close up
        base = 0
        for m in self._models.values():
            m["ddr_base"] = base
            base += m["ddr_bytes"]

    def models(self) -> list[str]:
        return list(self._models)

    def attach_drift(self, name: str, **kw):
        """Attach a per-tenant :class:`~repro_torch.obs.drift.DriftProfiler` to
        ``name``'s session, labelled ``{model: name}`` so its gauges land
        next to the tenant's serve metrics on the scrape endpoint.  The
        flight recorder then stamps the tenant's records with the latest
        drift summary.  Returns the profiler (``prepare()`` it before a
        timed window)."""
        from repro_torch.obs.drift import DriftProfiler
        session = self._models[name]["session"]
        kw.setdefault("labels", {"model": name})
        prof = DriftProfiler.from_session(session, **kw)
        session.attach_drift(prof)
        return prof

    # ---------------------------------------------------------------- client
    def submit(self, name: str, x):
        """Enqueue one request for tenant ``name``; returns a future.

        Raises :class:`AdmissionError` (and counts it) when the tenant's
        queue is at its admission bound — overload sheds load here instead
        of letting one hot model starve every SLO."""
        m = self._models[name]
        pending = m["server"]._batcher.pending
        if pending >= m["max_queue"]:
            self._registry.counter("serve.rejected",
                                   {"model": name}).inc()
            self._events.emit("admission.reject", severity="warning",
                              model=name, pending=pending,
                              bound=m["max_queue"],
                              message=f"model {name!r} queue at admission "
                                      f"bound ({pending} pending)")
            self.flight.note_rejection(name, pending, m["max_queue"])
            raise AdmissionError(
                f"model {name!r} queue at admission bound "
                f"({m['max_queue']} pending)")
        return m["server"].submit(x)

    # --------------------------------------------------------------- reports
    def ddr_partition(self) -> list[dict]:
        """The device-DDR carve-up: one disjoint [base, base+bytes) region
        per resident model, in admission order."""
        return [{"model": name, "base": m["ddr_base"],
                 "bytes": m["ddr_bytes"], "slo": m["slo"]}
                for name, m in self._models.items()]

    def stats(self) -> dict:
        budget = (self.ddr_budget_bytes
                  or (self._device.ddr_bytes if self._device else 0))
        # per-tenant counter families come straight off the registry's label
        # index — no hand-formatted "name{model=...}" lookups
        per_tenant = {}
        for family in ("serve.rejected", "serve.requests", "serve.errors"):
            by_model = self._registry.labelled(family)
            per_tenant[family] = {
                name: (by_model[name].value if name in by_model else 0.0)
                for name in self._models}
        rejected = per_tenant["serve.rejected"]
        return {
            "models": {name: m["server"].stats()
                       for name, m in self._models.items()},
            "slo": {name: m["slo"] for name, m in self._models.items()},
            "rejected": rejected,
            "requests": per_tenant["serve.requests"],
            "errors": per_tenant["serve.errors"],
            "burn": {name: (m["burn"].burn_rates() if m["burn"] else None)
                     for name, m in self._models.items()},
            "ddr_partition": self.ddr_partition(),
            "ddr_budget_bytes": budget,
            "ddr_used_bytes": sum(m["ddr_bytes"]
                                  for m in self._models.values()),
        }

    def serve_metrics(self, host: str = "127.0.0.1", port: int = 0):
        """Mount the OpenMetrics scrape endpoint for the whole host: every
        tenant's labelled series, the shared flight recorder, and the event
        log behind one ``/metrics`` (+ ``/flight``, ``/events``,
        ``/snapshot``, per-tenant ``/explain/<model>``).  Returns the running
        :class:`~repro_torch.obs.export.ObsHTTPServer`; closed with the
        host."""
        from repro_torch.obs.export import ObsHTTPServer
        if self._obs_http is None:
            self._obs_http = ObsHTTPServer(
                self._registry, flight=self.flight, events=self._events,
                host=host, port=port)
        # (re)register every resident tenant's explain provider — models
        # admitted after the endpoint came up are picked up on the next call
        for name, m in self._models.items():
            self._obs_http.add_explain(name, m["session"].explain)
        return self._obs_http

    def close(self, wait: bool = True) -> None:
        for m in self._models.values():
            m["server"].close(wait=wait)
        if self._obs_http is not None:
            self._obs_http.close()
            self._obs_http = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _same_device(a, b) -> bool:
    """One ``torch.device`` or two?  An index-less CUDA device is the
    current one."""
    def index(d):
        if d.index is not None or d.type != "cuda":
            return d.index
        import torch
        return torch.cuda.current_device()
    return a.type == b.type and index(a) == index(b)
