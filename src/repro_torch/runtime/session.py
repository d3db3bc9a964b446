"""The runtime supporter's unit of ownership: one compiled model, served.

Port of ``src/repro/runtime/session.py``.  A :class:`Session` binds one
(graph, strategy, device model, quantization) tuple to:

* the :class:`~repro_torch.asm.artifact.CompiledArtifact`, obtained through
  a :class:`~repro_torch.asm.artifact.PlanCache` — the serving path compiles
  once and every later construction is a dictionary hit;
* an :class:`~repro_torch.core.executor.Int8Executor` over the artifact's
  lowered ``GroupProgram`` on one ``torch.device``;
* the memory plan + addressed instruction stream, from which
  :meth:`pipeline_report` derives the engine-level cross-request schedule
  (in the planning device model's simulated cycles).

The plan cache keys on the planning ``DeviceModel``, not on the
``torch.device``: a CPU session and a CUDA session of one model share one
artifact, and each executor owns its device.  ``from_artifact`` opens a
saved DNNVM object file with no recompilation.

``run`` serves one request; ``run_batch`` stacks N queued requests into one
batched launch (one kernel grid covers all N images — the executor's batch
dimension is free); ``serve`` wraps the session in the dynamic-batching
:class:`~repro_torch.runtime.server.Server`.  An attached
:class:`~repro_torch.obs.drift.DriftProfiler` counts every launch and
re-times the plan's units every Nth (``attach_drift``).
"""
from __future__ import annotations

import contextlib
import warnings

import torch

# None | DeviceProfile | name/path -> DeviceProfile | None (lazy tune import)
from repro_torch.stages.stages import _resolve_profile


class Session:
    """Owns the compiled artifact and the executor for one compiled model."""

    def __init__(self, g, strategy, dev, qm, *, backend: str = "fused",
                 device=None, cache=None, pin_input: bool | None = None,
                 cache_max_entries: int | None = None, profile=None):
        """``dev`` is the planning device model the strategy was searched
        under; ``device`` is where the executor runs (None: CUDA, which
        raises where CUDA is absent).  ``cache`` is the plan cache to
        compile through (None: ``asm.PLAN_CACHE``); ``pin_input`` forwards
        to the memory planner; ``cache_max_entries`` rebounds that cache.
        ``profile`` names the calibrated device profile to compile under — a
        ``tune.DeviceProfile``, a profile name/path resolved through the
        on-disk ``tune.ProfileCache``, or None (the analytic model; a
        strategy picked by a profile-guided search still keys by the profile
        hash it carries)."""
        from repro_torch import asm
        from repro_torch.core.executor import Int8Executor

        self.profile = _resolve_profile(profile)
        self.cache = cache if cache is not None else asm.PLAN_CACHE
        if cache_max_entries is not None:
            self.cache.max_entries = cache_max_entries
        self.artifact, self.cache_hit = self.cache.get_or_compile(
            g, strategy, dev, qm=qm, profile=self.profile,
            pin_input=pin_input)
        self.graph, self.qm, self.device_model = g, qm, dev
        self.backend = backend
        # "fused" dispatches the artifact's stored program; "ref" walks its
        # groups node by node
        self.executor = Int8Executor(g, qm, strategy=self.artifact,
                                     backend=backend, device=device)
        self.device = self.executor.device
        self.outputs = [n.name for n in g if not g.consumers(n.name)]
        self.n_runs = 0
        self.images_served = 0
        self.drift = None               # optional DriftProfiler (attach_drift)
        self._launch_hook = None        # optional pre-launch hook (chaos)

    @classmethod
    def from_artifact(cls, art, *, backend: str = "fused", cache=None,
                      device=None, profile=None,
                      cache_max_entries: int | None = None) -> "Session":
        """Open a session on a loaded DNNVM object file — no recompilation:
        the artifact is seeded into the plan cache under its own key.

        The artifact records the device-profile hash it was planned under;
        loading it under a *different* profile (or under none, when it was
        profile-planned) warns — the plan was tuned for measured rates this
        deployment may not match."""
        from repro_torch import asm
        from repro_torch.hw import get_device

        resolved = _resolve_profile(profile)
        got = resolved.hash() if resolved is not None else None
        want = art.profile_hash
        if got != want:
            warnings.warn(
                f"artifact was planned under device profile "
                f"{want or 'analytic'} ({art.meta.get('profile_name') or 'n/a'})"
                f" but is being loaded under {got or 'analytic'} — its "
                f"strategy was tuned for measured rates this session may not "
                f"match; recompile under the current profile to re-tune",
                stacklevel=2)
        g = art.rebuild_graph()
        qm = art.quantized_model()
        dev = get_device(art.device)
        cache = cache if cache is not None else asm.PLAN_CACHE
        cache.put(g, art, dev, art, qm=qm, profile=resolved)
        return cls(g, art, dev, qm, backend=backend, device=device,
                   cache=cache, cache_max_entries=cache_max_entries,
                   profile=resolved)

    @property
    def program(self):
        """The lowered ``GroupProgram`` the executor dispatches."""
        return self.artifact.program

    # ------------------------------------------------------------- execution
    def _stack(self, xs, pad_to: int | None = None):
        rows = [torch.as_tensor(x).to(self.device) for x in xs]
        rows = [r[None] if r.dim() == 3 else r for r in rows]
        x = torch.cat(rows, dim=0)
        n = x.shape[0]
        if pad_to is not None and pad_to > n:
            # pad with zero images up to an allowed batch size: bounds the
            # number of distinct batch shapes served
            x = torch.cat([x, x.new_zeros((pad_to - n,) + tuple(x.shape[1:]))])
        return x, n

    def attach_drift(self, profiler) -> None:
        """Attach an ``obs.DriftProfiler``; every ``run``/``run_batch`` then
        counts as one observed launch (the profiler samples every Nth)."""
        self.drift = profiler

    def set_launch_hook(self, fn) -> None:
        """Install (or with None, clear) a pre-launch hook: called with the
        stacked input batch immediately before every executor launch.  An
        exception raised here fails the launch exactly as an executor fault
        would — the seam the chaos injector (``runtime.chaos``) uses to kill,
        hang, slow, or poison one replica deterministically."""
        self._launch_hook = fn

    def _launch(self, x):
        """One executor launch, through the hook and on the session's
        device (the current CUDA device while it runs)."""
        if self._launch_hook is not None:
            self._launch_hook(x)
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            return self.executor(x)

    def drift_state(self) -> dict | None:
        """The attached profiler's most recent summary (None when no drift
        profiler is attached or it has not sampled yet) — what the flight
        recorder stamps onto request records."""
        return self.drift.last if self.drift is not None else None

    def tile_summary(self) -> list[dict]:
        """Launched tile shape per lowered unit.  ``tile`` is the searched
        (t_h, t_w, t_oc), or None when the launcher's own shapes run."""
        from repro_torch.core import lower
        if self.artifact.program is None:
            return []
        out = []
        for item in self.artifact.program.items:
            if isinstance(item, lower.RefFallback):
                out.append({"nodes": "+".join(item.nodes),
                            "kind": "fallback", "tile": None})
            else:
                out.append({"nodes": "+".join(item.nodes), "kind": item.kind,
                            "tile": list(item.tile) if item.tile else None})
        return out

    def run(self, x) -> dict:
        """One request; accepts (H, W, C) or (1, H, W, C) int8."""
        x = torch.as_tensor(x)
        out = self._launch(x[None] if x.dim() == 3 else x)
        self.n_runs += 1
        self.images_served += 1
        if self.drift is not None:
            self.drift.observe_launch()
        return out

    def run_batch(self, xs, pad_to: int | None = None) -> list[dict]:
        """Serve N queued requests as ONE batched launch; returns one output
        dict per request (leading batch dim 1, so results are directly
        comparable with per-request execution).  First the device clock's
        anchor is taken again if it is old (``Tracer.refresh``), so the
        device's completion times keep to the host clock however long the
        session serves.  While the tracer is enabled, the batch's device
        time, from before the stacking's first copy to after its last item,
        is the ``batch`` span of the ``device`` track."""
        from repro_torch.obs.trace import TRACER
        TRACER.refresh(self.device)
        with TRACER.device_span("batch", self.device, cat="serve",
                                n=len(xs), pad_to=pad_to):
            with TRACER.span("pad", cat="serve", track="batch", n=len(xs),
                             pad_to=pad_to):
                x, n = self._stack(xs, pad_to=pad_to)
            with TRACER.span("launch", cat="serve", track="batch",
                             batch=int(x.shape[0])):
                out = self._launch(x)
        self.n_runs += 1
        self.images_served += n
        if self.drift is not None:
            self.drift.observe_launch()
        return [{k: v[i:i + 1] for k, v in out.items()} for i in range(n)]

    def mark_done(self):
        """A mark after the work enqueued so far on the session's device
        (``obs.trace.DeviceMark``: ``query``, ``wait``, ``seconds`` on the
        tracer's clock); None on the CPU, whose work is done when the
        executor returns.  The batcher takes one after each batch."""
        if self.device.type != "cuda":
            return None
        from repro_torch.obs.trace import TRACER
        return TRACER.mark(self.device)

    # -------------------------------------------------------- schedule view
    def pipeline_report(self, n_requests: int, ddr_slots: int | None = 2,
                        profile=None):
        """Engine-level cross-request schedule of ``n_requests`` pipelined
        copies of this session's instruction stream (hazard-audited).  Its
        cycles are the planning device model's simulated cycles (ZU2 on the
        main path), not the card's time.

        ``ddr_slots=None`` selects the double-buffer slot depth from the
        stream's DRAM/compute ratio under ``profile`` (defaulting to the
        profile this session was compiled with)."""
        from repro_torch.runtime.schedule import pipeline_report
        return pipeline_report(self.artifact, n_requests, ddr_slots=ddr_slots,
                               profile=(profile if profile is not None
                                        else self.profile))

    # --------------------------------------------------------------- explain
    def explain(self, *, render: bool = False):
        """This session's compile-decision provenance, joined with live drift.

        Returns the artifact's ``CompileReport`` (``repro_torch.explain``)
        extended with a ``drift`` section when a
        :class:`~repro_torch.obs.drift.DriftProfiler` is attached and has
        samples: per-unit measured-vs-predicted seconds — the static plan's
        predictions next to what this deployment actually measures.
        ``render=True`` returns the text rendering instead."""
        from repro_torch.explain import render_report, report_of
        from repro_torch.obs.events import EVENTS

        rep = dict(report_of(self.artifact))
        drift_rows = None
        if self.drift is not None:
            dr = self.drift.report()
            drift_rows = [{
                "key": u.key.replace("+", "|"),
                "kind": u.kind,
                "predicted": u.predicted,
                "measured": u.measured,
                "deviation": u.deviation,
                "n_samples": u.n_samples,
            } for u in dr.units]
            rep["drift"] = {
                "units": drift_rows,
                "drifted": bool(dr.drifted),
                "aggregate_deviation": dr.aggregate,
                "profile_match": dr.profile_match,
            }
        EVENTS.emit("explain.report",
                    message=f"explain {rep['model']} (session"
                            f"{', with drift' if drift_rows else ''})",
                    model=rep["model"], device=rep["device"],
                    degraded=rep.get("degraded", False),
                    n_drift_units=len(drift_rows or []))
        if render:
            return render_report(rep, drift=drift_rows)
        return rep

    # -------------------------------------------------------------- serving
    def serve(self, **kw):
        from repro_torch.runtime.server import Server
        return Server(self, **kw)

    def stats(self) -> dict:
        return {"n_runs": self.n_runs, "images_served": self.images_served,
                "backend": self.backend, "device": str(self.device),
                "cache_hit": self.cache_hit,
                "cache_hits": self.cache.hits,
                "cache_misses": self.cache.misses,
                "fused_coverage": self.artifact.fused_coverage,
                "n_launches": self.program.meta["n_launches"],
                "n_fallbacks": self.program.meta["n_fallbacks"],
                "sim_cycles_per_image": self.artifact.sim_total_cycles,
                "profile_hash": self.artifact.profile_hash,
                "session_profile_hash": (self.profile.hash()
                                         if self.profile else None),
                "pin_input": self.artifact.pin_input}
