# Copied from src/repro/stages/stages.py; imports point at repro_torch.
"""Explicit compile stages: Wrapped -> Lowered -> Planned -> Compiled.

The monolithic ``asm.compile_strategy`` call becomes four first-class,
individually-cacheable objects (the JaCe ``Wrapped -> Lowered -> Compiled``
stage protocol, grown a ``Planned`` stage because DNNVM's memory planner is
a real phase with its own knobs):

* :class:`Wrapped`  — XGraph + quantized params + target device.  The
  immutable compilation *input*; its ``key`` hashes graph structure,
  quantization fingerprint, and device name.
* :class:`Lowered`  — a searched ``pathsearch.Strategy`` plus the lowered
  backend ``GroupProgram``.  Re-tuning tiles or swapping the device profile
  produces a new ``Lowered`` without touching ``Wrapped``.
* :class:`Planned`  — memory plan + addressed instruction stream for one
  (pin_input, DDR budget) choice.  Re-planning for a different budget reuses
  the search and the lowering.
* :class:`Compiled` — the ``CompiledArtifact`` object file, ready for a
  runtime ``Session`` or the on-disk model zoo.

Every stage has a stable content hash (``key``) chaining its upstream
stage's key with exactly the inputs that stage adds, so equal inputs reach
equal keys in any process — the zoo's content addresses and the stage
cache's identity both hang off these.  Stage transitions accept a
``StageCache`` (default: the shared ``STAGE_CACHE``; pass ``cache=None``
for pure recomputation, which is how ``asm.compile_strategy`` keeps its
original one-call semantics).
"""
from __future__ import annotations

import dataclasses

from repro_torch.asm import artifact as _art
from repro_torch.core import lower as _lower
from repro_torch.core import pathsearch
from repro_torch.core.quantize import QuantizedModel
from repro_torch.core.xgraph import XGraph
from repro_torch.hw import DeviceModel
from repro_torch.stages.cache import STAGE_CACHE, StageCache, _through

# "use the cache this stage was built through" marker for stage methods
_INHERIT = object()


def _resolve_cache(cache, inherited):
    if cache is _INHERIT:
        return inherited
    return cache


def _resolve_profile(profile):
    """None | DeviceProfile | name/path -> DeviceProfile | None (lazy tune
    import, same contract as runtime.session)."""
    if profile is None:
        return None
    from repro_torch.tune.profile import resolve_profile
    return resolve_profile(profile)


def _quant_signature_of(qm) -> str:
    return _art.quant_signature(qm)


# ------------------------------------------------------------------- wrapped
@dataclasses.dataclass
class Wrapped:
    """Stage 1: the compilation input — graph, quantized params, device."""
    graph: XGraph
    qm: QuantizedModel | None
    device: DeviceModel
    key: str
    _cache: object = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def graph_sig(self) -> str:
        return _art.graph_signature(self.graph)

    def lower(self, *, strategy=None, profile=None, profile_hash: str | None
              = None, evaluator=None, device_of=None,
              enable_horizontal: bool = True, cache=_INHERIT) -> "Lowered":
        """Search an execution strategy (or adopt a given one) and lower it
        to the backend ``GroupProgram``.

        ``profile`` resolves like everywhere else (DeviceProfile | name |
        path | None); when given and no ``evaluator`` is passed, the search
        runs under a ``tune.CalibratedEvaluator``.  ``profile_hash`` carries
        provenance when only the hash of the planning profile is known (a
        reloaded artifact).  ``device_of`` is the host/accelerator partition
        function (``core.partition.device_of``)."""
        cache = _resolve_cache(cache, self._cache)
        resolved = _resolve_profile(profile)
        ph = resolved.hash() if resolved is not None else profile_hash
        pname = resolved.name if resolved is not None else None

        if strategy is not None:
            ck = ("given", self.key, _art.strategy_signature(strategy),
                  ph or "analytic")
            return self._build_lowered(ck, strategy, resolved, ph, pname,
                                       cache)

        # deterministic fingerprint of the host/accelerator partition: the
        # set of host nodes is what the search actually consumes
        host = (sorted(n.name for n in self.graph
                       if n.op != "input" and device_of(n.name) != "acc")
                if device_of is not None else [])
        ck = ("search", self.key, ph or "analytic", _art._sha(host),
              bool(enable_horizontal))

        def build():
            ev = evaluator
            if ev is None and resolved is not None:
                from repro_torch.tune import CalibratedEvaluator
                ev = CalibratedEvaluator(self.graph, self.device, resolved)
            strat = pathsearch.search(self.graph, self.device, evaluator=ev,
                                      device_of=device_of,
                                      enable_horizontal=enable_horizontal)
            return self._make_lowered(strat, resolved, ph, pname, cache)

        obj, _ = _through(cache, "lowered", ck, build)
        return obj

    def _build_lowered(self, ck, strategy, resolved, ph, pname, cache):
        obj, _ = _through(cache, "lowered", ck,
                          lambda: self._make_lowered(strategy, resolved, ph,
                                                     pname, cache))
        return obj

    def _make_lowered(self, strategy, resolved, ph, pname, cache):
        from repro_torch.obs.trace import TRACER
        with TRACER.span("lower", cat="compile", track="compile"):
            program = _lower.lower_strategy(self.graph, strategy, self.qm)
        key = _art._sha([self.key, _art.strategy_signature(strategy),
                         ph or "analytic"])
        return Lowered(wrapped=self, strategy=strategy, program=program,
                       profile=resolved, profile_hash=ph, profile_name=pname,
                       key=key, _cache=cache)


def wrap(g: XGraph, qm: QuantizedModel | None, dev: DeviceModel, *,
         cache: StageCache | None = _INHERIT) -> Wrapped:
    """Open the staged pipeline on (graph, quantized params, device).

    The default cache is the shared ``STAGE_CACHE`` (so repeated wraps of
    identical inputs share one stage object); ``cache=None`` disables
    memoization for this pipeline walk."""
    if cache is _INHERIT:
        cache = STAGE_CACHE
    key = _art._sha([_art.graph_signature(g), _quant_signature_of(qm),
                     dev.name])
    obj, _ = _through(cache, "wrapped", key,
                      lambda: Wrapped(graph=g, qm=qm, device=dev, key=key,
                                      _cache=cache))
    return obj


# ------------------------------------------------------------------- lowered
@dataclasses.dataclass
class Lowered:
    """Stage 2: searched strategy + lowered backend program."""
    wrapped: Wrapped
    strategy: object                 # pathsearch.Strategy (or duck-typed)
    program: object                  # lower.GroupProgram
    profile: object                  # tune.DeviceProfile | None
    profile_hash: str | None
    profile_name: str | None
    key: str
    _cache: object = dataclasses.field(default=None, repr=False, compare=False)

    def plan(self, *, pin_input: bool = False,
             ddr_budget_bytes: int | None = None,
             cache=_INHERIT) -> "Planned":
        """Plan memory + emit the addressed instruction stream.  A different
        ``pin_input`` or DDR budget re-runs only this stage and later —
        the search and the lowering are reused as-is."""
        cache = _resolve_cache(cache, self._cache)
        budget = int(ddr_budget_bytes or 0)
        dev = self.wrapped.device
        if budget:
            dev = dev.replace(ddr_bytes=budget)
        ck = ("plan", self.key, bool(pin_input), budget)

        def build():
            planres = _art.plan_strategy(self.wrapped.graph, self.strategy,
                                         dev, pin_input=bool(pin_input))
            key = _art._sha([self.key, bool(pin_input), budget])
            return Planned(lowered=self, planres=planres,
                           ddr_budget_bytes=budget or None, key=key,
                           _cache=cache)

        obj, _ = _through(cache, "planned", ck, build)
        return obj

    def retune(self, *, profile=None, harness=None, cache=_INHERIT,
               **search_kw) -> "Lowered":
        """Re-run the measured tile-shape search over this lowering and
        return a new ``Lowered`` carrying the tuned shapes — pathsearch is
        NOT re-run (see ``tune.tiles.tune_lowered``)."""
        from repro_torch.tune.tiles import tune_lowered
        return tune_lowered(self, profile=profile, harness=harness,
                            cache=_resolve_cache(cache, self._cache),
                            **search_kw)


# ------------------------------------------------------------------- planned
@dataclasses.dataclass
class Planned:
    """Stage 3: memory plan + addressed instructions for one budget."""
    lowered: Lowered
    planres: _art.PlanResult
    ddr_budget_bytes: int | None
    key: str
    _cache: object = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def mem_summary(self) -> dict:
        return self.planres.mem_summary

    @property
    def peak_ddr_bytes(self) -> int:
        return self.planres.mem_summary["peak_bytes"]

    def compile(self, cache=_INHERIT) -> "Compiled":
        """Assemble the final ``CompiledArtifact`` object file."""
        cache = _resolve_cache(cache, self._cache)
        lo, w = self.lowered, self.lowered.wrapped
        key = _art._sha([self.key, _art.FORMAT_VERSION])
        ck = ("compile", self.key)

        def build():
            art = _art.assemble_artifact(
                w.graph, lo.strategy, w.device, w.qm, self.planres,
                lo.program, profile_hash=lo.profile_hash,
                profile_name=lo.profile_name)
            return Compiled(artifact=art, key=key,
                            stage_keys={"wrapped": w.key, "lowered": lo.key,
                                        "planned": self.key,
                                        "compiled": key},
                            planned=self, _cache=cache)

        obj, _ = _through(cache, "compiled", ck, build)
        return obj


# ------------------------------------------------------------------ compiled
@dataclasses.dataclass
class Compiled:
    """Stage 4: the DNNVM object file, ready to serve or to shelve."""
    artifact: _art.CompiledArtifact
    key: str                         # content address (the zoo's key)
    stage_keys: dict                 # stage name -> content hash
    planned: Planned | None = None   # None when reopened from an object file
    _cache: object = dataclasses.field(default=None, repr=False, compare=False)

    def session(self, backend: str = "fused", device=None, **kw):
        """Open a runtime ``Session`` on the artifact (plan cache seeded,
        no recompilation) on ``device`` (None: CUDA)."""
        return self.artifact.session(backend=backend, device=device, **kw)

    def save(self, path: str) -> None:
        _art.save_artifact(self.artifact, path)

    @classmethod
    def from_artifact(cls, art: _art.CompiledArtifact) -> "Compiled":
        """Re-open an object file as a ``Compiled`` stage.  The stage-key
        chain is reconstructed from the artifact's own content, so a
        reloaded artifact content-addresses identically to the compilation
        that produced it (the zoo backcompat pin)."""
        keys = artifact_stage_keys(art)
        return cls(artifact=art, key=keys["compiled"], stage_keys=keys)


def artifact_stage_keys(art: _art.CompiledArtifact) -> dict:
    """Reconstruct the wrapped/lowered/planned/compiled content hashes of an
    artifact from its serialized content alone (no recompilation).  Loaded
    artifacts carry no DDR-budget record, so the planned key assumes the
    unbudgeted (device-default) plan — exactly what ``compile_strategy``
    produces."""
    if art.f_a or art.f_w or art.weights:
        qsig = _art.quant_signature(QuantizedModel(
            dict(art.weights), dict(art.biases), dict(art.f_w),
            dict(art.f_a)))
    else:
        qsig = _art.quant_signature(None)
    wrapped = _art._sha([art.graph_sig, qsig, art.device])
    lowered = _art._sha([wrapped, _art.strategy_signature(art),
                         art.profile_hash or "analytic"])
    planned = _art._sha([lowered, bool(art.pin_input), 0])
    compiled = _art._sha([planned, _art.FORMAT_VERSION])
    return {"wrapped": wrapped, "lowered": lowered, "planned": planned,
            "compiled": compiled}
