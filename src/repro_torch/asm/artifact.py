"""The DNNVM object file: addressed instructions + plan + quantization.

Port of ``src/repro/asm/artifact.py``.  The object file's format is the
reference's (npz keys, JSON header, program JSON, signature
hashes), so an artifact saved by either package loads in the other; weights
stay numpy here, and the executor moves them to its ``torch.device`` once.

A :class:`CompiledArtifact` is the end product of the compiler: the ordered
execution groups, the lowered :class:`~repro_torch.core.lower.GroupProgram` (the
backend's executable: fused-launch descriptors + reasoned fallbacks), the
address-bearing instruction stream (DDR offsets, BRAM banks, dependency
bits), the memory-plan summary, and — when compiled from a quantized model —
the int8 weights/biases and radix positions.  It duck-types
``pathsearch.Strategy`` (``.groups`` / ``.horizontal`` / ``.meta``) so the
executor and validator consume it directly, and it serializes to a single
``.npz`` with :func:`save_artifact` / :func:`load_artifact` — the graph and
program ride along as JSON, so a loaded artifact is self-contained (no
recompilation, no re-quantization, no re-lowering).

``PlanCache`` keys compilations by (graph signature, device, strategy
signature, quantization fingerprint): the production-serving path compiles a
model once and every later request is a dictionary hit.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import zipfile

import numpy as np

from repro_torch.core import lower, simulator, tiling
from repro_torch.core.cost import AnalyticEvaluator
from repro_torch.core.isa import Instr, ENGINES, emit_strategy
from repro_torch.core.pathsearch import order_groups
from repro_torch.core.quantize import QuantizedModel
from repro_torch.core.xgraph import XGraph
from repro_torch.hw import DeviceModel, get_device
from repro_torch.memory import MemoryPlanError, plan_memory

# v2: adds the lowered GroupProgram section (launch descriptors + reasoned
# fallbacks) — v1 artifacts predate compile-time lowering and cannot be
# dispatched without re-pattern-matching, so loading them is refused.
# v3: "avgpool_ceil" left the fallback vocabulary (ceil-extended avgpool now
# lowers to a fused launch) — a v2 program may carry that reason, which
# RefFallback would reject on deserialization, so v2 loads are refused too.
# v4: launches carry the searched tile shape (``FusedLaunch.tile``) and the
# artifact meta records ``tile_shapes``.  v3 artifacts load fine — a missing
# tile record means the kernel-heuristic shapes, exactly what v3 ran.
# v5: the artifact embeds its compile-decision provenance — meta carries the
# bounded pathsearch ``search_trace``, the tile-search ``tile_provenance``
# leaderboard (top-K candidates per unit), and the assembled
# ``compile_report`` (see ``repro_torch.explain``).  v3/v4 artifacts load fine — a
# missing report just means ``explain`` degrades to what the plan alone says.
FORMAT_VERSION = 5
_LOADABLE_VERSIONS = (3, 4, FORMAT_VERSION)
_OPCODES = ("LOAD", "SAVE", "CONV", "POOL", "MISC", "END")
# attrs whose JSON lists must come back as tuples (XGraph convention)
_TUPLE_ATTRS = {"shape", "kernel", "stride", "dilation", "pad"}


# ------------------------------------------------------------------ signatures
def graph_signature(g: XGraph) -> str:
    """Stable content hash of the graph's structure, attrs and shapes."""
    payload = [(n.name, n.op, list(n.inputs), _safe_attrs(n.attrs),
                list(g.shape(n.name))) for n in g]
    return _sha(payload)


def strategy_signature(strategy) -> str:
    # tile_shapes are part of the identity: the same group partition with
    # different searched tile shapes compiles to a different program (and a
    # different bank plan), so it must not hit the same cache entry.
    tiles = strategy.meta.get("tile_shapes") or {}
    return _sha({"groups": list(strategy.groups),
                 "horizontal": list(strategy.horizontal),
                 "host": sorted(strategy.meta.get("host_nodes", [])),
                 "tiles": {k: list(v) for k, v in sorted(tiles.items())}})


def quant_signature(qm: QuantizedModel | None) -> str:
    if qm is None:
        return "noquant"
    # Radix positions plus a strided per-tensor digest: radix positions alone
    # are not injective over weights (a fine-tune can keep every f_w), and
    # hashing full hundred-MB weight sets on every cache lookup is too slow —
    # shape + int sum + ~1K sampled elements per tensor distinguishes any
    # realistic weight update at microsecond cost.
    digests = {}
    for name in sorted(qm.weights):
        w = np.asarray(qm.weights[name])
        flat = w.ravel()
        sample = flat[::max(1, flat.size // 1024)]
        digests[name] = [list(w.shape), str(w.dtype), int(flat.sum(dtype=np.int64)),
                         hashlib.sha256(sample.tobytes()).hexdigest()[:12]]
    return _sha({"f_a": dict(sorted(qm.f_a.items())),
                 "f_w": dict(sorted(qm.f_w.items())),
                 "w": digests})


def _sha(obj) -> str:
    return hashlib.sha256(
        json.dumps(obj, sort_keys=True, default=str).encode()).hexdigest()[:16]


def _profile_hash(profile) -> str | None:
    """DeviceProfile | raw hash string | None -> hash string | None (duck-
    typed so asm never imports tune)."""
    if profile is None or isinstance(profile, str):
        return profile
    return profile.hash()


def _resolve_provenance(strategy, profile_hash, pin_input) -> tuple:
    """Normalize (profile hash, pin_input) for cache keys and compilation.

    Explicit arguments win; otherwise they are inherited from the strategy
    itself — a searched ``Strategy`` carries ``meta['profile_hash']`` when a
    profile-guided evaluator picked it, and a ``CompiledArtifact`` (which
    duck-types Strategy) carries both from its own compilation — so loaded
    artifacts re-key identically to the compilations that produced them."""
    if profile_hash is None:
        meta = getattr(strategy, "meta", None)
        if isinstance(meta, dict):
            profile_hash = meta.get("profile_hash")
    if pin_input is None:
        ms = getattr(strategy, "mem_summary", None)
        pin_input = bool(ms.get("pin_input")) if isinstance(ms, dict) else False
    return profile_hash, bool(pin_input)


def _safe_attrs(attrs: dict) -> dict:
    """JSON-serializable attr subset; folded-intrinsic parameter blobs are
    dropped (their numeric effect already lives in the quantized weights)."""
    out = {}
    for k, v in attrs.items():
        if k == "folded_intrinsics":
            continue
        if isinstance(v, (list, tuple)):
            v = [int(x) if isinstance(x, (int, np.integer)) else x for x in v]
        elif isinstance(v, (np.integer,)):
            v = int(v)
        elif isinstance(v, (np.floating,)):
            v = float(v)
        elif not isinstance(v, (str, int, float, bool, type(None))):
            continue
        out[k] = v
    return out


def _untuple(k, v):
    if isinstance(v, list) and (k in _TUPLE_ATTRS or
                                all(isinstance(x, int) for x in v)):
        return tuple(v)
    return v


# --------------------------------------------------------------- provenance
# Bounds on the tile-search leaderboard persisted into the artifact: the full
# provenance can carry every enumerated candidate of every unit; the artifact
# keeps the default plus the best few per unit (enough to explain the choice)
# for a bounded number of units.
TILE_PROVENANCE_MAX_UNITS = 128
TILE_PROVENANCE_MAX_CANDIDATES = 8


def json_sanitize(v):
    """Recursive coercion to JSON-native types (numpy scalars to Python,
    tuples to lists, non-finite floats to None) so ``save_artifact``'s strict
    ``json.dumps`` round trip never chokes on provenance payloads."""
    import math

    if isinstance(v, dict):
        return {str(k): json_sanitize(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [json_sanitize(x) for x in v]
    if isinstance(v, (bool, str, type(None))):
        return v
    if isinstance(v, (int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        f = float(v)
        return f if math.isfinite(f) else None
    return str(v)


def bounded_tile_provenance(prov, *,
                            max_units: int = TILE_PROVENANCE_MAX_UNITS,
                            max_candidates: int = TILE_PROVENANCE_MAX_CANDIDATES
                            ) -> list | None:
    """Bound the tune.tiles leaderboard for artifact embedding: per unit keep
    the kernel default plus the best ``max_candidates - 1`` others (measured
    seconds when available, else predicted), recording how many candidates
    the search actually scored."""
    if not prov:
        return None

    def rank(c):
        for k in ("measured", "predicted"):
            if c.get(k) is not None:
                return float(c[k])
        return float("inf")

    out = []
    for entry in prov[:max_units]:
        e = dict(entry)
        cands = list(e.get("candidates") or [])
        defaults = [c for c in cands if c.get("default")]
        rest = sorted((c for c in cands if not c.get("default")), key=rank)
        e["candidates"] = defaults + rest[:max(0, max_candidates - len(defaults))]
        e["n_candidates"] = len(cands)
        out.append(e)
    return json_sanitize(out)


# -------------------------------------------------------------------- artifact
class ArtifactError(ValueError):
    """A persisted artifact could not be loaded: missing or truncated npz,
    garbage bytes, tampered/incomplete metadata, or an unloadable format
    version.  Subclasses :class:`ValueError` so pre-existing callers that
    guarded version mismatches with ``except ValueError`` keep working;
    new callers (the zoo, the fleet) catch this to distinguish a corrupt
    store entry from a programming error."""


@dataclasses.dataclass
class CompiledArtifact:
    graph_sig: str
    device: str
    groups: list                    # chain groups (Strategy duck-typing)
    horizontal: list
    meta: dict                      # incl. host_nodes
    exec_items: list                # ordered groups the instrs were emitted for
    instrs: list                    # list[Instr], addressed
    mem_summary: dict               # peak/no-reuse/reuse-factor/banks
    graph_nodes: list               # JSON-safe node records for rebuild
    f_a: dict
    f_w: dict
    weights: dict                   # node -> int8 ndarray ({} if planned w/o qm)
    biases: dict                    # node -> int32 ndarray
    sim_total_cycles: int = 0
    program: lower.GroupProgram | None = None   # lowered backend program

    @property
    def fused_coverage(self) -> float:
        return self.program.meta["coverage"] if self.program else 0.0

    @property
    def profile_hash(self) -> str | None:
        """Hash of the device profile this plan was searched/compiled under
        (None: the hand-written analytic model)."""
        return self.meta.get("profile_hash")

    @property
    def pin_input(self) -> bool:
        return bool(self.mem_summary.get("pin_input"))

    @property
    def tile_shapes(self) -> dict:
        """Searched per-launch tile shapes this plan was compiled with
        (tile_key -> (t_h, t_w, t_oc); {} = kernel-heuristic shapes)."""
        return dict(self.meta.get("tile_shapes") or {})

    @property
    def tile_provenance(self) -> list:
        """Bounded tile-search leaderboard (per-unit candidates with predicted
        / measured seconds); [] for pre-v5 artifacts or untuned plans."""
        return list(self.meta.get("tile_provenance") or [])

    @property
    def search_trace(self) -> dict | None:
        """Bounded pathsearch decision trace; None for pre-v5 artifacts."""
        return self.meta.get("search_trace")

    @property
    def report(self) -> dict | None:
        """The embedded CompileReport (see ``repro_torch.explain``); None for
        pre-v5 artifacts — use ``repro_torch.explain.report_of`` to get a degraded
        reconstruction instead of None."""
        return self.meta.get("compile_report")

    @property
    def peak_ddr_bytes(self) -> int:
        return self.mem_summary["peak_bytes"]

    @property
    def reuse_factor(self) -> float:
        return self.mem_summary["reuse_factor"]

    def quantized_model(self) -> QuantizedModel:
        needs_weights = any(nd["op"] in ("conv", "dilated_conv", "deconv",
                                         "depthwise_conv", "fc")
                            for nd in self.graph_nodes)
        if not self.weights and needs_weights:
            raise ValueError(
                "artifact was compiled without a QuantizedModel (plan-only); "
                "recompile with qm= to execute it")
        return QuantizedModel(dict(self.weights), dict(self.biases),
                              dict(self.f_w), dict(self.f_a))

    def rebuild_graph(self) -> XGraph:
        g = XGraph(self.meta.get("graph_name", "artifact"))
        for nd in self.graph_nodes:
            attrs = {k: _untuple(k, v) for k, v in nd["attrs"].items()}
            g.add(nd["op"], nd["name"], tuple(nd["inputs"]), **attrs)
        return g

    def executor(self, g: XGraph | None = None, backend: str = "fused",
                 device=None):
        """An ``Int8Executor`` on ``device`` (None: CUDA, which raises where
        CUDA is absent); ``"fused"`` dispatches the stored program."""
        from repro_torch.core.executor import Int8Executor
        return Int8Executor(g if g is not None else self.rebuild_graph(),
                            self.quantized_model(), strategy=self,
                            backend=backend, device=device)

    def session(self, backend: str = "fused", device=None, **kw):
        """Open a runtime-supporter :class:`~repro_torch.runtime.session.Session`
        on this artifact (seeds the plan cache; no recompilation)."""
        from repro_torch.runtime import Session
        return Session.from_artifact(self, backend=backend, device=device,
                                     **kw)

    # ------------------------------------------------------------ round trip
    def save(self, path: str) -> None:
        """Persist as one DNNVM object file (see :func:`save_artifact`)."""
        save_artifact(self, path)

    @classmethod
    def load(cls, path: str) -> "CompiledArtifact":
        """Load a DNNVM object file; raises :class:`ArtifactError` on any
        corrupt/truncated/tampered input (see :func:`load_artifact`)."""
        return load_artifact(path)


# ----------------------------------------------------------------- compilation
@dataclasses.dataclass
class PlanResult:
    """Payload of the ``Planned`` compile stage (see ``repro_torch.stages``): the
    ordered execution items, their solved tilings, the memory plan, the
    addressed instruction stream, and the simulator's hazard audit."""
    items: list                     # ordered groups the instrs were emitted for
    tilings: list                   # one GroupTiling per item
    plan: object                    # memory.MemoryPlan
    instrs: list                    # list[Instr], addressed
    mem_summary: dict               # peak/no-reuse/reuse-factor/banks
    sim_total_cycles: int
    pin_input: bool


def plan_strategy(g: XGraph, strategy, dev: DeviceModel, *,
                  pin_input: bool = False) -> PlanResult:
    """The memory-planning half of compilation: solve every group's tiling
    (searched shapes win over the analytic Eq. 5/6 defaults), plan DDR +
    bank layout, emit the addressed instruction stream, and hard-error on
    any memory hazard the simulator finds."""
    from repro_torch.obs.trace import TRACER

    items = order_groups(g, [list(grp) for grp in strategy.groups] +
                         [list(h) for h in strategy.horizontal])
    hset = {tuple(h) for h in strategy.horizontal}
    ana = AnalyticEvaluator(g, dev)
    tile_shapes = dict(strategy.meta.get("tile_shapes") or {})
    tilings = []
    with TRACER.span("tiling", cat="compile", track="compile",
                     n_groups=len(items)):
        for grp in items:
            # A searched tile shape replaces the analytic Eq. 5/6 default, so
            # the bank planner charges the TRUE per-tile footprints of what
            # the kernel will actually execute (and the instruction stream
            # carries the true tile count).  A shape that does not fit the
            # device's buffers is a compile error, not a silent fallback.  A
            # horizontal unit's shapes are recorded per lowered LAUNCH; when
            # the unit's members split across several launches (mixed kernel
            # classes) the unit-level plan takes the stacked launch's shape
            # if there is exactly one — otherwise it keeps the analytic
            # default (one unit, one bank plan: there is no single true shape
            # to charge).
            shape = tile_shapes.get(lower.tile_key(grp))
            subset_shape = None
            if shape is None and tuple(grp) in hset:
                stacked = [it for it in
                           lower.lower_horizontal(g, None, list(grp))
                           if isinstance(it, lower.FusedLaunch)
                           and it.kind == "horizontal"]
                if len(stacked) == 1:
                    subset_shape = tile_shapes.get(
                        lower.tile_key(stacked[0].nodes))
            th, tw, toc = ((int(s) for s in (shape or subset_shape))
                           if (shape or subset_shape) else (None,) * 3)
            if tuple(grp) in hset:
                t = tiling.solve_horizontal(g, grp, dev, t_w=tw, t_h=th,
                                            t_oc=toc)
                if not t.feasible and subset_shape is not None:
                    # the subset shape was only proven feasible for the
                    # stacked launch's members — over the full unit it is
                    # best-effort, not a contract; fall back to the analytic
                    # unit plan
                    t = tiling.solve_horizontal(g, grp, dev)
            elif shape:
                t = tiling.solve_shape(g, grp, dev, t_w=tw, t_h=th, t_oc=toc)
            else:
                t = ana.cost(grp).tiling
            if not t.feasible:
                raise MemoryPlanError(f"group {grp} infeasible: {t.reason}")
            tilings.append(t)

    with TRACER.span("memory_plan", cat="compile", track="compile"):
        plan = plan_memory(g, items, tilings, dev, pin_input=pin_input)
    with TRACER.span("assemble", cat="compile", track="compile") as sp:
        instrs = emit_strategy(g, items, tilings, dev, plan=plan)
        sp.set(n_instrs=len(instrs))
    rep = simulator.check(instrs)   # hard-errors on any memory hazard
    mem_summary = plan.summary()
    mem_summary["banks"] = [
        {"n_in": b.n_banks_in, "n_out": b.n_banks_out} for b in plan.banks]
    return PlanResult(items=items, tilings=tilings, plan=plan, instrs=instrs,
                      mem_summary=mem_summary,
                      sim_total_cycles=rep.total_cycles,
                      pin_input=bool(pin_input))


def assemble_artifact(g: XGraph, strategy, dev: DeviceModel,
                      qm: QuantizedModel | None, planres: PlanResult,
                      program: lower.GroupProgram | None, *,
                      profile_hash: str | None = None,
                      profile_name: str | None = None) -> CompiledArtifact:
    """Package a planned + lowered compilation into the DNNVM object file."""
    tile_shapes = dict(strategy.meta.get("tile_shapes") or {})
    art = CompiledArtifact(
        graph_sig=graph_signature(g),
        device=dev.name,
        groups=[list(grp) for grp in strategy.groups],
        horizontal=[list(h) for h in strategy.horizontal],
        meta={"host_nodes": list(strategy.meta.get("host_nodes", [])),
              "graph_name": g.name,
              "profile_hash": profile_hash,
              "profile_name": (profile_name
                               or strategy.meta.get("profile_name")),
              # tile provenance: the artifact re-keys identically to the
              # strategy that produced it (strategy_signature hashes these)
              "tile_shapes": {k: list(v) for k, v in tile_shapes.items()},
              "tile_source": strategy.meta.get("tile_source"),
              # decision provenance (v5): the search's audit trace and the
              # tile-search leaderboard survive the npz round trip, so a
              # reopened artifact can still explain its own choices
              "search_trace": json_sanitize(
                  strategy.meta.get("search_trace")),
              "tile_provenance": bounded_tile_provenance(
                  strategy.meta.get("tile_provenance"))},
        exec_items=[list(grp) for grp in planres.items],
        instrs=planres.instrs,
        mem_summary=planres.mem_summary,
        graph_nodes=[{"name": n.name, "op": n.op, "inputs": list(n.inputs),
                      "attrs": _safe_attrs(n.attrs)} for n in g],
        f_a=dict(qm.f_a) if qm else {},
        f_w=dict(qm.f_w) if qm else {},
        weights={k: np.asarray(v) for k, v in qm.weights.items()} if qm else {},
        biases={k: np.asarray(v) for k, v in qm.biases.items()} if qm else {},
        sim_total_cycles=planres.sim_total_cycles,
        program=program)
    # The CompileReport (repro_torch.explain) is assembled here — the one point
    # where graph, strategy, plan, and lowered program are all in hand — and
    # embedded so every artifact ships its own explanation.  Lazy import:
    # explain consumes asm types, not the other way around.
    from repro_torch.explain.report import build_report

    art.meta["compile_report"] = json_sanitize(build_report(
        g, strategy, dev, planres, program,
        profile_hash=profile_hash,
        profile_name=profile_name or strategy.meta.get("profile_name")))
    return art


def compile_strategy(g: XGraph, strategy, dev: DeviceModel,
                     qm: QuantizedModel | None = None, *,
                     profile=None, pin_input: bool | None = None
                     ) -> CompiledArtifact:
    """Lower ``strategy`` to an addressed, hazard-checked artifact.

    Thin wrapper over the staged compile pipeline (``repro_torch.stages``): the
    strategy is wrapped, lowered, planned, and compiled in explicit stages —
    callers that want partial recompiles or stage-level caching should use
    ``repro_torch.stages`` directly; this entry point preserves the original
    one-call contract (no stage cache, identical output).

    ``profile`` (a ``tune.DeviceProfile``, its hash string, or None) is
    provenance: the artifact records which calibrated cost model planned it.
    ``pin_input`` keeps the network input's DDR region out of the planner's
    reuse pool (see ``memory.plan_memory``)."""
    from repro_torch.stages import wrap

    profile_hash, pin_input = _resolve_provenance(strategy, _profile_hash(
        profile), pin_input)
    wrapped = wrap(g, qm, dev, cache=None)
    lowered = wrapped.lower(
        strategy=strategy,
        profile=profile if not isinstance(profile, str) else None,
        profile_hash=profile_hash, cache=None)
    return lowered.plan(pin_input=pin_input, cache=None) \
                  .compile(cache=None).artifact


# -------------------------------------------------------------- serialization
def save_artifact(art: CompiledArtifact, path: str) -> None:
    """One npz: instruction arrays + weight tensors + a JSON metadata block."""
    n = len(art.instrs)
    fields = np.zeros((n, 9), dtype=np.int64)
    deps_flat, deps_off = [], [0]
    tags = []
    for i, ins in enumerate(art.instrs):
        fields[i] = (ins.iid, ENGINES.index(ins.engine),
                     _OPCODES.index(ins.opcode), ins.cycles, ins.ddr_addr,
                     ins.ddr_len, ins.bank, ins.group_id, ins.tile)
        deps_flat.extend(ins.deps)
        deps_off.append(len(deps_flat))
        tags.append(ins.tag)
    meta = {
        "format_version": FORMAT_VERSION,
        "graph_sig": art.graph_sig,
        "device": art.device,
        "groups": art.groups,
        "horizontal": art.horizontal,
        "meta": art.meta,
        "exec_items": art.exec_items,
        "mem_summary": art.mem_summary,
        "graph_nodes": art.graph_nodes,
        "f_a": art.f_a,
        "f_w": art.f_w,
        "tags": tags,
        "sim_total_cycles": art.sim_total_cycles,
        "weight_nodes": sorted(art.weights),
        "bias_nodes": sorted(art.biases),
        "program": (lower.program_to_json(art.program)
                    if art.program is not None else None),
    }
    arrays = {
        "instr_fields": fields,
        "deps_flat": np.asarray(deps_flat, dtype=np.int64),
        "deps_off": np.asarray(deps_off, dtype=np.int64),
        "meta_json": np.asarray(json.dumps(meta)),
    }
    for k, w in art.weights.items():
        arrays[f"w::{k}"] = w
    for k, b in art.biases.items():
        arrays[f"b::{k}"] = b
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_artifact(path: str) -> CompiledArtifact:
    """Load one DNNVM object file.

    Any way the file can be bad — not an npz at all, truncated mid-archive,
    a missing/garbled ``meta_json`` block, metadata referencing arrays that
    are not in the archive, or an unloadable format version — raises
    :class:`ArtifactError` naming the path and the cause, never a raw
    ``zipfile``/``KeyError``/decoder exception from the guts of the reader.
    ``FileNotFoundError`` stays ``FileNotFoundError`` (a missing file is an
    addressing mistake, not corruption)."""
    try:
        return _load_artifact(path)
    except (ArtifactError, FileNotFoundError, IsADirectoryError):
        raise
    except (zipfile.BadZipFile, KeyError, IndexError, TypeError, ValueError,
            EOFError, OSError, json.JSONDecodeError) as e:
        raise ArtifactError(
            f"corrupt artifact {path!r}: {type(e).__name__}: {e}") from e


def _load_artifact(path: str) -> CompiledArtifact:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta_json"]))
        if not isinstance(meta, dict) or "format_version" not in meta:
            raise ArtifactError(
                f"corrupt artifact {path!r}: metadata block is not an "
                f"artifact header")
        if meta["format_version"] not in _LOADABLE_VERSIONS:
            raise ArtifactError(
                f"artifact {path!r}: format {meta['format_version']} not "
                f"in {_LOADABLE_VERSIONS}")
        fields = z["instr_fields"]
        deps_flat = z["deps_flat"]
        deps_off = z["deps_off"]
        instrs = []
        for i in range(fields.shape[0]):
            iid, eng, opc, cyc, addr, ln, bank, gid, tile = (
                int(x) for x in fields[i])
            deps = tuple(int(d) for d in
                         deps_flat[deps_off[i]:deps_off[i + 1]])
            instrs.append(Instr(iid, ENGINES[eng], _OPCODES[opc], cyc,
                                deps, tag=meta["tags"][i], ddr_addr=addr,
                                ddr_len=ln, bank=bank, group_id=gid,
                                tile=tile))
        weights = {k: z[f"w::{k}"] for k in meta["weight_nodes"]}
        # biases keyed independently: a weight node without a bias (or a
        # bias-only correction) must survive the round trip
        biases = {k: z[f"b::{k}"] for k in meta.get("bias_nodes",
                                                    meta["weight_nodes"])}
    program = (lower.program_from_json(meta["program"])
               if meta.get("program") is not None else None)
    return CompiledArtifact(
        graph_sig=meta["graph_sig"], device=meta["device"],
        groups=meta["groups"], horizontal=meta["horizontal"],
        meta=meta["meta"], exec_items=meta["exec_items"], instrs=instrs,
        mem_summary=meta["mem_summary"], graph_nodes=meta["graph_nodes"],
        f_a=meta["f_a"], f_w=meta["f_w"], weights=weights, biases=biases,
        sim_total_cycles=meta["sim_total_cycles"], program=program)


# ---------------------------------------------------------------- plan cache
class PlanCache:
    """In-process memoization of compiled artifacts.

    Keyed by (graph signature, device, strategy signature, quantization
    fingerprint) — the serving path's "have we compiled this before?".
    LRU-bounded: cached artifacts can pin large weight tensors, so a
    long-running server evicts the least-recently-used plan past
    ``maxsize`` instead of growing without bound."""

    def __init__(self, maxsize: int = 64, *, max_entries: int | None = None):
        self._store: dict[tuple, CompiledArtifact] = {}
        self.maxsize = max_entries if max_entries is not None else maxsize
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def max_entries(self) -> int:
        """Bound on resident plans (alias of ``maxsize``; a many-model server
        sets this through ``Session``/``MultiServer``)."""
        return self.maxsize

    @max_entries.setter
    def max_entries(self, n: int) -> None:
        if n < 1:
            raise ValueError("max_entries must be >= 1")
        self.maxsize = n
        self._shrink()

    def key(self, g: XGraph, strategy, dev: DeviceModel,
            qm: QuantizedModel | None = None, *, profile=None,
            pin_input: bool | None = None) -> tuple:
        ph, pi = _resolve_provenance(strategy, _profile_hash(profile),
                                     pin_input)
        return (graph_signature(g), dev.name, strategy_signature(strategy),
                quant_signature(qm), ph or "analytic", pi)

    def get_or_compile(self, g: XGraph, strategy, dev: DeviceModel,
                       qm: QuantizedModel | None = None, *, profile=None,
                       pin_input: bool | None = None
                       ) -> tuple[CompiledArtifact, bool]:
        ph, pi = _resolve_provenance(strategy, _profile_hash(profile),
                                     pin_input)
        k = self.key(g, strategy, dev, qm, profile=ph, pin_input=pi)
        from repro_torch.obs.metrics import REGISTRY

        art = self._store.get(k)
        if art is not None:
            self._store[k] = self._store.pop(k)   # refresh LRU position
            self.hits += 1
            REGISTRY.counter("plan_cache.hits").inc()
            return art, True
        art = compile_strategy(g, strategy, dev, qm=qm,
                               profile=profile if profile is not None else ph,
                               pin_input=pi)
        self.misses += 1
        REGISTRY.counter("plan_cache.misses").inc()
        self._put(k, art)
        return art, False

    def put(self, g: XGraph, strategy, dev: DeviceModel, art: CompiledArtifact,
            qm: QuantizedModel | None = None, *, profile=None,
            pin_input: bool | None = None) -> None:
        """Seed a precompiled artifact (e.g. loaded from an object file) so
        later ``get_or_compile`` calls hit instead of recompiling."""
        self._put(self.key(g, strategy, dev, qm, profile=profile,
                           pin_input=pin_input), art)

    def _put(self, k: tuple, art: CompiledArtifact) -> None:
        self._store.pop(k, None)
        self._store[k] = art
        self._shrink()

    def _shrink(self) -> None:
        from repro_torch.obs.events import EVENTS
        from repro_torch.obs.metrics import REGISTRY

        dropped = 0
        while len(self._store) > self.maxsize:
            self._store.pop(next(iter(self._store)))
            self.evictions += 1
            dropped += 1
            REGISTRY.counter("plan_cache.evictions").inc()
        if dropped:
            EVENTS.emit("cache.evict", cache="plan_cache", n=dropped,
                        resident=len(self._store), bound=self.maxsize,
                        message=f"plan cache evicted {dropped} artifact"
                                f"{'' if dropped == 1 else 's'} "
                                f"(bound {self.maxsize})")

    def clear(self) -> None:
        self._store.clear()
        self.hits = self.misses = 0

    def __len__(self) -> int:
        return len(self._store)


PLAN_CACHE = PlanCache()


def device_of_artifact(art: CompiledArtifact) -> DeviceModel:
    return get_device(art.device)
