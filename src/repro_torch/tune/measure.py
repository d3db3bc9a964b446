"""On-device measurement harness (paper Table 2, method 1: "<1 s, 0%").

Port of ``src/repro/tune/measure.py``.  Runs individual ``GroupProgram``
entries — ``FusedLaunch`` chains, horizontal stacks and ``RefFallback``
groups — through the executor's own per-item path in isolation and times
them with warm-up, repeated samples and MAD-based outlier rejection.
Because measurement reuses the ``core.lower`` descriptors, every candidate
group the path search can enumerate is also a measurable unit.

On a CUDA device a sample is device time: a sleep kernel holds the stream
while the host enqueues ``calls`` back-to-back calls between two CUDA
events, so the host's Python and launch overhead between calls (tens of
microseconds, against 4-23 us chain launches on an H100) is not counted.
On the CPU a sample is host wall-clock, as in the reference.  The
robust-centre and round-robin logic is the reference's.

The harness is the ground-truth source for :mod:`repro_torch.tune.calibrate`;
``measure_strategy`` times a whole strategy end to end (host clock with a
synchronize: the request latency a user sees).
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.core import executor as core_executor
from repro_torch.core import lower
from repro_torch.core.xgraph import XGraph
from repro_torch.hw import DeviceModel

# Smallest unit time a harness resolves (``calibrate`` and the tile search
# drop units below it).  On the CPU samples are host wall-clock, where short
# units drown in dispatch jitter on a shared host (the reference's 0.5 ms).
# On CUDA a sample is CUDA-event device time over at least CUDA_MIN_CALLS
# queued launches: the events' resolution (about 0.5 us) is spread over the
# calls, so 1 us — under every chain launch of GoogLeNet-224 on an H100
# (4-23 us) — keeps every card launch while still dropping empty ones.
MIN_MEASURABLE_S = {"cpu": 5e-4, "cuda": 1e-6}
CUDA_MIN_CALLS = 16


@dataclasses.dataclass(frozen=True)
class Measurement:
    """Robust time of one measurable unit."""
    nodes: tuple
    kind: str                  # "chain" | "horizontal" | "fallback" | "e2e"
    seconds: float             # robust centre of accepted samples
    spread: float              # MAD / median of accepted samples (rel. jitter)
    n_samples: int             # accepted sample count
    n_rejected: int            # outliers dropped by the MAD filter
    samples: tuple = ()        # raw samples (accepted + rejected), seconds

    def to_json(self) -> dict:
        return {"nodes": list(self.nodes), "kind": self.kind,
                "seconds": self.seconds, "spread": self.spread,
                "n_samples": self.n_samples, "n_rejected": self.n_rejected}


def _robust_center(samples: list, reject_nmad: float,
                   center: str = "median") -> tuple:
    """(center, relative spread, n_accepted, n_rejected) with MAD rejection.

    ``center="median"`` is the classic median-of-k after rejecting samples
    more than ``reject_nmad`` MADs out.  ``center="min"`` takes the fastest
    sample: interference is additive, so the minimum over many short
    samples converges to the uncontended time — the quantity cross-group
    ratios must be built on.
    """
    s = np.asarray(samples, dtype=float)
    med = float(np.median(s))
    mad = float(np.median(np.abs(s - med)))
    tol = reject_nmad * max(mad, 1e-12)
    keep = s[np.abs(s - med) <= tol]
    if keep.size == 0:                     # pathological: keep everything
        keep = s
    med = float(np.median(keep))
    spread = float(np.median(np.abs(keep - med)) / max(med, 1e-12))
    loc = float(s.min()) if center == "min" else med
    return loc, spread, int(keep.size), int(s.size - keep.size)


def _on_cuda(ins) -> bool:
    return any(torch.is_tensor(t) and t.is_cuda for t in ins)


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def _probe(fn, ins, warmup: int, cuda: bool) -> float:
    """Warm ``fn(*ins)`` up, then the host seconds of one call, which size
    the sample loop and, on CUDA, the sleep ahead of it: there the call is
    only enqueued, so this is the host's enqueue time.  The least of three
    calls: a garbage-collector pause in the probe would otherwise stretch
    every later sleep of the unit by 32 times the pause."""
    for _ in range(max(1, warmup)):
        fn(*ins)
    _sync(cuda)
    probe = math.inf
    for _ in range(3):
        t0 = time.perf_counter()
        fn(*ins)
        probe = min(probe, time.perf_counter() - t0)
        _sync(cuda)
    return max(probe, 1e-9)


def _calls(probe: float, min_sample_s: float, max_calls: int,
           cuda: bool) -> int:
    calls = max(1, math.ceil(min_sample_s / probe))
    if cuda:
        calls = max(calls, CUDA_MIN_CALLS)
    return int(min(max_calls, calls))


def _sample(fn, ins, calls: int, probe: float, cuda: bool) -> float:
    """Seconds per call over ``calls`` back-to-back calls: CUDA-event
    device time behind a sleep kernel that outlasts the host's enqueueing
    (1 ms plus twice the probed enqueue time per call, at about 2 GHz), or
    host wall-clock on the CPU."""
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*ins)
        return (time.perf_counter() - t0) / calls
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((calls * probe * 2 + 1e-3) * 2e9))
    start.record()
    for _ in range(calls):
        fn(*ins)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / calls


def time_callable(fn, ins, *, warmup: int = 1, repeats: int = 5,
                  reject_nmad: float = 3.5, min_sample_s: float = 0.0,
                  max_calls: int = 512, center: str = "median") -> tuple:
    """Time ``fn(*ins)`` after warm-up and a synchronize.

    Inputs on a CUDA device are timed on the device (see :func:`_sample`,
    at least ``CUDA_MIN_CALLS`` calls a sample); on the CPU, with
    ``min_sample_s > 0`` each sample loops the callable until it spans that
    much wall clock, and with the default 0 a sample is one call, which
    suits the ``center="min"`` estimator (see :func:`_robust_center`).

    Returns (seconds, spread, n_accepted, n_rejected, samples)."""
    cuda = _on_cuda(ins)
    probe = _probe(fn, ins, warmup, cuda)
    calls = _calls(probe, min_sample_s, max_calls, cuda)
    samples = [_sample(fn, ins, calls, probe, cuda)
               for _ in range(max(1, repeats))]
    loc, spread, n_ok, n_rej = _robust_center(samples, reject_nmad, center)
    return loc, spread, n_ok, n_rej, tuple(samples)


# ------------------------------------------------------------- unit builders
def _rand_int8(gen, shape, dev):
    # full-range int8 activations (see executor.build_group_callable:
    # near-zero data leaves saturation work unexercised and skews timings)
    return torch.randint(-128, 128, tuple(shape), generator=gen,
                         dtype=torch.int8, device=dev)


def build_item_callable(g: XGraph, qm, item, device=None,
                        prepared: dict | None = None):
    """One ``GroupProgram`` item as a standalone callable + inputs on
    ``device`` (None: CUDA).

    ``FusedLaunch`` entries run the conv kernel through ``run_launch``
    (its tile record applied), with the launch's device weights built once
    here (``prepare_launch``, or ``prepared`` when the caller has them), not
    inside the timed call; ``RefFallback`` entries run their nodes through
    the int8 ref ops — the per-item path of ``Int8Executor(backend="fused")``.
    """
    from repro_torch.kernels.conv_fused import ops as fused_ops

    dev = core_executor.resolve_device(device)
    if isinstance(item, lower.RefFallback):
        return core_executor.build_group_callable(g, list(item.nodes), qm,
                                                  device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    in_names = list(dict.fromkeys((item.in_name,) + tuple(item.sides)))
    ins = [_rand_int8(gen, g.shape(nm), dev) for nm in in_names]
    prep = prepared or fused_ops.prepare_launch(item, qm, dev)

    def fn(*xs):
        env = dict(zip(in_names, xs))
        with torch.no_grad():
            out = fused_ops.run_launch(item, env, prepared=prep)
        return tuple(out[k] for k in sorted(out))

    return fn, ins


# ---------------------------------------------------------------- the harness
class MeasurementHarness:
    """Measure groups / program items / whole strategies on one device.

    ``backend="fused"`` lowers each group through ``core.lower`` and times
    the fused kernel launch (ref ops only where lowering decides to fall
    back); ``backend="ref"`` times the per-node int8 reference path.
    ``device`` is where the units run (None: CUDA).  Results are memoized
    per group — the path search revisits segments freely.
    """

    def __init__(self, g: XGraph, qm, dev: DeviceModel | None = None, *,
                 backend: str = "fused", device=None,
                 warmup: int = 1, repeats: int = 12,
                 reject_nmad: float = 3.5, min_sample_s: float = 0.0,
                 center: str = "min"):
        if backend not in ("fused", "ref"):
            raise ValueError(f"unknown backend {backend!r}")
        if center not in ("median", "min"):
            raise ValueError(f"unknown center {center!r}")
        self.g, self.qm, self.dev = g, qm, dev
        self.backend = backend
        self.device = core_executor.resolve_device(device)
        self.warmup, self.repeats = warmup, repeats
        self.reject_nmad = reject_nmad
        self.min_sample_s = min_sample_s
        self.center = center
        self.min_measurable_s = MIN_MEASURABLE_S[self.device.type]
        self._cache: dict[tuple, Measurement] = {}
        self._prepared: dict[str, dict] = {}

    # ------------------------------------------------------------ internals
    def _time(self, fn, ins, nodes, kind) -> Measurement:
        med, spread, n_ok, n_rej, samples = time_callable(
            fn, ins, warmup=self.warmup, repeats=self.repeats,
            reject_nmad=self.reject_nmad, min_sample_s=self.min_sample_s,
            center=self.center)
        return Measurement(nodes=tuple(nodes), kind=kind, seconds=med,
                           spread=spread, n_samples=n_ok, n_rejected=n_rej,
                           samples=samples)

    def _item_callable(self, item):
        """``build_item_callable`` with one weight upload per node cover:
        the tile variants of a launch share their device weights."""
        prep = None
        if isinstance(item, lower.FusedLaunch):
            from repro_torch.kernels.conv_fused import ops as fused_ops
            key = lower.tile_key(item.nodes)
            if key not in self._prepared:
                self._prepared[key] = fused_ops.prepare_launch(
                    item, self.qm, self.device)
            prep = self._prepared[key]
        return build_item_callable(self.g, self.qm, item, self.device,
                                   prepared=prep)

    def _group_callable(self, group: list) -> tuple:
        if self.backend == "fused":
            item = lower.lower_group(self.g, self.qm, list(group))
            kind = (item.kind if isinstance(item, lower.FusedLaunch)
                    else "fallback")
            fn, ins = self._item_callable(item)
        else:
            kind = "fallback"
            fn, ins = core_executor.build_group_callable(
                self.g, list(group), self.qm, device=self.device)
        return fn, ins, kind

    # -------------------------------------------------------------- units
    def measure_item(self, item) -> Measurement:
        kind = (item.kind if isinstance(item, lower.FusedLaunch)
                else "fallback")
        fn, ins = self._item_callable(item)
        return self._time(fn, ins, item.nodes, kind)

    def measure_group(self, group: list) -> Measurement:
        """Measure one chain group through this harness's backend."""
        key = ("chain", tuple(group))
        if key in self._cache:
            return self._cache[key]
        fn, ins, kind = self._group_callable(group)
        m = self._time(fn, ins, group, kind)
        self._cache[key] = m
        return m

    def _round_robin(self, units: list, passes: int | None) -> list:
        """The shared epoch-robust timing core: warm + probe every callable
        first, then each pass times every unit once — an interference epoch
        inflates whole passes (which MAD rejection discards), never one
        unit's samples relative to another's.

        ``units``: (nodes, kind, fn, ins) per measurable; returns one
        :class:`Measurement` per unit, in order."""
        passes = passes if passes is not None else self.repeats
        prepped = []
        for nodes, kind, fn, ins in units:
            cuda = _on_cuda(ins)
            probe = _probe(fn, ins, self.warmup, cuda)
            calls = _calls(probe, self.min_sample_s, 512, cuda)
            prepped.append((nodes, kind, fn, ins, calls, probe, cuda, []))
        for _ in range(max(1, passes)):
            for nodes, kind, fn, ins, calls, probe, cuda, samples in prepped:
                samples.append(_sample(fn, ins, calls, probe, cuda))
        out_ms = []
        for nodes, kind, fn, ins, calls, probe, cuda, samples in prepped:
            loc, spread, n_ok, n_rej = _robust_center(
                samples, self.reject_nmad, self.center)
            out_ms.append(Measurement(
                nodes=tuple(nodes), kind=kind, seconds=loc, spread=spread,
                n_samples=n_ok, n_rejected=n_rej, samples=tuple(samples)))
        return out_ms

    def measure_set(self, groups: list, passes: int | None = None) -> list:
        """Measure many groups in round-robin passes (see
        :meth:`_round_robin` for why cross-group ratios need this)."""
        todo = []
        for grp in groups:
            key = ("chain", tuple(grp))
            if key in self._cache:
                continue
            fn, ins, kind = self._group_callable(grp)
            todo.append((key, (grp, kind, fn, ins)))
        for (key, _), m in zip(todo,
                               self._round_robin([u for _, u in todo],
                                                 passes)):
            self._cache[key] = m
        return [self._cache[("chain", tuple(grp))] for grp in groups]

    def measure_item_set(self, items: list, passes: int | None = None
                         ) -> list[Measurement]:
        """Measure arbitrary program items in round-robin passes — the same
        epoch-robust machinery as :meth:`measure_set`, over prebuilt
        ``FusedLaunch`` / ``RefFallback`` descriptors.  This is how the
        tile-shape search times the candidate tiles of every lowered unit:
        a tile variant is just another measurable item.

        Results are NOT memoized: tile variants of one launch share the same
        node cover, so the per-group cache key would collide."""
        units = []
        for item in items:
            kind = (item.kind if isinstance(item, lower.FusedLaunch)
                    else "fallback")
            fn, ins = self._item_callable(item)
            units.append((item.nodes, kind, fn, ins))
        return self._round_robin(units, passes)

    def measure_horizontal(self, heads: list) -> Measurement:
        """Measure a horizontal (shared-input) group: the sum of its lowered
        items (one stacked launch + any individually-lowered leftovers)."""
        key = ("horizontal", tuple(heads))
        if key in self._cache:
            return self._cache[key]
        if self.backend == "fused":
            items = lower.lower_horizontal(self.g, self.qm, list(heads))
            parts = [self.measure_item(it) for it in items]
        else:
            parts = [self.measure_group([h]) for h in heads]
        m = Measurement(
            nodes=tuple(heads), kind="horizontal",
            seconds=sum(p.seconds for p in parts),
            spread=max((p.spread for p in parts), default=0.0),
            n_samples=min((p.n_samples for p in parts), default=0),
            n_rejected=sum(p.n_rejected for p in parts))
        self._cache[key] = m
        return m

    def measure_program(self, program: lower.GroupProgram) -> list:
        return [self.measure_item(item) for item in program.items]

    # ---------------------------------------------------------- end to end
    def _e2e_sample(self, ex, x, calls: int) -> float:
        """Host seconds per request, synchronized: the latency a caller
        sees, host dispatch included."""
        cuda = self.device.type == "cuda"
        t0 = time.perf_counter()
        for _ in range(calls):
            ex(x)
        _sync(cuda)
        return (time.perf_counter() - t0) / calls

    def measure_strategy(self, strategy, *, repeats: int | None = None,
                         seed: int = 1) -> Measurement:
        """Time one full strategy through ``Int8Executor`` (the e2e number
        the tune benchmark compares across search evaluators)."""
        return self.measure_strategy_set(
            [strategy], passes=repeats if repeats is not None
            else self.repeats, seed=seed)[0]

    def measure_strategy_set(self, strategies: list, *,
                             passes: int | None = None,
                             seed: int = 1) -> list:
        """Alternate end-to-end passes across ``strategies`` so clock drift
        and interference epochs hit every contender equally.  Same robust
        centre as ``measure_set``; host clock (see :meth:`_e2e_sample`)."""
        passes = passes if passes is not None else self.repeats
        rng = np.random.default_rng(seed)
        shape = next(self.g.shape(n.name) for n in self.g if n.op == "input")
        x = rng.integers(-128, 128, shape).astype(np.int8)
        cuda = self.device.type == "cuda"
        units = []
        for s in strategies:
            ex = core_executor.Int8Executor(self.g, self.qm, strategy=s,
                                            backend=self.backend,
                                            device=self.device)
            for _ in range(max(1, self.warmup)):
                ex(x)
            _sync(cuda)
            probe = max(self._e2e_sample(ex, x, 1), 1e-9)
            calls = int(min(512, max(1, math.ceil(self.min_sample_s / probe))))
            units.append((s, ex, calls, []))
        for _ in range(max(1, passes)):
            for s, ex, calls, samples in units:
                samples.append(self._e2e_sample(ex, x, calls))
        out_ms = []
        for s, ex, calls, samples in units:
            loc, spread, n_ok, n_rej = _robust_center(
                samples, self.reject_nmad, self.center)
            nodes = tuple(nm for grp in s.groups for nm in grp)
            out_ms.append(Measurement(
                nodes=nodes, kind="e2e", seconds=loc, spread=spread,
                n_samples=n_ok, n_rejected=n_rej, samples=tuple(samples)))
        return out_ms
