"""Validation environment (paper §3.2, "Validation Module").

Port of ``src/repro/core/validate.py`` (``fused_coverage`` and
``bit_exact``).  The per-node fixed-point executor is the oracle; the fused
executor (the CUDA kernels on the card, their plain versions on the CPU) is
the side under test.  ``bit_exact`` fails on a single differing int8 value.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import lower
from repro_torch.core.executor import Int8Executor, build_float_fn
from repro_torch.core.quantize import QuantizedModel
from repro_torch.core.xgraph import XGraph


@dataclasses.dataclass
class ValidationReport:
    bit_exact: bool
    n_outputs: int
    max_abs_diff: int
    sqnr_db: dict  # vs float reference, per output

    def __bool__(self) -> bool:
        return self.bit_exact


@dataclasses.dataclass
class CoverageReport:
    """How much of a strategy the compiler lowered to fused launches."""
    n_groups: int            # strategy groups (excl. host + folded concat)
    n_fused: int             # groups entirely covered by FusedLaunch items
    n_launches: int
    fallback_reasons: dict   # reason -> count (every entry allow-listed)
    kinds: dict              # launch kind -> count

    @property
    def ratio(self) -> float:
        return (self.n_fused / self.n_groups) if self.n_groups else 1.0


def fused_coverage(g: XGraph, strategy, qm: QuantizedModel | None = None
                   ) -> CoverageReport:
    """Lower ``strategy`` (or read a carried ``.program``) and report the
    fused-execution coverage."""
    prog = getattr(strategy, "program", None)
    if prog is None:
        prog = lower.lower_strategy(g, strategy, qm)
    m = prog.meta
    return CoverageReport(
        n_groups=m["n_units"], n_fused=m["n_fused_units"],
        n_launches=m["n_launches"],
        fallback_reasons=dict(m["fallback_reasons"]), kinds=dict(m["kinds"]))


def bit_exact(g: XGraph, qm: QuantizedModel, x: np.ndarray, strategy=None,
              backend: str = "fused", float_params=None,
              device=None) -> ValidationReport:
    """The unfused ref executor against ``strategy`` on ``backend``, both on
    ``device`` (None: CUDA)."""
    ref = Int8Executor(g, qm, strategy=None, backend="ref", device=device)(x)
    got = Int8Executor(g, qm, strategy=strategy, backend=backend,
                       device=device)(x)
    assert set(ref) == set(got), f"output sets differ: {set(ref)} vs {set(got)}"
    ref = {k: v.cpu().numpy() for k, v in ref.items()}
    got = {k: v.cpu().numpy() for k, v in got.items()}
    max_diff = 0
    exact = True
    for k in ref:
        r, o = ref[k], got[k]
        if r.dtype != o.dtype or not np.array_equal(r, o):
            exact = False
            if r.shape == o.shape:
                max_diff = max(max_diff, int(np.max(np.abs(
                    r.astype(np.int64) - o.astype(np.int64)))))
            else:
                max_diff = -1
    sqnr = {}
    if float_params is not None:
        fl = build_float_fn(g, float_params, device=device)(
            np.asarray(x, np.float32))
        for k in ref:
            f = fl[k].cpu().numpy().astype(np.float64)
            q = ref[k].astype(np.float64)
            if np.issubdtype(ref[k].dtype, np.integer):
                q = q * 2.0 ** -qm.f_a[k]
            p_sig = float(np.mean(f ** 2)) or 1e-12
            p_err = float(np.mean((f - q) ** 2)) or 1e-12
            sqnr[k] = 10.0 * np.log10(p_sig / p_err)
    return ValidationReport(exact, len(ref), max_diff, sqnr)
