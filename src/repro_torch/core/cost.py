# Copied from src/repro/core/cost.py; imports point at repro_torch.
"""Fused-operation cost evaluation (paper §5.1, Table 2).

The paper evaluates fused-op cost three ways: on-board (<1 s, 0% deviation),
a learned model (<1 min, 5–10%), and a cycle-accurate simulator (>10 min, 0%).
We provide all three, plus the fast analytic pipeline model used *inside* the
path search (the role the on-board measurement plays in the paper):

  * ``AnalyticEvaluator``  — closed-form steady-state pipeline bound:
        t = max(DDR, CONV, POOL/MISC) + fill
    from the tiling solution; also exposes CTC (Eq. 1/2).
  * ``SimulatorEvaluator`` — assembles the group's ISA stream and runs the
    time wheel; the reference cost.
  * ``ModelEvaluator``     — least-squares model over (MACs, DRAM bytes,
    misc elems, tiles) features, fitted against the simulator; reproduces the
    paper's 5–10% deviation band (EXPERIMENTS.md §Repro).

``OnBoardEvaluator`` (wall-clock of the executor) is left out of this copy:
it returns with the port's tuner.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.hw import DeviceModel
from repro_torch.core import isa, simulator, tiling
from repro_torch.core.xgraph import XGraph

INFEASIBLE = float("inf")


@dataclasses.dataclass
class GroupCost:
    seconds: float
    tiling: tiling.GroupTiling

    @property
    def feasible(self) -> bool:
        return math.isfinite(self.seconds)


def _pipeline_seconds(t: tiling.GroupTiling, dev: DeviceModel) -> float:
    """Steady-state pipeline bound: engines overlap across tiles; the fill
    cost of the non-dominant stages is paid once.  LOAD and SAVE ride the
    independent AXI read/write channels (cf. isa.ENGINES)."""
    rd = (t.load_bytes + t.weight_bytes) / dev.dram_bw_bytes_per_s
    wr = t.save_bytes / dev.dram_bw_bytes_per_s
    conv = t.conv_cycles / dev.freq_hz
    pool = t.pool_cycles / dev.freq_hz
    misc = t.misc_cycles / dev.freq_hz
    stages = (rd, wr, conv, pool, misc)
    steady = max(stages)
    return steady + (sum(stages) - steady) / max(1, t.n_spatial_tiles)


class AnalyticEvaluator:
    """Steady-state pipeline model — the default inside path search."""

    def __init__(self, g: XGraph, dev: DeviceModel):
        self.g, self.dev = g, dev
        self._cache: dict[tuple, GroupCost] = {}

    def __call__(self, group: list[str]) -> float:
        return self.cost(group).seconds

    def cost(self, group: list[str]) -> GroupCost:
        key = tuple(group)
        if key in self._cache:
            return self._cache[key]
        if all(self.g.nodes[nm].op == "concat" and
               self.g.nodes[nm].attrs.get("folded") for nm in group):
            gc = GroupCost(0.0, tiling.GroupTiling(True))  # layout-pruned
        else:
            t = tiling.solve(self.g, group, self.dev)
            gc = (GroupCost(INFEASIBLE, t) if not t.feasible
                  else GroupCost(_pipeline_seconds(t, self.dev), t))
        self._cache[key] = gc
        return gc

    def ctc(self, group: list[str]) -> float:
        """Computation-to-communication ratio (paper Eq. 1/2), ops per byte."""
        gc = self.cost(group)
        if not gc.feasible or gc.tiling.dram_bytes == 0:
            return 0.0
        comp = sum(self.g.ops(nm) for nm in group)
        return comp / gc.tiling.dram_bytes

    def horizontal_cost(self, heads: list[str]) -> float:
        t = tiling.solve_horizontal(self.g, heads, self.dev)
        if not t.feasible:
            return INFEASIBLE
        return _pipeline_seconds(t, self.dev)


class SimulatorEvaluator:
    """Time-wheel reference cost (evaluation method 3)."""

    def __init__(self, g: XGraph, dev: DeviceModel):
        self.g, self.dev = g, dev
        self._analytic = AnalyticEvaluator(g, dev)
        self._cache: dict[tuple, float] = {}

    def __call__(self, group: list[str]) -> float:
        key = tuple(group)
        if key not in self._cache:
            t = self._analytic.cost(group).tiling
            if not t.feasible:
                self._cache[key] = INFEASIBLE
            else:
                instrs = isa.emit_group(self.g, group, t, self.dev)
                self._cache[key] = simulator.run(instrs).seconds(self.dev.freq_hz)
        return self._cache[key]

    def horizontal_cost(self, heads: list[str]) -> float:
        t = tiling.solve_horizontal(self.g, heads, self.dev)
        if not t.feasible:
            return INFEASIBLE
        instrs = isa.emit_group(self.g, heads, t, self.dev)
        return simulator.run(instrs).seconds(self.dev.freq_hz)

    def strategy_report(self, strategy_or_groups) -> simulator.SimReport:
        """Simulate a whole strategy (chain groups + horizontal groups)."""
        if isinstance(strategy_or_groups, list):
            items = list(strategy_or_groups)
            tilings = [self._require(gr) for gr in items]
        else:
            s = strategy_or_groups
            from repro_torch.core.pathsearch import order_groups

            items = list(s.groups) + list(s.horizontal)
            items = order_groups(self.g, items)
            hset = {tuple(h) for h in s.horizontal}
            tilings = [
                tiling.solve_horizontal(self.g, gr, self.dev)
                if tuple(gr) in hset else self._require(gr)
                for gr in items
            ]
        instrs = isa.emit_strategy(self.g, items, tilings, self.dev)
        return simulator.run(instrs)

    def _require(self, gr: list[str]) -> tiling.GroupTiling:
        t = self._analytic.cost(gr).tiling
        if not t.feasible:
            raise ValueError(f"infeasible group {gr}")
        return t


class ModelEvaluator:
    """Learned cost model (evaluation method 2): least squares over
    engine-occupancy features (the per-engine times a pipelined execution
    interleaves — the paper fits a small NN to the same signal), trained
    against the simulator on this graph's candidate groups."""

    # No max-term feature on purpose: a linear model must APPROXIMATE the
    # pipelined max() the way the paper's NN approximates real hardware —
    # that's where the 5-10% deviation band comes from.
    FEATURES = ("t_rd", "t_wr", "t_conv", "t_pool", "t_misc", "one")

    def __init__(self, g: XGraph, dev: DeviceModel, train_groups: list[list[str]],
                 targets: list[float] | None = None):
        """``targets`` (seconds per train group) overrides the simulator as
        the fit's ground truth — the autotuner refits this model against
        harness-measured wall-clock (``tune.calibrate``)."""
        self.g, self.dev = g, dev
        if targets is not None and len(targets) != len(train_groups):
            raise ValueError(f"{len(targets)} targets for "
                             f"{len(train_groups)} train groups")
        self._sim = None if targets is not None else SimulatorEvaluator(g, dev)
        self._analytic = AnalyticEvaluator(g, dev)
        X, y = [], []
        for k, gr in enumerate(train_groups):
            c = targets[k] if targets is not None else self._sim(gr)
            if c is None or not math.isfinite(c):
                continue
            X.append(self._features(gr))
            y.append(c)
        X, y = np.asarray(X), np.asarray(y)
        self.coef, *_ = np.linalg.lstsq(X, y, rcond=None)
        pred = X @ self.coef
        self.fit_mape = float(np.mean(np.abs(pred - y) / np.maximum(y, 1e-12)))

    def _features(self, group: list[str]) -> list[float]:
        t = self._analytic.cost(group).tiling
        dev = self.dev
        rd = (t.load_bytes + t.weight_bytes) / dev.dram_bw_bytes_per_s
        wr = t.save_bytes / dev.dram_bw_bytes_per_s
        conv = t.conv_cycles / dev.freq_hz
        pool = t.pool_cycles / dev.freq_hz
        misc = t.misc_cycles / dev.freq_hz
        return [rd, wr, conv, pool, misc, 1.0]

    def __call__(self, group: list[str]) -> float:
        t = tiling.solve(self.g, group, self.dev)
        if not t.feasible:
            return INFEASIBLE
        return float(np.dot(self._features(group), self.coef))

