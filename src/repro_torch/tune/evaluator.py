"""Profile-guided cost evaluation: features + the CalibratedEvaluator.

Port of ``src/repro/tune/evaluator.py``.  Two feature domains turn a
candidate group into the work-unit vector a
:class:`~repro_torch.tune.profile.DeviceProfile` prices (order =
``profile.COEF_NAMES``):

* ``"analytic"`` — the analytic pipeline model's own stage quantities from
  the tiling solution (DRAM bytes, padded MACs, pool/misc elements, spatial
  tiles).  Identical to the reference: calibrating against the cycle
  simulator gives the reference's coefficients.
* ``"kernel"``  — the work the CUDA launch performs on the card, from the
  kernel's own geometry (``chain_geometry``, ``chain_plan``'s layout, the
  costing of ``_plan_cost``, ``horizontal_plan``).

The kernel domain differs from the reference's, which counts the Pallas
kernel's work in interpret mode:

* the tile is the card's: a launch's tile record as the card runs it, else
  ``choose_chain_tile`` (the reference: ``_resolve_tile``);
* every CUDA block recomputes the chain's upstream stages (those before the
  last conv) at full channels for its OC tile, so all stages are charged
  once per block (the reference charges upstream stages once per row cell:
  XLA hoists them out of its grid loop);
* ``rd`` holds, per block, the halo'd input window (as the kernel holds
  it: cut where it reaches past what the first stage reads,
  ``ops._windows``), the elt sides' windows and the weight bytes the block
  reads: its panel, staged once by
  ``cp.async``, or where the panel did not fit beside the windows,
  streamed through the weight ring once per pass of its tile along the
  pixels of the block's images (``ops.ring_passes``; the reference leaves
  weight panels out of ``rd``);
* ``conv_steps`` counts the int8 ``mma.sync.m16n8k32`` instructions the
  blocks issue (``_plan_cost``'s issued work, padding included), in place of
  the reference's per-tap patch-matmul operand traffic;
* ``pool_steps`` / ``misc_steps`` count pool / eltwise stages per block
  (a barrier and a pass over the window each), ``cells`` the CUDA blocks;
* a horizontal launch is the implicit GEMM of ``horizontal_mma_kernel``:
  its blocks, K slices and split-K partial sums from ``horizontal_plan``
  (M, N and K alone decide them; a tile record does not move them).

:class:`CalibratedEvaluator` prices groups with a fitted profile and is a
drop-in for ``AnalyticEvaluator`` inside ``pathsearch.search(evaluator=...)``:
same call protocol (``__call__`` + ``horizontal_cost``), same INFEASIBLE
semantics (fusion condition 1 still comes from the tiling solver — a profile
never makes an unplaceable group placeable).
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.core import lower, tiling
from repro_torch.core.cost import INFEASIBLE, AnalyticEvaluator
from repro_torch.core.xgraph import XGraph
from repro_torch.hw import DeviceModel
from repro_torch.kernels.conv_fused import ops as fused_ops
from repro_torch.tune.profile import COEF_NAMES, DeviceProfile

(_RD, _WR, _CONV, _POOL, _MISC,
 _CONV_STEPS, _POOL_STEPS, _MISC_STEPS, _CELLS, _LAUNCH) = range(len(COEF_NAMES))
_STAGE_IDX = (_RD, _WR, _CONV, _POOL, _MISC)
_OVERHEAD_IDX = (_CONV_STEPS, _POOL_STEPS, _MISC_STEPS, _CELLS, _LAUNCH)


# ------------------------------------------------------------------ features
def _analytic_vec(t: tiling.GroupTiling, dev: DeviceModel):
    f = np.zeros(len(COEF_NAMES))
    f[_RD] = t.load_bytes + t.weight_bytes
    f[_WR] = t.save_bytes
    f[_CONV] = t.conv_cycles * dev.macs_per_cycle_eff
    f[_POOL] = t.pool_cycles * dev.pool_elems_per_cycle
    f[_MISC] = t.misc_cycles * dev.misc_elems_per_cycle
    f[_CELLS] = t.n_spatial_tiles * max(1, t.n_oc_passes)
    f[_LAUNCH] = 1.0
    return f, max(1, t.n_spatial_tiles)


def chain_geometry_of(g: XGraph, launch: lower.FusedLaunch) -> tuple:
    """(oh, ow, oc, c_in, oc_list) of a chain launch over ``g``'s shapes
    (``ops.launch_geometry``)."""
    conv_ocs = [g.shape(st[1])[3] for st in launch.stages if st[0] == "conv"]
    return fused_ops.launch_geometry(launch, g.shape(launch.in_name),
                                     conv_ocs)


def chain_tile(g: XGraph, launch: lower.FusedLaunch) -> tuple:
    """The (th, tw, toc, ni) the card runs the launch at over ``g``'s
    shapes: its tile record's (th, tw, toc) with the chooser's images a
    block (``ops.launch_tile``), else the card's ``choose_chain_tile``."""
    oh, ow, oc, c_in, oc_list = chain_geometry_of(g, launch)
    in_shape = (max(1, g.shape(launch.in_name)[0]),
                *g.shape(launch.in_name)[1:])
    conv_ocs = [g.shape(st[1])[3] for st in launch.stages if st[0] == "conv"]
    return fused_ops.launch_tile(launch, in_shape, conv_ocs) or (
        fused_ops.choose_chain_tile(launch.stages, oh, ow, oc, c_in,
                                    in_shape[0], oc_list))


def _chain_vec(g: XGraph, launch: lower.FusedLaunch):
    """Work one chain launch performs on the card (module docstring)."""
    chain = launch.stages
    oh, ow, oc, c_in, oc_list = chain_geometry_of(g, launch)
    th, tw, toc, ni = chain_tile(g, launch)
    geom = fused_ops.chain_geometry(chain, th, oh, ow, tw)
    ch, last_conv = fused_ops._chain_channels(chain, c_in,
                                              lambda i: oc_list[i])
    lay = fused_ops._layout(chain, geom, ch, last_conv, c_in, toc, ni)
    blocks = (-(-max(1, g.shape(launch.in_name)[0]) // ni) * geom["n_h"]
              * geom["n_w"] * (oc // toc))
    cout = lay["cout"]
    per = np.zeros(len(COEF_NAMES))          # one block's work
    per[_RD] = (ni * lay["windows"][0][0] * lay["windows"][0][1]
                * lay["in_c"])
    per[_WR] = ni * th * tw * toc
    cin = lay["in_c"]
    for i, st in enumerate(chain):
        px = ni * lay["rows"][i] * lay["cols"][i]
        if st[0] == "conv":
            nt = fused_ops.conv_nt(cout[i])
            m_items = -(-px // 16)
            kp = lay["kps"][i]
            per[_RD] += (fused_ops._align(cout[i], 8 * nt) * kp
                         if i in lay["staged"] else
                         fused_ops.ring_passes(cout[i], px)[2] * cout[i] * kp)
            per[_CONV] += px * cin * st[2] * st[3] * cout[i]
            per[_CONV_STEPS] += (m_items * -(-cout[i] // (8 * nt))
                                 * (kp // 32) * nt)
        elif st[0] == "pool":
            per[_POOL] += px * cout[i] * st[3] * st[4]
            per[_POOL_STEPS] += 1
        else:                                          # eltwise
            per[_RD] += px * cout[i]
            per[_MISC] += px * cout[i]
            per[_MISC_STEPS] += 1
        cin = cout[i]
    f = per * blocks
    f[_CELLS] = blocks
    f[_LAUNCH] = 1.0
    return f


def _horizontal_vec(g: XGraph, launch: lower.FusedLaunch):
    """Work one horizontal launch performs on the card: the implicit GEMM
    of ``horizontal_mma_kernel`` under ``horizontal_plan``."""
    kh, kw = launch.kernel
    oh, ow = launch.out_hw
    oc = sum(oc_m for _, oc_m, _, _ in launch.members)
    n, _, _, ic = g.shape(launch.in_name)
    m, k = max(1, n) * oh * ow, kh * kw * ic
    plan = fused_ops.horizontal_plan(m, oc, k)
    gx, gy, split = plan["grid"]
    blocks = gx * gy * split
    kslice = plan["steps"] // split * fused_ops.HBK
    np_ = -(-oc // fused_ops.HBN) * fused_ops.HBN
    f = np.zeros(len(COEF_NAMES))
    f[_RD] = blocks * (plan["bm"] + fused_ops.HBN) * kslice
    # split-K adds int32 partial sums into a scratch before the int8 output
    f[_WR] = m * oc + (4 * m * np_ * split if split > 1 else 0)
    f[_CONV] = m * k * oc
    f[_CONV_STEPS] = (blocks * (plan["bm"] // 16) * (fused_ops.HBN // 8)
                      * -(-kslice // 32))
    f[_CELLS] = blocks
    f[_LAUNCH] = 1.0
    return f


def group_features(g: XGraph, dev: DeviceModel, group: list, *,
                   domain: str = "kernel",
                   analytic: AnalyticEvaluator | None = None):
    """Feature vector + fill divisor for one chain group, or ``None`` when the
    group is infeasible on ``dev`` (tiling condition 1)."""
    analytic = analytic or AnalyticEvaluator(g, dev)
    gc = analytic.cost(group)
    if not gc.feasible:
        return None
    t = gc.tiling
    fa, n_fill = _analytic_vec(t, dev)
    if domain == "analytic":
        return fa, n_fill
    item = lower.lower_group(g, None, list(group))
    if isinstance(item, lower.FusedLaunch):
        return _chain_vec(g, item), n_fill
    # ref fallback executes the per-node torch path: analytic work
    # quantities, one launch, per-node op dispatch
    fa[_CELLS] = len(group)
    fa[_MISC_STEPS] = len(group)
    return fa, n_fill


def horizontal_features(g: XGraph, dev: DeviceModel, heads: list, *,
                        domain: str = "kernel"):
    t = tiling.solve_horizontal(g, heads, dev)
    if not t.feasible:
        return None
    fa, n_fill = _analytic_vec(t, dev)
    if domain == "analytic":
        return [(fa, n_fill)]
    out = []
    for item in lower.lower_horizontal(g, None, list(heads)):
        if isinstance(item, lower.FusedLaunch) and item.kind == "horizontal":
            out.append((_horizontal_vec(g, item), n_fill))
        elif isinstance(item, lower.FusedLaunch):
            out.append((_chain_vec(g, item), n_fill))
        else:
            part = group_features(g, dev, list(item.nodes), domain=domain)
            if part is None:
                return None
            out.append(part)
    return out


# ----------------------------------------------------------------- evaluator
def predict_seconds(profile: DeviceProfile, f, n_fill: int) -> float:
    """Price one feature vector under a fitted profile.  Dispatch overheads
    (steps / cells / launch) are additive in both forms — they are serial
    issue cost, never hidden by the engine pipeline."""
    c = np.asarray(profile.coef)
    f = np.asarray(f)
    stage = c[list(_STAGE_IDX)] * f[list(_STAGE_IDX)]
    fixed = float((c[list(_OVERHEAD_IDX)] * f[list(_OVERHEAD_IDX)]).sum())
    if profile.combine == "sum":
        return float(stage.sum() + fixed)
    steady = float(stage.max())
    return float(steady + (stage.sum() - steady) / max(1, n_fill) + fixed)


def predict_item_seconds(profile: DeviceProfile, g: XGraph, dev: DeviceModel,
                         item) -> float | None:
    """Predicted seconds for one lowered ``GroupProgram`` item under a fitted
    profile, or ``None`` when the item has no finite prediction (host-op
    fallbacks, infeasible tilings, layout-pruned concats).  Unlike
    :meth:`CalibratedEvaluator.__call__`, this prices the item the artifact
    carries, its tile record included."""
    if isinstance(item, lower.RefFallback):
        if all(g.nodes[nm].op == "concat" and g.nodes[nm].attrs.get("folded")
               for nm in item.nodes):
            return None                      # pruned at emit; nothing runs
        got = group_features(g, dev, list(item.nodes),
                             domain=profile.features)
        return None if got is None else predict_seconds(profile, *got)
    if item.kind == "horizontal":
        heads = [m[0] for m in item.members]
        t = tiling.solve_horizontal(g, heads, dev)
        if not t.feasible:
            return None
        fa, n_fill = _analytic_vec(t, dev)
        f = _horizontal_vec(g, item) if profile.features == "kernel" else fa
        return predict_seconds(profile, f, n_fill)
    gc = AnalyticEvaluator(g, dev).cost(list(item.nodes))
    if not gc.feasible:
        return None
    fa, n_fill = _analytic_vec(gc.tiling, dev)
    f = _chain_vec(g, item) if profile.features == "kernel" else fa
    return predict_seconds(profile, f, n_fill)


class CalibratedEvaluator:
    """Group cost = profile-priced measured-world work (drop-in for
    ``AnalyticEvaluator`` inside ``pathsearch.search``)."""

    def __init__(self, g: XGraph, dev: DeviceModel, profile: DeviceProfile):
        self.g, self.dev, self.profile = g, dev, profile
        self._analytic = AnalyticEvaluator(g, dev)
        self._cache: dict[tuple, float] = {}

    def __call__(self, group: list) -> float:
        key = ("c", tuple(group))
        if key in self._cache:
            return self._cache[key]
        if all(self.g.nodes[nm].op == "concat" and
               self.g.nodes[nm].attrs.get("folded") for nm in group):
            cost = 0.0                      # layout-pruned, like the analytic
        else:
            got = group_features(self.g, self.dev, group,
                                 domain=self.profile.features,
                                 analytic=self._analytic)
            cost = (INFEASIBLE if got is None
                    else predict_seconds(self.profile, *got))
        self._cache[key] = cost
        return cost

    def horizontal_cost(self, heads: list) -> float:
        key = ("h", tuple(heads))
        if key in self._cache:
            return self._cache[key]
        got = horizontal_features(self.g, self.dev, heads,
                                  domain=self.profile.features)
        cost = (INFEASIBLE if got is None else
                sum(predict_seconds(self.profile, f, n) for f, n in got))
        self._cache[key] = cost
        return cost

    def strategy_cost(self, strategy) -> float:
        """Predicted end-to-end seconds of a whole strategy (sum of groups)."""
        total = sum(self(list(grp)) for grp in strategy.groups)
        total += sum(self.horizontal_cost(list(h)) for h in strategy.horizontal)
        return total if math.isfinite(total) else INFEASIBLE

    # ------------------------------------------------------------ tile shapes
    def tile_for(self, group: list) -> tuple | None:
        """Profile-predicted best card tile for ``group``, or ``None`` when
        the card's chooser wins.  ``pathsearch.search`` calls this on every
        searched group.  Only meaningful in the "kernel" feature domain — an
        "analytic" profile prices the abstract tiling, not the launch."""
        if self.profile.features != "kernel":
            return None
        key = ("tile", tuple(group))
        if key in self._cache:
            return self._cache[key]
        from repro_torch.tune import tiles
        item = lower.lower_group(self.g, None, list(group))
        shape = None
        if isinstance(item, lower.FusedLaunch):
            shape = tiles.predict_best_shape(self.profile, self.g, self.dev,
                                             item)
        self._cache[key] = shape
        return shape

    def tile_for_horizontal(self, heads: list) -> dict:
        """Predicted shapes for a horizontal group's lowered chain launches,
        keyed by ``lower.tile_key`` of each launch's node cover ({} =
        defaults; a stacked launch never gets one, see ``run_launch``)."""
        if self.profile.features != "kernel":
            return {}
        key = ("tile-h", tuple(heads))
        if key in self._cache:
            return self._cache[key]
        from repro_torch.tune import tiles
        out = {}
        for item in lower.lower_horizontal(self.g, None, list(heads)):
            if isinstance(item, lower.FusedLaunch):
                shape = tiles.predict_best_shape(self.profile, self.g,
                                                 self.dev, item)
                if shape:
                    out[lower.tile_key(item.nodes)] = shape
        self._cache[key] = out
        return out
