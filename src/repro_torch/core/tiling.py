# Copied from src/repro/core/tiling.py; imports point at repro_torch.
"""Capacity-constrained tiling (paper §4.3, Eq. 5–6), generalized to fused
chains.

The paper pins the tile sizes along height and output channel to the hardware
parallelism (Eq. 5: T_h = h_p, T_oc = oc_p, T_ic = inc_p) and maximizes the
tile width T_w subject to the three buffer constraints (Eq. 6).  F^{-1}/G^{-1}
map an output tile back to the input region it needs — for a fused chain this
is the *composed* receptive field of every op in the group.

Fused-chain capacity semantics (DESIGN.md §2, item 1):

* channel-wise consumers (pool / eltwise / upsample / reorg / relu) stream the
  producer's T_oc-channel tile — intermediate tiles are T_oc deep;
* a conv consumer needs *all* channels of its input, so any conv->conv
  boundary forces the upstream intermediate to be full-channel and resident in
  the output buffer (computed once per spatial tile, reused across the final
  op's oc passes — no recompute, the Alwani-style pyramid cost is avoided at
  the price of buffer space, which the constraint below charges for).

Traffic model (drives the CTC improvement of Eq. 1 -> Eq. 2):

* input feature maps are re-streamed once per final-oc pass (the paper's
  Fig. 6 loop order has oc outermost) unless the whole input fits in B_in;
* weights are loaded once if the group's working set fits B_weights, else
  once per spatial tile;
* intermediate feature maps inside a fused group never touch DRAM — that is
  the whole point of kernel fusion.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.hw import DeviceModel
from repro_torch.core.xgraph import XGraph

CHANNELWISE = {"maxpool", "avgpool", "global_avgpool", "eltwise_add",
               "upsample", "reorg"}


@dataclasses.dataclass
class GroupTiling:
    feasible: bool
    t_w: int = 0
    t_h: int = 0
    t_oc: int = 0
    n_spatial_tiles: int = 0
    n_oc_passes: int = 1
    load_bytes: int = 0        # external ifmap + eltwise side input traffic
    weight_bytes: int = 0      # weight traffic (incl. reloads)
    save_bytes: int = 0        # final ofmap traffic
    conv_cycles: int = 0       # CONV engine occupancy
    pool_cycles: int = 0       # POOL engine occupancy
    misc_cycles: int = 0       # MISC engine occupancy (eltwise/upsample/reorg)
    # per-tile on-chip footprints (memory/banks.py ping-pong planning):
    in_tile_bytes: int = 0     # one tile's ifmap + side-input slice in B_in
    out_tile_bytes: int = 0    # one tile's ofmap slice in B_out
    resident_bytes: int = 0    # full-channel intermediates pinned in B_out
    reason: str = ""

    @property
    def dram_bytes(self) -> int:
        return self.load_bytes + self.weight_bytes + self.save_bytes


def _rf(g: XGraph, name: str, w_out: int, h_out: int) -> tuple[int, int]:
    """Input tile extent needed by one op to produce a (w_out, h_out) tile."""
    node = g.nodes[name]
    a, op = node.attrs, node.op
    if op in ("conv", "dilated_conv", "depthwise_conv"):
        kh, kw = a["kernel"]
        dh, dw = a.get("dilation", (1, 1))
        sh, sw = a.get("stride", (1, 1))
        return ((w_out - 1) * sw + dw * (kw - 1) + 1,
                (h_out - 1) * sh + dh * (kh - 1) + 1)
    if op in ("maxpool", "avgpool"):
        kh, kw = a["kernel"]
        sh, sw = a.get("stride", a["kernel"])
        return ((w_out - 1) * sw + kw, (h_out - 1) * sh + kh)
    if op == "global_avgpool":
        ish = g.shape(node.inputs[0])
        return ish[2], ish[1]
    if op == "deconv":
        sh, sw = a.get("stride", (2, 2))
        return math.ceil(w_out / sw), math.ceil(h_out / sh)
    if op == "upsample":
        f = a.get("factor", 2)
        return math.ceil(w_out / f), math.ceil(h_out / f)
    if op == "reorg":
        s = a.get("stride", 2)
        return w_out * s, h_out * s
    if op == "fc":
        ish = g.shape(node.inputs[0])
        return ish[2], ish[1]
    return w_out, h_out  # eltwise / pointwise


def _conv_cycles(g: XGraph, name: str, dev: DeviceModel,
                 oc_override: int | None = None) -> int:
    node = g.nodes[name]
    n, oh, ow, oc = g.shape(name)
    if node.op not in ("conv", "dilated_conv", "depthwise_conv", "deconv", "fc"):
        return 0
    ic = g.shape(node.inputs[0])[3]
    if node.op == "fc":
        ish = g.shape(node.inputs[0])
        ic, oh, ow = ish[1] * ish[2] * ish[3], 1, 1
        kh = kw = 1
    else:
        kh, kw = node.attrs["kernel"]
    if node.op == "depthwise_conv":
        ic = 1
    oc_eff = oc_override if oc_override is not None else oc
    # padded MACs (ragged tiles round up to the array parallelism) retired at
    # the device's *effective* MAC rate (see DeviceModel.peak_ops_override)
    padded_macs = (n * math.ceil(oc_eff / dev.oc_p) * dev.oc_p
                   * math.ceil(ic / dev.ic_p) * dev.ic_p
                   * math.ceil(oh / dev.h_p) * dev.h_p * ow * kh * kw)
    return math.ceil(padded_macs / dev.macs_per_cycle_eff)


def solve(g: XGraph, group: list[str], dev: DeviceModel) -> GroupTiling:
    """Tile a fused chain ``group`` (topo-ordered node names) on ``dev``.

    Single-op groups use exactly the paper's Eq. 5/6: T_h/T_oc pinned to the
    array parallelism, T_w maximized under the buffer bounds.  Returns an
    infeasible tiling (with ``reason``) when even T_w = 1 violates a buffer
    bound — the path search then rejects the fusion (condition 1 fails).
    """
    return solve_shape(g, group, dev)


def solve_shape(g: XGraph, group: list[str], dev: DeviceModel,
                t_w: int | None = None, t_h: int | None = None,
                t_oc: int | None = None) -> GroupTiling:
    """Tile ``group`` with an explicit shape; ``None`` dims take the paper's
    Eq. 5/6 defaults (T_h = h_p, T_oc = oc_p, T_w maximized).  The returned
    tiling carries the full traffic/occupancy breakdown for the chosen shape,
    so ``enumerate_tilings`` candidates and the analytic default flow through
    one cost pipeline.
    """
    eb = dev.elem_bytes
    last = group[-1]
    n, H, W, OC = g.shape(last)
    first = group[0]
    ext_in = g.producers(first)[0] if g.producers(first) else None
    group_set = set(group)

    # Which boundaries are conv->conv (full-channel residents)?
    full_channel_after = {}
    for i, name in enumerate(group[:-1]):
        consumer = group[i + 1]
        full_channel_after[name] = g.nodes[consumer].op not in CHANNELWISE

    # side inputs (e.g. the second eltwise operand) loaded from DRAM per tile
    side_inputs = []
    for name in group:
        for inp in g.producers(name):
            if inp not in group_set and inp != ext_in:
                side_inputs.append(inp)

    t_h = min(dev.h_p, H) if t_h is None else max(1, min(int(t_h), H))
    t_oc = min(dev.oc_p, OC) if t_oc is None else max(1, min(int(t_oc), OC))

    total_weight_bytes = sum(g.param_bytes(nm, eb) for nm in group)
    weights_fit = total_weight_bytes <= dev.buf_weights_bytes

    def tile_footprint(t_w: int) -> tuple[int, int, int]:
        """(ifmap+side bytes in B_in, ofmap bytes in B_out, resident
        intermediates in B_out) for one tile of width ``t_w``."""
        # walk output -> input, tracking per-node tile extents
        w, h = t_w, t_h
        inter_bytes = 0
        for i in range(len(group) - 1, -1, -1):
            name = group[i]
            w, h = _rf(g, name, w, h)
            if i > 0:
                prod = group[i - 1]
                cdepth = (g.shape(prod)[3] if full_channel_after[prod] else t_oc)
                inter_bytes += w * h * min(cdepth, g.shape(prod)[3]) * eb
        ic_in = g.shape(ext_in)[3] if ext_in else 0
        in_tile = min(dev.ic_p, ic_in) * w * h * eb
        side_tile = sum(t_w * t_h * min(t_oc, g.shape(s)[3]) * eb
                        for s in side_inputs)
        out_tile = t_w * t_h * t_oc * eb
        return in_tile + side_tile, out_tile, inter_bytes

    def capacity_ok(t_w: int) -> bool:
        in_tile, out_tile, inter_bytes = tile_footprint(t_w)
        w_need = (total_weight_bytes if weights_fit else
                  sum(min(g.param_bytes(nm, eb),
                          dev.ic_p * dev.oc_p * _kk(g, nm) * eb) for nm in group))
        return (in_tile <= dev.buf_in_bytes
                and w_need <= dev.buf_weights_bytes
                and out_tile + inter_bytes <= dev.buf_out_bytes)

    if not capacity_ok(1):
        return GroupTiling(False, reason="working set exceeds on-chip buffers at T_w=1")

    if t_w is None:
        lo, hi = 1, W
        while lo < hi:  # binary search the largest feasible T_w
            mid = (lo + hi + 1) // 2
            if capacity_ok(mid):
                lo = mid
            else:
                hi = mid - 1
        t_w = lo
    else:
        t_w = max(1, min(int(t_w), W))
        if not capacity_ok(t_w):
            return GroupTiling(
                False, t_w=t_w, t_h=t_h, t_oc=t_oc,
                reason=f"tile ({t_w}, {t_h}, {t_oc}) exceeds on-chip buffers")

    n_w = math.ceil(W / t_w)
    n_h = math.ceil(H / t_h)
    n_spatial = n_w * n_h * max(1, n)
    n_oc_passes = math.ceil(OC / t_oc)

    # --- DRAM traffic ---------------------------------------------------------
    # per-tile input region (includes halo overlap between neighbouring tiles)
    w_in, h_in = t_w, t_h
    for i in range(len(group) - 1, -1, -1):
        w_in, h_in = _rf(g, group[i], w_in, h_in)
    ic_in = g.shape(ext_in)[3] if ext_in else 0
    in_bytes_full = g.fmap_bytes(ext_in, eb) if ext_in else 0
    per_tile_in = w_in * h_in * ic_in * eb
    input_resident = in_bytes_full <= dev.buf_in_bytes
    has_full_boundary = any(full_channel_after.values())
    in_sweep = min(per_tile_in * n_spatial, in_bytes_full * max(1, n_w * n_h))
    if input_resident and weights_fit:
        in_traffic, w_traffic = in_bytes_full, total_weight_bytes
    elif has_full_boundary:
        # conv->conv chain: upstream computes all channels once per spatial
        # tile, so input streams once; weights reload per tile unless resident
        in_traffic = in_sweep
        w_traffic = total_weight_bytes * (1 if weights_fit else n_spatial)
    else:
        # single conv / channel-wise chain: pick the cheaper loop order
        # (a) weight-stationary, oc outermost (paper Fig. 6): weights once,
        #     input re-streamed per oc pass
        ws = (in_sweep * (1 if input_resident else n_oc_passes),
              total_weight_bytes)
        # (b) input-stationary, spatial outermost: input once, weights
        #     re-streamed per spatial tile
        is_ = (in_sweep,
               total_weight_bytes * (1 if weights_fit else n_spatial))
        in_traffic, w_traffic = min((ws, is_), key=lambda t: t[0] + t[1])
    load_bytes = int(in_traffic) + sum(g.fmap_bytes(s, eb) for s in side_inputs)
    weight_traffic = int(w_traffic)
    save_bytes = g.fmap_bytes(last, eb)

    # --- engine occupancy ------------------------------------------------------
    conv_cycles = sum(_conv_cycles(g, nm, dev) for nm in group)
    pool_cycles = sum(math.ceil(g.misc_elems(nm) / dev.pool_elems_per_cycle)
                      for nm in group
                      if g.nodes[nm].op in ("maxpool", "avgpool", "global_avgpool"))
    misc_cycles = sum(math.ceil(g.misc_elems(nm) / dev.misc_elems_per_cycle)
                      for nm in group
                      if g.nodes[nm].op in ("eltwise_add", "upsample", "reorg"))

    in_tile_b, out_tile_b, resident_b = tile_footprint(t_w)
    return GroupTiling(
        True, t_w=t_w, t_h=t_h, t_oc=t_oc,
        n_spatial_tiles=n_spatial, n_oc_passes=n_oc_passes,
        load_bytes=int(load_bytes), weight_bytes=int(weight_traffic),
        save_bytes=int(save_bytes),
        conv_cycles=int(conv_cycles), pool_cycles=int(pool_cycles),
        misc_cycles=int(misc_cycles),
        in_tile_bytes=int(in_tile_b), out_tile_bytes=int(out_tile_b),
        resident_bytes=int(resident_b))


def _kk(g: XGraph, name: str) -> int:
    node = g.nodes[name]
    if "kernel" in node.attrs:
        kh, kw = node.attrs["kernel"]
        return kh * kw
    return 1


def unfused_tiling(g: XGraph, name: str, dev: DeviceModel) -> GroupTiling:
    return solve(g, [name], dev)


# ------------------------------------------------------- tile-shape search
def _shape_candidates_1d(p: int, extent: int) -> list[int]:
    """Multiples of the array parallelism ``p`` (1, 2, 4, ... times), capped
    by ``extent`` and always including the full extent."""
    out = []
    m = 1
    while p * m < extent:
        out.append(p * m)
        m *= 2
    out.append(extent)
    return sorted(set(out))


def _cells(t: GroupTiling) -> int:
    return max(1, t.n_spatial_tiles) * max(1, t.n_oc_passes)


def enumerate_tilings(g: XGraph, group: list[str], dev: DeviceModel, *,
                      pareto: bool = True, max_candidates: int = 32
                      ) -> list[GroupTiling]:
    """Enumerate feasible tile shapes for ``group`` on ``dev``.

    The paper pins (T_h, T_oc) to the array parallelism and maximizes T_w
    (Eq. 5/6) — one point of a larger feasible region.  This enumerates the
    grid of shapes whose T_h/T_oc are power-of-two multiples of the array
    parallelism (plus the full extents), with T_w the maximal feasible width
    for that (T_h, T_oc) and its halvings, every candidate capped by the
    Eq. 6 capacity check of :func:`solve_shape`.  T_oc candidates are kept to
    divisors of OC so a chosen shape is directly executable by the fused
    kernel's OC-tiled grid (ragged T_h/T_w are handled by the kernel's
    padded-coordinate masking; ragged T_oc would need weight padding).

    Returns the candidates with their full traffic/occupancy breakdowns,
    Pareto-pruned (unless ``pareto=False``) over (DRAM traffic, grid cells,
    on-chip footprint): a shape strictly worse on all three axes can never
    win under any cost model, so the search space handed to the tuner stays
    small without losing the optimum."""
    n, H, W, OC = g.shape(group[-1])
    cands: list[GroupTiling] = []
    seen: set[tuple] = set()
    for t_h in _shape_candidates_1d(dev.h_p, H):
        for t_oc in _shape_candidates_1d(dev.oc_p, OC):
            if OC % t_oc:
                continue            # kernel needs T_oc | OC (see docstring)
            best = solve_shape(g, group, dev, t_h=t_h, t_oc=t_oc)
            if not best.feasible:
                continue
            t_w = best.t_w
            widths = {t_w}
            while t_w > 1:
                t_w = (t_w + 1) // 2
                widths.add(t_w)
                if len(widths) >= 4:
                    break
            for w in sorted(widths, reverse=True):
                key = (w, t_h, t_oc)
                if key in seen:
                    continue
                seen.add(key)
                t = (best if w == best.t_w
                     else solve_shape(g, group, dev, t_w=w, t_h=t_h,
                                      t_oc=t_oc))
                if t.feasible:
                    cands.append(t)
    if pareto:
        cands = pareto_front(cands)
    cands.sort(key=lambda t: (_cells(t), t.dram_bytes,
                              -t.t_w, -t.t_h, -t.t_oc))
    return cands[:max_candidates]


def pareto_front(cands: list[GroupTiling]) -> list[GroupTiling]:
    """Drop candidates dominated on (DRAM bytes, grid cells, footprint)."""
    def axes(t: GroupTiling) -> tuple:
        return (t.dram_bytes, _cells(t),
                t.in_tile_bytes + t.out_tile_bytes + t.resident_bytes)

    out = []
    for t in cands:
        at = axes(t)
        dominated = any(
            all(b <= a for a, b in zip(at, axes(o)))
            and any(b < a for a, b in zip(at, axes(o)))
            for o in cands if o is not t)
        if not dominated:
            out.append(t)
    return out


def solve_horizontal(g: XGraph, siblings: list[str], dev: DeviceModel,
                     t_w: int | None = None, t_h: int | None = None,
                     t_oc: int | None = None) -> GroupTiling:
    """Horizontal fusion (paper §4.1.3 / §5.2): siblings share one input
    feature map, which is loaded once and reused by every member.

    Capacity: the shared input tile, the union of weight slices and every
    member's output tile must co-reside.  Traffic: input once, weights and
    outputs per member.  Engine time: members execute back-to-back on the
    CONV array (they contend for it) but share the LOAD stream.

    ``t_w``/``t_h``/``t_oc`` override the default shape (maximal co-resident
    T_w at T_h = h_p, T_oc = oc_p) — the tile-shape search serializes tuned
    shapes and the memory planner charges their true footprints.
    """
    eb = dev.elem_bytes
    parts = [solve(g, [s], dev) for s in siblings]
    if not all(p.feasible for p in parts):
        return GroupTiling(False, reason="a sibling is individually infeasible")
    src = g.producers(siblings[0])[0]
    in_bytes = g.fmap_bytes(src, eb)
    overridden = t_w is not None or t_h is not None or t_oc is not None
    t_h = dev.h_p if t_h is None else max(1, int(t_h))
    t_oc = dev.oc_p if t_oc is None else max(1, int(t_oc))
    w_need = sum(min(g.param_bytes(s, eb), dev.ic_p * dev.oc_p * _kk(g, s) * eb)
                 for s in siblings)

    def footprint(t_w: int) -> tuple[int, int]:
        """Co-resident (B_in, B_out) bytes for one t_w-wide tile of every
        member simultaneously — the shared input region plus each sibling's
        output slice."""
        in_tile = dev.ic_p * max(
            _rf(g, s, t_w, t_h)[0] * _rf(g, s, t_w, t_h)[1]
            for s in siblings) * eb
        out_tile = sum(t_w * t_h * min(t_oc, g.shape(s)[3]) * eb
                       for s in siblings)
        return in_tile, out_tile

    def fits(t_w: int) -> bool:
        in_tile, out_tile = footprint(t_w)
        return in_tile <= dev.buf_in_bytes and out_tile <= dev.buf_out_bytes

    if w_need > dev.buf_weights_bytes or not fits(1):
        return GroupTiling(False, reason="horizontal working set exceeds buffers")
    if t_w is None:
        # largest tile width at which all members co-reside (may be narrower
        # than each member's standalone t_w — the price of sharing buffers)
        lo, hi = 1, min(p.t_w for p in parts)
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if fits(mid):
                lo = mid
            else:
                hi = mid - 1
        t_w = lo
    else:
        t_w = max(1, min(int(t_w), min(p.t_w for p in parts)))
        if not fits(t_w):
            return GroupTiling(
                False, t_w=t_w, t_h=t_h, t_oc=t_oc,
                reason=f"horizontal tile ({t_w}, {t_h}, {t_oc}) exceeds buffers")
    in_tile, out_tile = footprint(t_w)
    n_spatial = max(
        math.ceil(g.shape(s)[2] / t_w) * math.ceil(g.shape(s)[1] / t_h)
        * max(1, g.shape(s)[0]) for s in siblings)
    if overridden:
        # explicit shape: the stream must carry the TRUE tile/pass counts of
        # what the kernel will run, not the default-shape sibling plans'
        n_oc_passes = max(math.ceil(g.shape(s)[3] / t_oc) for s in siblings)
        n_spatial_tiles = n_spatial
    else:
        n_oc_passes = max(p.n_oc_passes for p in parts)
        n_spatial_tiles = max(n_spatial, max(p.n_spatial_tiles for p in parts))
    # Input loaded once per shared pass (the fusion win).  The shared stream
    # must still be replayed as often as the *least demanding* member replays
    # it standalone: a member whose plan re-streams the input per oc pass
    # needs the bytes resident again on every pass.  Per-member reload factor
    # is an explicit ceil — flooring (the old ``// ... or 1``) undercounted
    # any member whose standalone plan re-streams a partially-resident input.
    reload = min(max(1, math.ceil(p.load_bytes / max(1, in_bytes)))
                 for p in parts)
    load = in_bytes * reload
    return GroupTiling(
        True,
        t_w=t_w, t_h=t_h, t_oc=t_oc,
        n_spatial_tiles=n_spatial_tiles,
        n_oc_passes=n_oc_passes,
        load_bytes=int(load),
        weight_bytes=sum(p.weight_bytes for p in parts),
        save_bytes=sum(p.save_bytes for p in parts),
        conv_cycles=sum(p.conv_cycles for p in parts),
        pool_cycles=sum(p.pool_cycles for p in parts),
        misc_cycles=sum(p.misc_cycles for p in parts),
        in_tile_bytes=int(in_tile),
        out_tile_bytes=int(out_tile),
        resident_bytes=0)
