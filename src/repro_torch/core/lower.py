# Copied from src/repro/core/lower.py; imports point at repro_torch.
"""Compile-time lowering: ``pathsearch.Strategy`` -> executable ``GroupProgram``.

The path search decides *what* to fuse; this pass decides — once, at compile
time — *how* every execution group runs on the accelerator backend.  The
result is a :class:`GroupProgram`: a topo-ordered list of

* :class:`FusedLaunch` — one kernel launch executing a whole group
  (an op chain ``conv -> ... -> {maxpool|avgpool|eltwise_add|gap}`` as a
  staged on-chip program, an ``fc`` re-expressed as a 1x1 conv, or a
  horizontal shared-input group batched over stacked weights), with every
  parameter the kernel needs (pads, strides, dilations, requantization
  shifts, masking extents) resolved; and
* :class:`RefFallback` — groups the kernel cannot run, each carrying a
  machine-readable ``reason`` from :data:`FALLBACK_REASONS`.

The executor becomes a dumb dispatcher over the program: it never inspects
the graph at run time, so fallback is an explicit, measured compiler decision
(``GroupProgram.meta['coverage']``) instead of a silent trace-time crutch.
The program serializes into the ``CompiledArtifact`` (``asm.artifact``), which
makes a loaded artifact self-contained.

Stage specs are plain tuples (JSON-safe, hashable — they become jit static
arguments):

  ("conv", node, kh, kw, sh, sw, ph, pw, dh, dw, shift, relu, out_h, out_w)
  ("pool", node, pkind, kph, kpw, sph, spw, pph, ppw, out_h, out_w, cnt)
  ("elt",  node, s_main, s_side, relu_out, out_h, out_w)

``pkind`` is "max" | "avg" | "gap"; ``cnt`` is the averaging divisor.  All
extents are *true* (unpadded) output extents — the kernel masks ragged/ceil
regions against them.
"""
from __future__ import annotations

import dataclasses
import math
from collections import Counter

from repro_torch.core.xgraph import XGraph, _padding

# Machine-readable fallback vocabulary.  Tests allow-list against this; any
# reason outside it is a lowering bug, not a legitimate fallback.
FALLBACK_REASONS = frozenset({
    "host_op",         # partitioned to the host by the mixed-compilation pass
    "folded_concat",   # layout no-op: producers SAVE with strides (zero cost)
    "unsupported_op",  # op with no fused-kernel support (softmax, reorg, ...)
    "unquantized",     # conv/fc weights missing from the QuantizedModel
    "gap_mid_chain",   # global pooling feeding further fused ops
})

# Ops the chain kernel can execute as stages.
_CHAIN_OPS = frozenset({"conv", "dilated_conv", "fc", "maxpool", "avgpool",
                        "global_avgpool", "eltwise_add"})


@dataclasses.dataclass(frozen=True)
class FusedLaunch:
    """One kernel launch, fully resolved at compile time."""
    kind: str                       # "chain" | "horizontal"
    nodes: tuple                    # graph nodes this launch covers
    in_name: str                    # external input tensor
    out_name: str = ""              # chain: env key written (== nodes[-1])
    stages: tuple = ()              # chain stage specs (see module docstring)
    sides: tuple = ()               # side tensor names, one per "elt" stage
    members: tuple = ()             # horizontal: (name, oc, shift, relu) each
    kernel: tuple = ()              # horizontal shared conv kernel (kh, kw)
    stride: tuple = ()              # horizontal shared stride
    pad: tuple = ()                 # horizontal shared explicit pad (ph, pw)
    out_hw: tuple = ()              # (oh, ow) of the final output
    fc_reshape: bool = False        # fc-as-1x1-conv: flatten input first
    tile: tuple = ()                # searched (t_h, t_w, t_oc); () = kernel
                                    # heuristics (see ops._resolve_tile)


@dataclasses.dataclass(frozen=True)
class RefFallback:
    """A group the compiler decided NOT to fuse, and why."""
    nodes: tuple
    reason: str                     # one of FALLBACK_REASONS
    detail: str = ""

    def __post_init__(self):
        if self.reason not in FALLBACK_REASONS:
            raise ValueError(f"unknown fallback reason {self.reason!r}")


@dataclasses.dataclass
class GroupProgram:
    """Topo-ordered lowered program + coverage accounting."""
    items: list                     # FusedLaunch | RefFallback
    meta: dict

    @property
    def coverage(self) -> float:
        return self.meta["coverage"]

    def launches(self):
        return [i for i in self.items if isinstance(i, FusedLaunch)]

    def fallbacks(self):
        return [i for i in self.items if isinstance(i, RefFallback)]


# ------------------------------------------------------------- stage builders
def _conv_stage(g: XGraph, qm, name: str):
    node = g.nodes[name]
    a = node.attrs
    kh, kw = a["kernel"]
    dh, dw = a.get("dilation", (1, 1))
    sh, sw = a.get("stride", (1, 1))
    ph, pw = _padding(a.get("pad", "same"), dh * (kh - 1) + 1, dw * (kw - 1) + 1)
    shift = qm.shift_for(g, name) if qm is not None else 0
    _, oh, ow, _ = g.shape(name)
    return ("conv", name, kh, kw, sh, sw, ph, pw, dh, dw,
            int(shift), bool(a.get("relu")), oh, ow)


def _fc_stage(g: XGraph, qm, name: str):
    shift = qm.shift_for(g, name) if qm is not None else 0
    return ("conv", name, 1, 1, 1, 1, 0, 0, 1, 1,
            int(shift), bool(g.nodes[name].attrs.get("relu")), 1, 1)


def _pool_stage(g: XGraph, name: str):
    """Returns a stage spec, or a RefFallback reason string."""
    node = g.nodes[name]
    a = node.attrs
    _, oh, ow, _ = g.shape(name)
    if node.op == "global_avgpool":
        _, ih, iw, _ = g.shape(node.inputs[0])
        return ("pool", name, "gap", ih, iw, 1, 1, 0, 0, 1, 1, ih * iw)
    kh, kw = a["kernel"]
    sh, sw = a.get("stride", a["kernel"])
    ph, pw = _padding(a.get("pad", "valid"), kh, kw)
    if node.op == "avgpool":
        # Ceil-extended windows read zeros (the avg pad identity) and keep the
        # kh*kw divisor — count_include_pad semantics, same as int8_ops.avgpool.
        return ("pool", name, "avg", kh, kw, sh, sw, ph, pw, oh, ow, kh * kw)
    return ("pool", name, "max", kh, kw, sh, sw, ph, pw, oh, ow, kh * kw)


def _elt_stage(g: XGraph, qm, name: str, main_input: str):
    node = g.nodes[name]
    side = [i for i in node.inputs if i != main_input]
    if len(node.inputs) != 2 or len(side) != 1:
        return None, None
    if qm is not None:
        s_main = qm.f_a[main_input] - qm.f_a[name]
        s_side = qm.f_a[side[0]] - qm.f_a[name]
    else:
        s_main = s_side = 0
    _, oh, ow, _ = g.shape(name)
    return ("elt", name, int(s_main), int(s_side),
            bool(node.attrs.get("relu")), oh, ow), side[0]


# ------------------------------------------------------------- group lowering
def tile_key(nodes) -> str:
    """JSON-safe key of a launch's node cover inside
    ``strategy.meta['tile_shapes']`` (node names never contain '|')."""
    return "|".join(nodes)


def lower_group(g: XGraph, qm, group: list,
                tile: tuple = ()) -> FusedLaunch | RefFallback:
    """Lower one chain group to a launch, or a reasoned fallback.

    ``tile`` is the searched (t_h, t_w, t_oc) shape the launch must execute
    (empty: the kernel's own heuristics)."""
    nodes = tuple(group)
    ops = [g.nodes[n].op for n in group]

    if all(op == "concat" and g.nodes[n].attrs.get("folded")
           for n, op in zip(group, ops)):
        return RefFallback(nodes, "folded_concat")
    for n, op in zip(group, ops):
        if op not in _CHAIN_OPS:
            return RefFallback(nodes, "unsupported_op", detail=op)
    if "fc" in ops and len(group) > 1:
        return RefFallback(nodes, "unsupported_op", detail="fc in chain")
    if qm is not None:
        for n, op in zip(group, ops):
            if op in ("conv", "dilated_conv", "fc") and n not in qm.weights:
                return RefFallback(nodes, "unquantized", detail=n)
    if "global_avgpool" in ops and ops.index("global_avgpool") != len(ops) - 1:
        return RefFallback(nodes, "gap_mid_chain")

    stages, sides = [], []
    head = g.nodes[group[0]]
    in_name = head.inputs[0]
    prev = in_name
    for n, op in zip(group, ops):
        if op in ("conv", "dilated_conv"):
            stages.append(_conv_stage(g, qm, n))
        elif op == "fc":
            stages.append(_fc_stage(g, qm, n))
        elif op == "eltwise_add":
            st, side = _elt_stage(g, qm, n, prev)
            if st is None:
                return RefFallback(nodes, "unsupported_op",
                                   detail=f"{len(g.nodes[n].inputs)}-ary eltwise")
            stages.append(st)
            sides.append(side)
        else:
            st = _pool_stage(g, n)
            if isinstance(st, str):
                return RefFallback(nodes, st)
            stages.append(st)
        prev = n
    _, oh, ow, _ = g.shape(group[-1])
    return FusedLaunch(kind="chain", nodes=nodes, in_name=in_name,
                       out_name=group[-1], stages=tuple(stages),
                       sides=tuple(sides), out_hw=(oh, ow),
                       fc_reshape=(ops == ["fc"]),
                       tile=tuple(int(t) for t in tile))


def lower_horizontal(g: XGraph, qm, members: list,
                     tile_map: dict | None = None) -> list:
    """Lower a horizontal (shared-input) group.

    Compatible plain-conv members (same kernel/stride/pad, dilation 1,
    quantized) become ONE batched launch over OC-stacked weights with
    per-channel requantization shifts; the rest lower individually (a lone
    conv or pool member is still a fused launch of its own).  ``tile_map``
    maps :func:`tile_key` of a launch's node cover to its searched tile
    shape."""
    tile_map = tile_map or {}
    classes: dict[tuple, list] = {}
    rest = []
    for m in members:
        node = g.nodes[m]
        a = node.attrs
        if (node.op == "conv" and tuple(a.get("dilation", (1, 1))) == (1, 1)
                and (qm is None or m in qm.weights)):
            kh, kw = a["kernel"]
            key = (kh, kw, tuple(a.get("stride", (1, 1))),
                   _padding(a.get("pad", "same"), kh, kw))
            classes.setdefault(key, []).append(m)
        else:
            rest.append(m)
    items = []
    for (kh, kw, stride, pad), ms in sorted(classes.items()):
        if len(ms) < 2:
            rest.extend(ms)
            continue
        mem = tuple(
            (m, g.shape(m)[3],
             int(qm.shift_for(g, m)) if qm is not None else 0,
             bool(g.nodes[m].attrs.get("relu")))
            for m in ms)
        _, oh, ow, _ = g.shape(ms[0])
        items.append(FusedLaunch(
            kind="horizontal", nodes=tuple(ms),
            in_name=g.nodes[ms[0]].inputs[0], members=mem,
            kernel=(kh, kw), stride=stride, pad=pad, out_hw=(oh, ow),
            tile=tuple(int(t) for t in tile_map.get(tile_key(ms), ()))))
    for m in sorted(rest, key=list(g.nodes).index):
        items.append(lower_group(g, qm, [m],
                                 tile=tile_map.get(tile_key((m,)), ())))
    return items


# ---------------------------------------------------------- strategy lowering
def lower_strategy(g: XGraph, strategy, qm=None) -> GroupProgram:
    """Lower a whole strategy (or per-node naive execution when ``strategy``
    is None) into a topo-ordered :class:`GroupProgram`.

    ``qm`` resolves requantization shifts; without it the program is
    *structural* (valid coverage accounting, zeroed shifts) and is re-lowered
    by the executor before running — ``meta['quantized']`` records which.

    ``strategy.meta['tile_shapes']`` (:func:`tile_key` of a launch's nodes ->
    (t_h, t_w, t_oc), written by the tile-shape search) is stamped onto the
    matching launches, so a tuned tile shape is a compile-time decision that
    rides the program into the artifact."""
    from repro_torch.core.pathsearch import order_groups

    tile_map: dict = {}
    if strategy is None:
        groups = [[n] for n in g.compute_nodes()]
        horizontal: list = []
        host: list = []
    else:
        groups = [list(grp) for grp in strategy.groups]
        horizontal = [list(h) for h in strategy.horizontal]
        host = list(strategy.meta.get("host_nodes", []))
        tile_map = dict(strategy.meta.get("tile_shapes") or {})

    units = order_groups(g, groups + horizontal + [[h] for h in host])
    hset = {tuple(h) for h in horizontal}
    host_set = set(host)

    items: list = []
    n_units = n_fused = n_host = n_folded = 0
    reasons: Counter = Counter()
    kinds: Counter = Counter()
    for unit in units:
        if len(unit) == 1 and unit[0] in host_set:
            items.append(RefFallback((unit[0],), "host_op"))
            reasons["host_op"] += 1
            n_host += 1
            continue
        got = (lower_horizontal(g, qm, unit, tile_map=tile_map)
               if tuple(unit) in hset
               else [lower_group(g, qm, unit,
                                 tile=tile_map.get(tile_key(unit), ()))])
        items.extend(got)
        if all(isinstance(i, RefFallback) and i.reason == "folded_concat"
               for i in got):
            n_folded += 1
            reasons["folded_concat"] += len(got)
            continue
        n_units += 1
        if all(isinstance(i, FusedLaunch) for i in got):
            n_fused += 1
        for i in got:
            if isinstance(i, FusedLaunch):
                kinds[i.kind] += 1
            else:
                reasons[i.reason] += 1

    meta = {
        "quantized": qm is not None,
        "n_units": n_units,            # strategy groups (excl. host & folded)
        "n_fused_units": n_fused,
        "coverage": (n_fused / n_units) if n_units else 1.0,
        "n_launches": sum(kinds.values()),
        "n_tiled_launches": sum(1 for i in items
                                if isinstance(i, FusedLaunch) and i.tile),
        "n_fallbacks": sum(1 for i in items if isinstance(i, RefFallback)),
        "n_host_units": n_host,
        "n_folded_units": n_folded,
        "kinds": dict(kinds),
        "fallback_reasons": dict(reasons),
    }
    return GroupProgram(items=items, meta=meta)


# -------------------------------------------------------------- serialization
def _tuplify(x):
    if isinstance(x, list):
        return tuple(_tuplify(v) for v in x)
    return x


def program_to_json(prog: GroupProgram) -> dict:
    out = []
    for item in prog.items:
        if isinstance(item, FusedLaunch):
            d = dataclasses.asdict(item)
            d["t"] = "launch"
        else:
            d = dataclasses.asdict(item)
            d["t"] = "fallback"
        out.append(d)
    return {"items": out, "meta": prog.meta}


def program_from_json(payload: dict) -> GroupProgram:
    items: list = []
    for d in payload["items"]:
        d = dict(d)
        t = d.pop("t")
        if t == "launch":
            items.append(FusedLaunch(**{k: _tuplify(v) if isinstance(v, list)
                                        else v for k, v in d.items()}))
        else:
            items.append(RefFallback(nodes=tuple(d["nodes"]),
                                     reason=d["reason"],
                                     detail=d.get("detail", "")))
    meta = dict(payload["meta"])
    return GroupProgram(items=items, meta=meta)
