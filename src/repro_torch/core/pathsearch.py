# Copied from src/repro/core/pathsearch.py; imports point at repro_torch.
"""Algorithm 2: heuristic shortest-path search for the best execution strategy.

The paper exchanges node/edge attributes so fused ops become *edges* weighted
by cost, sets *barriers* at operations that depend on more than one operation
or are depended on by different operations, runs Floyd between adjacent
barrier pairs, and enumerates the special cases (eltwise-add absorbed into one
incoming branch; horizontal fusion of convolutions sharing an input) at the
barriers themselves (§5.2, Fig. 4c/d, Algorithm 2 lines 4–12).

Concretely here:

  1. the compute DAG is decomposed into maximal single-in/single-out *chains*
     (barrier-to-barrier segments);
  2. each chain is optimally partitioned into fused segments by Floyd over
     cut-points — edge (i, j) exists iff ops[i+1..j] is a valid fused group
     (consecutive pairs match a kernel-fusion template AND the tiling solver
     proves fusion condition 1), weighted by the cost evaluator;
  3. at each eltwise merge barrier we enumerate absorbing the eltwise into
     each incoming branch vs. standalone, and keep the cheapest;
  4. at each fork barrier whose consumers are convolutions we enumerate
     horizontal fusion of the sibling heads.

A greedy baseline (what GPP compilers do, per §4.2) and the naive no-fusion
strategy are provided for the Table-3 comparison.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import isomorphism, templates, tiling
from repro_torch.core.cost import AnalyticEvaluator, INFEASIBLE
from repro_torch.core.xgraph import XGraph
from repro_torch.hw import DeviceModel

HORIZONTAL_OK = templates.CONVS | templates.POOLS

# Bounds for the recorded search trace (``Strategy.meta['search_trace']``).
# The trace is an audit record, not a database: per chain it keeps the chosen
# partition, the cheapest few scored-but-not-chosen alternatives, and a
# bounded sample of rejections — enough for ``repro.explain`` to say *why*
# this strategy and not another, at a few KB per model.
TRACE_MAX_CHAINS = 64
TRACE_MAX_ALTERNATIVES = 8
TRACE_MAX_REJECT_EXAMPLES = 4

# Machine-readable rejection vocabulary (mirrors lower.FALLBACK_REASONS in
# spirit): every candidate segment the search discards carries one of these.
REJECT_REASONS = frozenset({
    "no_fusion_template",   # a consecutive pair matches no kernel template
    "infeasible_tiling",    # tiling solver failed fusion condition 1 (Eq. 6)
})


@dataclasses.dataclass
class Strategy:
    groups: list[list[str]]          # topo-ordered; covers compute nodes once
    horizontal: list[list[str]]      # horizontal (shared-input) groups
    cost: float
    meta: dict = dataclasses.field(default_factory=dict)

    def covered(self) -> set:
        out: set[str] = set()
        for grp in self.groups + self.horizontal:
            out |= set(grp)
        return out


# ---------------------------------------------------------------- chains
def chains_of(g: XGraph, plannable: set) -> list[list[str]]:
    """Maximal chains of plannable nodes with single-in/single-out interiors."""
    def is_continuation(name: str) -> bool:
        node = g.nodes[name]
        preds = [p for p in node.inputs]
        if len(preds) != 1 or preds[0] not in plannable:
            return False
        return len(g.consumers(preds[0])) == 1

    chains = []
    for name in g.topo_order():
        if name not in plannable or is_continuation(name):
            continue
        chain = [name]
        cur = name
        while True:
            cons = g.consumers(cur)
            if len(cons) != 1:
                break
            nxt = cons[0]
            if nxt not in plannable or len(g.nodes[nxt].inputs) != 1:
                break
            chain.append(nxt)
            cur = nxt
        chains.append(chain)
    return chains


# ------------------------------------------------------------- chain Floyd
def _segment_valid(g: XGraph, ops: list[str], pairs: set) -> bool:
    return all((ops[k], ops[k + 1]) in pairs for k in range(len(ops) - 1))


def partition_chain(g: XGraph, chain: list[str], pairs: set, evaluator, *,
                    collect: dict | None = None,
                    seg_costs: dict | None = None) -> tuple[list[list[str]], float]:
    """Optimal partition of one chain into fused segments via Floyd (paper's
    choice; O(m^3) with m = chain length, m is small for real CNNs).

    ``collect``/``seg_costs`` are optional trace sinks: direct per-segment
    evaluator costs must be captured here at matrix-fill time, because the
    Floyd relaxation below overwrites ``cost[i][j]`` with multi-segment path
    costs and the candidate scores are unrecoverable afterwards."""
    m = len(chain)
    big = INFEASIBLE
    cost = [[big] * (m + 1) for _ in range(m + 1)]
    for i in range(m + 1):
        cost[i][i] = 0.0
    n_feasible = 0
    for i in range(m):
        for j in range(i + 1, m + 1):
            seg = chain[i:j]
            if j - i > 1 and not _segment_valid(g, seg, pairs):
                if collect is not None:
                    collect["rejected"].append((seg, "no_fusion_template"))
                continue
            c = evaluator(seg)
            if math.isfinite(c):
                cost[i][j] = c
                n_feasible += 1
                if seg_costs is not None:
                    seg_costs[tuple(seg)] = c
                if collect is not None:
                    collect["scored"].append((seg, c))
            elif collect is not None:
                collect["rejected"].append((seg, "infeasible_tiling"))
    if collect is not None:
        collect["m"] = m
        collect["n_feasible_segments"] = n_feasible
    nxt = [[-1] * (m + 1) for _ in range(m + 1)]
    for i in range(m + 1):
        for j in range(m + 1):
            if math.isfinite(cost[i][j]):
                nxt[i][j] = j
    # Floyd–Warshall (paper Algorithm 2 lines 17–25)
    for k in range(m + 1):
        ck = cost[k]
        for i in range(m + 1):
            cik = cost[i][k]
            if not math.isfinite(cik):
                continue
            ci = cost[i]
            for j in range(m + 1):
                c = cik + ck[j]
                if c < ci[j]:
                    ci[j] = c
                    nxt[i][j] = nxt[i][k]
    if not math.isfinite(cost[0][m]):
        raise RuntimeError(f"no feasible execution path for chain {chain}")
    # reconstruct segments
    segs, i = [], 0
    while i != m:
        j = nxt[i][m]
        segs.append(chain[i:j])
        i = j
    return segs, cost[0][m]


# ------------------------------------------------------------ the search
def search(g: XGraph, dev: DeviceModel, evaluator=None,
           device_of=None, enable_horizontal: bool = True,
           trace: bool = True) -> Strategy:
    from repro_torch.obs.trace import TRACER
    with TRACER.span("pathsearch", cat="compile", track="compile",
                     graph=g.name):
        return _search(g, dev, evaluator, device_of, enable_horizontal, trace)


def _search(g: XGraph, dev: DeviceModel, evaluator=None,
            device_of=None, enable_horizontal: bool = True,
            trace: bool = True) -> Strategy:
    evaluator = evaluator or AnalyticEvaluator(g, dev)
    plannable = {n.name for n in g
                 if n.op != "input" and (device_of is None or device_of(n.name) == "acc")}
    matches = isomorphism.find_all(g, templates.KERNEL_TEMPLATES)
    pairs = templates.pairwise_fusable(matches)

    chains = chains_of(g, plannable)
    chain_of_node = {}
    for idx, ch in enumerate(chains):
        for nm in ch:
            chain_of_node[nm] = idx

    # seg_costs is the global direct-cost ledger: every partition_chain call
    # (including the speculative eltwise-absorb / horizontal-tail probes below)
    # feeds it, so every segment that ends up a final group has its evaluator
    # score on record regardless of which probe first scored it.
    seg_costs: dict[tuple, float] | None = {} if trace else None
    chain_traces: list[dict] = []
    eltwise_trace: list[dict] = []
    horizontal_trace: list[dict] = []

    def _collector() -> dict | None:
        if not trace or len(chain_traces) >= TRACE_MAX_CHAINS:
            return None
        c = {"scored": [], "rejected": []}
        chain_traces.append(c)
        return c

    solved: dict[int, tuple[list[list[str]], float]] = {}
    for idx, ch in enumerate(chains):
        collect = _collector()
        solved[idx] = partition_chain(g, ch, pairs, evaluator,
                                      collect=collect, seg_costs=seg_costs)
        if collect is not None:
            collect["nodes"] = list(ch)
            collect["chosen"] = [list(s) for s in solved[idx][0]]
            collect["cost"] = solved[idx][1]

    # --- barrier case 1: absorb an eltwise merge into one incoming branch ----
    for idx, ch in enumerate(chains):
        head = ch[0]
        node = g.nodes[head]
        if node.op != "eltwise_add" or len(node.inputs) != 2:
            continue
        best_delta, best_move = 0.0, None
        options: list[dict] = []
        for prod in node.inputs:
            if prod not in chain_of_node or (prod, head) not in pairs:
                continue
            pidx = chain_of_node[prod]
            pch = chains[pidx]
            if pch[-1] != prod or pidx == idx:
                continue
            # candidate: chain' = pch + [head], this chain loses its head
            try:
                new_p, cost_p = partition_chain(g, pch + [head], pairs,
                                                evaluator, seg_costs=seg_costs)
            except RuntimeError:
                continue
            rest = ch[1:]
            if rest:
                new_c, cost_c = partition_chain(g, rest, pairs, evaluator,
                                                seg_costs=seg_costs)
            else:
                new_c, cost_c = [], 0.0
            old = solved[pidx][1] + solved[idx][1]
            delta = (cost_p + cost_c) - old
            options.append({"producer": prod, "delta_s": delta})
            if delta < best_delta:
                best_delta = delta
                best_move = (pidx, new_p, cost_p, new_c, cost_c, prod)
        if best_move:
            pidx, new_p, cost_p, new_c, cost_c, prod = best_move
            solved[pidx] = (new_p, cost_p)
            solved[idx] = (new_c, cost_c)
            chains[pidx] = chains[pidx] + [head]
            chains[idx] = ch[1:]
            chain_of_node[head] = pidx
        if trace and options:
            eltwise_trace.append({
                "eltwise": head,
                "absorbed": best_move is not None,
                "into": best_move[5] if best_move else None,
                "delta_s": best_delta if best_move else 0.0,
                "options": options,
            })

    # --- barrier case 2: horizontal fusion at forks ---------------------------
    horizontal: list[list[str]] = []
    h_cost = 0.0
    h_cost_of: dict[tuple, float] = {}
    if enable_horizontal:
        for name in g.topo_order():
            cons = [c for c in g.consumers(name)
                    if c in plannable and g.nodes[c].op in HORIZONTAL_OK]
            if len(cons) < 2:
                continue
            # only heads of their chains can be pulled out without splitting
            heads = [c for c in cons
                     if c in chain_of_node and chains[chain_of_node[c]][0] == c]
            if len(heads) < 2:
                continue
            if hasattr(evaluator, "horizontal_cost"):
                hcost = evaluator.horizontal_cost(heads)
            else:
                t = tiling.solve_horizontal(g, heads, dev)
                hcost = _tiling_seconds(t, dev) if t.feasible else INFEASIBLE
            if not math.isfinite(hcost):
                if trace:
                    horizontal_trace.append({
                        "input": name, "heads": list(heads), "fused": False,
                        "reason": "infeasible_tiling"})
                continue
            # compare: horizontal group + tails   vs   current chains
            olds, news, tails_groups = 0.0, hcost, []
            ok = True
            for c in heads:
                cidx = chain_of_node[c]
                olds += solved[cidx][1]
                rest = chains[cidx][1:]
                if rest:
                    try:
                        tg, tc = partition_chain(g, rest, pairs, evaluator,
                                                 seg_costs=seg_costs)
                    except RuntimeError:
                        ok = False
                        break
                else:
                    tg, tc = [], 0.0
                news += tc
                tails_groups.append((cidx, tg, tc))
            fused = ok and news < olds
            if fused:
                horizontal.append(heads)
                h_cost += hcost
                h_cost_of[tuple(heads)] = hcost
                for cidx, tg, tc in tails_groups:
                    solved[cidx] = (tg, tc)
            if trace:
                horizontal_trace.append({
                    "input": name, "heads": list(heads), "fused": fused,
                    "fused_cost_s": hcost,
                    "with_tails_cost_s": news if ok else None,
                    "split_cost_s": olds,
                })

    groups: list[list[str]] = []
    total = h_cost
    for idx in range(len(chains)):
        segs, c = solved[idx]
        groups.extend(segs)
        total += c
    # host / non-plannable compute nodes execute as their own units (cost 0 in
    # the accelerator schedule; the host handles them, paper §2.3.5)
    host_nodes = [n.name for n in g
                  if n.op != "input" and n.name not in plannable]
    strategy = Strategy(groups=_topo_sort_groups(g, groups), horizontal=horizontal,
                        cost=total, meta={"host_nodes": host_nodes,
                                          "n_pairs": len(pairs),
                                          "n_chains": len(chains)})
    if trace:
        strategy.meta["search_trace"] = _build_trace(
            g, dev, evaluator, matches, pairs, chains, chain_traces,
            eltwise_trace, horizontal_trace, seg_costs, h_cost_of, strategy)
    # provenance: which cost oracle picked this strategy.  A profile-guided
    # evaluator (tune.CalibratedEvaluator) carries its DeviceProfile; the hash
    # flows into the compiled artifact so a loaded plan knows what it was
    # tuned for (asm.artifact / runtime.Session surface mismatches).
    strategy.meta["evaluator"] = type(evaluator).__name__
    profile = getattr(evaluator, "profile", None)
    if profile is not None and hasattr(profile, "hash"):
        strategy.meta["profile_hash"] = profile.hash()
        strategy.meta["profile_name"] = profile.name
    # Tile-shape provenance: a profile-guided evaluator (tune.
    # CalibratedEvaluator) predicts the best kernel tile shape per group, so
    # every searched strategy carries shapes even before the measured tile
    # search (tune.tiles.search_tile_shapes) refines them.  Keys are
    # lower.tile_key of each launch's node cover; absent key = the kernel's
    # default heuristics (the PR-4 behaviour).
    if hasattr(evaluator, "tile_for"):
        from repro_torch.core.lower import tile_key

        tile_shapes = {}
        for grp in strategy.groups:
            shape = evaluator.tile_for(list(grp))
            if shape:
                tile_shapes[tile_key(grp)] = [int(v) for v in shape]
        if hasattr(evaluator, "tile_for_horizontal"):
            for heads in strategy.horizontal:
                for k, shape in evaluator.tile_for_horizontal(
                        list(heads)).items():
                    tile_shapes[k] = [int(v) for v in shape]
        if tile_shapes:
            strategy.meta["tile_shapes"] = tile_shapes
            strategy.meta["tile_source"] = "profile"
    _check_cover(g, strategy, plannable)
    return strategy


def greedy(g: XGraph, dev: DeviceModel, evaluator=None, device_of=None) -> Strategy:
    """Greedy template matching in topo order — the GPP-compiler baseline."""
    evaluator = evaluator or AnalyticEvaluator(g, dev)
    plannable = {n.name for n in g
                 if n.op != "input" and (device_of is None or device_of(n.name) == "acc")}
    matches = isomorphism.find_all(g, templates.KERNEL_TEMPLATES)
    pairs = templates.pairwise_fusable(matches)
    chains = chains_of(g, plannable)
    groups, total = [], 0.0
    for ch in chains:
        cur = [ch[0]]
        for nm in ch[1:]:
            cand = cur + [nm]
            # greedy: extend when the local pairwise fuse is profitable NOW —
            # this is the myopic rule the paper contrasts with (it commits to
            # the first profitable fuse and misses combinations, §4.2/Fig. 4b)
            if ((cur[-1], nm) in pairs
                    and evaluator(cand) < evaluator(cur) + evaluator([nm])):
                cur = cand
            else:
                groups.append(cur)
                total += evaluator(cur)
                cur = [nm]
        groups.append(cur)
        total += evaluator(cur)
    host_nodes = [n.name for n in g if n.op != "input" and n.name not in plannable]
    return Strategy(groups=_topo_sort_groups(g, groups), horizontal=[], cost=total,
                    meta={"host_nodes": host_nodes})


def naive(g: XGraph, dev: DeviceModel, evaluator=None, device_of=None) -> Strategy:
    """No kernel fusion: every op is its own group (paper's baseline)."""
    evaluator = evaluator or AnalyticEvaluator(g, dev)
    plannable = [n.name for n in g
                 if n.op != "input" and (device_of is None or device_of(n.name) == "acc")]
    groups = [[nm] for nm in plannable]
    total = sum(evaluator(grp) for grp in groups)
    host_nodes = [n.name for n in g if n.op != "input" and n.name not in set(plannable)]
    return Strategy(groups=groups, horizontal=[], cost=total,
                    meta={"host_nodes": host_nodes})


# ----------------------------------------------------------------- trace
def _build_trace(g, dev, evaluator, matches, pairs, chains, chain_traces,
                 eltwise_trace, horizontal_trace, seg_costs, h_cost_of,
                 strategy) -> dict:
    """Assemble the bounded, JSON-native search trace for strategy.meta.

    The trace answers three questions the final Strategy alone cannot: which
    fusion candidates were *considered* (scored alternatives with their costs),
    which were *rejected* and why (machine-readable reasons), and how the two
    barrier heuristics (eltwise absorb, horizontal fusion) decided.  When the
    evaluator is profile-guided, each final group also carries the analytic
    Eq. 5/6 prediction next to the calibrated one, so calibration influence
    stays visible per decision."""
    from repro_torch.core.lower import tile_key

    chosen_keys = {tuple(grp) for grp in strategy.groups}
    chain_records = []
    for ct in chain_traces:
        if "nodes" not in ct:       # collector allocated but chain never solved
            continue
        alternatives = sorted(
            ((seg, c) for seg, c in ct["scored"]
             if tuple(seg) not in chosen_keys),
            key=lambda sc: sc[1])[:TRACE_MAX_ALTERNATIVES]
        reasons: dict[str, int] = {}
        examples: list[dict] = []
        for seg, why in ct["rejected"]:
            reasons[why] = reasons.get(why, 0) + 1
            if len(examples) < TRACE_MAX_REJECT_EXAMPLES:
                examples.append({"nodes": list(seg), "reason": why})
        chain_records.append({
            "nodes": list(ct["nodes"]),
            "m": ct.get("m", len(ct["nodes"])),
            # frontier: how many candidate segments survived template matching
            # and the tiling-feasibility probe for this chain's Floyd matrix
            "frontier": ct.get("n_feasible_segments", 0),
            "cost_s": ct.get("cost"),
            "chosen": [{"nodes": list(s), "cost_s": seg_costs.get(tuple(s))}
                       for s in ct.get("chosen", [])],
            "alternatives": [{"nodes": list(s), "cost_s": c}
                             for s, c in alternatives],
            "n_rejected": reasons,
            "rejected_examples": examples,
        })

    # final group costs (direct evaluator scores, pre-Floyd-relaxation) keyed
    # the same way lowering/tiling key launches, so downstream consumers join
    # trivially; plus the analytic comparison when search was profile-guided.
    analytic = (evaluator if type(evaluator).__name__ == "AnalyticEvaluator"
                else AnalyticEvaluator(g, dev))
    group_costs: dict[str, dict] = {}
    for grp in strategy.groups:
        entry: dict = {"kind": "chain"}
        c = seg_costs.get(tuple(grp))
        if c is not None:
            entry["cost_s"] = c
        try:
            a = analytic(list(grp))
            entry["analytic_cost_s"] = a if math.isfinite(a) else None
        except Exception:
            entry["analytic_cost_s"] = None
        group_costs[tile_key(grp)] = entry
    for heads in strategy.horizontal:
        entry = {"kind": "horizontal"}
        c = h_cost_of.get(tuple(heads))
        if c is not None:
            entry["cost_s"] = c
        try:
            a = analytic.horizontal_cost(list(heads))
            entry["analytic_cost_s"] = a if math.isfinite(a) else None
        except Exception:
            entry["analytic_cost_s"] = None
        group_costs[tile_key(heads)] = entry

    return {
        "evaluator": type(evaluator).__name__,
        "templates": {t.name: len(embs) for t, embs in matches.items()},
        "n_fusable_pairs": len(pairs),
        "n_chains": len(chains),
        "n_chains_recorded": len(chain_records),
        "chains": chain_records,
        "eltwise_absorb": eltwise_trace,
        "horizontal": horizontal_trace,
        "group_costs": group_costs,
        "total_cost_s": strategy.cost,
        "bounds": {"max_chains": TRACE_MAX_CHAINS,
                   "max_alternatives": TRACE_MAX_ALTERNATIVES,
                   "max_reject_examples": TRACE_MAX_REJECT_EXAMPLES},
    }


# ----------------------------------------------------------------- helpers
def _tiling_seconds(t: tiling.GroupTiling, dev: DeviceModel) -> float:
    ddr = t.dram_bytes / dev.dram_bw_bytes_per_s
    conv = t.conv_cycles / dev.freq_hz
    misc = t.misc_cycles / dev.freq_hz
    steady = max(ddr, conv, misc)
    return steady + (ddr + conv + misc - steady) / max(1, t.n_spatial_tiles)


def _topo_sort_groups(g: XGraph, groups: list[list[str]]) -> list[list[str]]:
    return order_groups(g, groups)


def order_groups(g: XGraph, groups: list[list[str]]) -> list[list[str]]:
    """Topological order over groups: A before B if B consumes A's outputs.

    Stable tie-break by first-node graph position.  Works for any partition
    of (a subset of) compute nodes into disjoint groups."""
    import heapq

    pos = {nm: i for i, nm in enumerate(g.topo_order())}
    owner = {}
    for gi, grp in enumerate(groups):
        for nm in grp:
            owner[nm] = gi
    indeg = [0] * len(groups)
    succs: list[set] = [set() for _ in groups]
    for gi, grp in enumerate(groups):
        for nm in grp:
            for inp in g.nodes[nm].inputs:
                pi = owner.get(inp)
                if pi is not None and pi != gi and gi not in succs[pi]:
                    succs[pi].add(gi)
                    indeg[gi] += 1
    heap = [(pos[groups[i][0]], i) for i in range(len(groups)) if indeg[i] == 0]
    heapq.heapify(heap)
    out = []
    while heap:
        _, gi = heapq.heappop(heap)
        out.append(groups[gi])
        for si in succs[gi]:
            indeg[si] -= 1
            if indeg[si] == 0:
                heapq.heappush(heap, (pos[groups[si][0]], si))
    if len(out) != len(groups):
        raise AssertionError("cycle in group ordering — invalid fusion strategy")
    return out


def _check_cover(g: XGraph, s: Strategy, plannable: set) -> None:
    got = s.covered()
    if got != plannable:
        missing = plannable - got
        extra = got - plannable
        raise AssertionError(
            f"strategy cover mismatch: missing={sorted(missing)[:5]} extra={sorted(extra)[:5]}")
