# Copied from src/repro/core/isomorphism.py; imports point at repro_torch.
"""Algorithm 1: heuristic subgraph isomorphism for fusion-opportunity search.

Faithful to the paper's pseudo-code (§4.2), which itself distils Ullmann/VF2/
boostIso ideas:

  * ``FilterCandidates``  — per query vertex, all graph vertices of matching
    type; abort early if any candidate set is empty (lines 2–7).
  * ``DefineStartPoint``  — the query vertex whose type occurs *least often*
    in the data graph (the paper's Conv-vs-Pool example), minimizing the
    recursion tree (line 8).
  * ``SubgraphSearch``    — recursive extension in BFS order from the start
    vertex; ``RefineCandidates`` prunes candidates not adjacent (with correct
    edge direction) to already-matched vertices; ``Matching`` checks type,
    adjacency, injectivity and the template's semantic predicate (lines 10–22).

Enumerates *all* distinct embeddings — this is exactly what the greedy
matchers in GPP compilers don't do, and what feeds the global path search.
"""
from __future__ import annotations

from collections import deque
from typing import Iterator

from repro_torch.core.templates import Template
from repro_torch.core.xgraph import XGraph


def find_embeddings(g: XGraph, template: Template) -> list[dict]:
    """All distinct embeddings of ``template`` in ``g`` as {var: node_name}."""
    return list(iter_embeddings(g, template))


def iter_embeddings(g: XGraph, template: Template) -> Iterator[dict]:
    # --- FilterCandidates ---------------------------------------------------
    candidates: dict[str, list[str]] = {}
    for var, types in template.vertices.items():
        cand = [n.name for n in g if n.op in types]
        if not cand:
            return  # some query vertex has no candidate: no embeddings
        candidates[var] = cand

    # --- DefineStartPoint: rarest candidate set -----------------------------
    start = min(candidates, key=lambda v: len(candidates[v]))

    # --- BFS order over the (undirected view of the) pattern ----------------
    adj: dict[str, list[tuple[str, bool]]] = {v: [] for v in template.vertices}
    for (u, v) in template.edges:
        adj[u].append((v, True))    # u -> v : True means "v consumes u"
        adj[v].append((u, False))
    order = [start]
    seen = {start}
    dq = deque([start])
    while dq:
        cur = dq.popleft()
        for nxt, _ in adj[cur]:
            if nxt not in seen:
                seen.add(nxt)
                order.append(nxt)
                dq.append(nxt)
    if len(order) != len(template.vertices):
        raise ValueError(f"template {template.name} is not connected")

    # --- SubgraphSearch ------------------------------------------------------
    M: dict[str, str] = {}

    def refine(var: str) -> list[str]:
        """RefineCandidates: keep candidates adjacent to matched neighbours."""
        cand = candidates[var]
        for nbr, nbr_consumes_var_src in adj[var]:
            if nbr not in M:
                continue
            u = M[nbr]
            if nbr_consumes_var_src:
                # pattern edge var -> nbr : graph node must be a producer of u
                allowed = set(g.producers(u))
            else:
                allowed = set(g.consumers(u))
            cand = [c for c in cand if c in allowed]
        return cand

    def matching(node: str, var: str) -> bool:
        if node in M.values():
            return False  # injective
        if g.nodes[node].op not in template.var_types(var):
            return False
        return True

    def search(depth: int) -> Iterator[dict]:
        if depth == len(order):
            m = dict(M)
            if template.predicate is None or template.predicate(g, m):
                yield m
            return
        var = order[depth]
        for u in refine(var):
            if matching(u, var):
                M[var] = u
                yield from search(depth + 1)
                del M[var]

    yield from search(0)


def find_all(g: XGraph, templates) -> dict:
    """Embeddings for every template: {Template: [embedding, ...]}."""
    return {t: find_embeddings(g, t) for t in templates}
