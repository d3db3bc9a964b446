# Copied from src/repro/launch/hlo_analysis.py; collective_stats_from_comm added.
"""Post-SPMD HLO text analysis: per-device collective traffic with loop
trip-count accounting.

XLA emits each ``while`` body once; collectives inside a scanned layer stack
execute trip-count times.  We rebuild the computation graph from the HLO
text: computations are split on their header lines, ``while`` ops link a
parent computation to body/condition computations, and the trip count is
recovered from the loop-condition's compare constant.  Collective bytes are
then summed as result-shape bytes x ring-traffic factor x loop multiplier.

Ring-traffic factors (per-device bytes moved / result bytes):
  all-reduce       2 (N-1)/N   ~ 2
  all-gather         (N-1)/N   ~ 1
  reduce-scatter     (N-1)     (result is the shard; input = result x N)
  all-to-all         (N-1)/N   ~ 1
  collective-permute 1
"""
from __future__ import annotations

import contextlib
import re
import threading
from collections import Counter, defaultdict

import torch
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute")
_COMP_HDR = re.compile(r"^(?:ENTRY\s+)?(%[\w.\-]+)\s*\(.*\)\s*->.*\{\s*$")
_WHILE = re.compile(r"while\(.*?\).*condition=(%[\w.\-]+).*body=(%[\w.\-]+)|"
                    r"while\(.*?\).*body=(%[\w.\-]+).*condition=(%[\w.\-]+)")
_CALLS = re.compile(r"(?:calls|to_apply|body|condition)=(%[\w.\-]+)")
_CONST = re.compile(r"constant\((\d+)\)")
_SHAPE = re.compile(r"(bf16|f16|f32|f64|s8|u8|s16|u16|s32|u32|s64|u64|pred|"
                    r"c64|c128)\[([\d,]*)\]")
_RG_IOTA = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_RG_LIST = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")
_BYTES = {"bf16": 2, "f16": 2, "f32": 4, "f64": 8, "s8": 1, "u8": 1,
          "s16": 2, "u16": 2, "s32": 4, "u32": 4, "s64": 8, "u64": 8,
          "pred": 1, "c64": 8, "c128": 16}


def _split_computations(text: str) -> dict:
    comps: dict[str, list[str]] = {}
    cur = None
    for line in text.splitlines():
        m = _COMP_HDR.match(line.strip())
        if m:
            cur = m.group(1)
            comps[cur] = []
            continue
        if cur is not None:
            if line.strip() == "}":
                cur = None
            else:
                comps[cur].append(line)
    return comps


def _result_bytes(line: str) -> int:
    """Bytes of the op's result type (text between '=' and the op name)."""
    eq = line.find("=")
    if eq < 0:
        return 0
    rest = line[eq + 1:]
    for op in COLL_OPS:
        k = rest.find(op + "(")
        if k < 0:
            k = rest.find(op + "-start(")
        if k >= 0:
            rest = rest[:k]
            break
    total = 0
    for dt, dims in _SHAPE.findall(rest):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _BYTES[dt]
    return total


def _group_size(line: str) -> int:
    m = _RG_IOTA.search(line)
    if m:
        return int(m.group(2))
    m = _RG_LIST.search(line)
    if m:
        return m.group(1).count(",") + 1
    return 1


def _trip_count(cond_lines: list[str]) -> int:
    """Trip count = the constant operand of the condition's compare op (NOT
    the max constant in the computation — loop bodies hoist unrelated
    constants like cache lengths into the condition)."""
    consts: dict[str, int] = {}
    for l in cond_lines:
        m = re.search(r"(%[\w.\-]+)\s*=\s*s\d+\[\]\s*constant\((\d+)\)", l)
        if m:
            consts[m.group(1)] = int(m.group(2))
    for l in cond_lines:
        if "compare(" not in l:
            continue
        m = re.search(r"compare\(([^)]*)\)", l)
        if not m:
            continue
        for ref in re.findall(r"%[\w.\-]+", m.group(1)):
            if ref in consts:
                return consts[ref]
    # fallback: any single constant
    allc = [int(c) for l in cond_lines for c in _CONST.findall(l)]
    return min(allc) if allc else 1


def collective_stats(text: str) -> dict:
    comps = _split_computations(text)
    # multiplier per computation: product of enclosing while trip counts
    mult: dict[str, float] = defaultdict(lambda: 1.0)
    # BFS from every computation: propagate to called computations
    children: dict[str, list[tuple[str, float]]] = defaultdict(list)
    for cname, lines in comps.items():
        for line in lines:
            if " while(" in line or "while(" in line.lstrip("%"):
                refs = dict()
                mcond = re.search(r"condition=(%[\w.\-]+)", line)
                mbody = re.search(r"body=(%[\w.\-]+)", line)
                if mcond and mbody:
                    trips = _trip_count(comps.get(mcond.group(1), []))
                    children[cname].append((mbody.group(1), float(trips)))
                    continue
            for ref in _CALLS.findall(line):
                if ref in comps:
                    children[cname].append((ref, 1.0))
    # roots: computations never referenced
    referenced = {c for lst in children.values() for c, _ in lst}
    roots = [c for c in comps if c not in referenced]
    # propagate along the call DAG in topological order; a computation called
    # from k sites executes the SUM of its callers' (multiplier x trips)
    indeg: Counter = Counter()
    for lst in children.values():
        for child, _ in lst:
            indeg[child] += 1
    from collections import deque

    mult = {c: 0.0 for c in comps}
    for r in roots:
        mult[r] = 1.0
    dq = deque(roots)
    while dq:
        c = dq.popleft()
        for child, f in children.get(c, ()):
            mult[child] += mult[c] * f
            indeg[child] -= 1
            if indeg[child] == 0:
                dq.append(child)

    totals: Counter = Counter()
    counts: Counter = Counter()
    for cname, lines in comps.items():
        m = mult.get(cname, 1.0)
        for line in lines:
            for op in COLL_OPS:
                if f" {op}(" in line or f" {op}-start(" in line:
                    nbytes = _result_bytes(line)
                    gsz = _group_size(line)
                    factor = {"all-reduce": 2.0 * (gsz - 1) / max(gsz, 1),
                              "all-gather": (gsz - 1) / max(gsz, 1),
                              "reduce-scatter": float(max(1, gsz - 1)),
                              "all-to-all": (gsz - 1) / max(gsz, 1),
                              "collective-permute": 1.0}[op]
                    totals[op] += int(nbytes * factor * m)
                    counts[op] += 1
                    break
    return {"bytes_by_op": dict(totals), "counts": dict(counts),
            "total_bytes": int(sum(totals.values()))}


# ----------------------------------------------------------- torch collectives
# The counterpart of the HLO text for a torch step: the collectives it
# issued, recorded as they dispatch.  Each entry carries the op's HLO name,
# its result bytes (what ``_result_bytes`` reads off an HLO line), the size
# and name of its process group and the label in effect.
_FUNCOL = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
           "all_reduce_coalesced": "all-reduce",
           "all_gather_into_tensor": "all-gather",
           "all_gather_into_tensor_out": "all-gather",
           "all_gather_into_tensor_coalesced": "all-gather",
           "reduce_scatter_tensor": "reduce-scatter",
           "reduce_scatter_tensor_coalesced": "reduce-scatter",
           "all_to_all_single": "all-to-all", "broadcast": "broadcast",
           "broadcast_": "broadcast"}
_FACTOR = {"all-reduce": lambda n: 2.0 * (n - 1) / max(n, 1),
           "all-gather": lambda n: (n - 1) / max(n, 1),
           "reduce-scatter": lambda n: float(max(1, n - 1)),
           "all-to-all": lambda n: (n - 1) / max(n, 1),
           "collective-permute": lambda n: 1.0,
           # a ring broadcast passes the result through every member once
           "broadcast": lambda n: (n - 1) / max(n, 1)}


_LABEL = threading.local()


@contextlib.contextmanager
def comm_label(name: str):
    """Tags the collectives this thread issues inside (e.g. "grad_sync")
    for any ``CommRecord`` that records them."""
    prev = getattr(_LABEL, "name", "")
    _LABEL.name = name
    try:
        yield
    finally:
        _LABEL.name = prev


class CommRecord(TorchDispatchMode):
    """``with CommRecord() as rec:`` records every functional collective
    issued inside (those of DTensor redistributions and of the port's own
    gradient syncs) in ``rec.entries``, each with the ``comm_label`` in
    effect.  Like ``CommDebugMode``, it lets a DTensor op run first
    (returns NotImplemented) so it sees the collectives the op turns
    into."""

    def __init__(self):
        super().__init__()
        self.entries: list[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **(kwargs or {}))
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        ns = func.namespace
        op = _FUNCOL.get(func._overloadpacket.__name__)
        if ns == "_c10d_functional" and op is not None:
            self._record(op, func, args, out)
        return out

    def _record(self, op: str, func, args, out) -> None:
        group = next(a for a in reversed(args) if isinstance(a, str))
        outs = out if isinstance(out, (list, tuple)) else [out]
        nbytes = sum(t.numel() * t.element_size() for t in outs
                     if isinstance(t, torch.Tensor))
        self.entries.append({
            "op": op, "bytes": int(nbytes), "group": group,
            "group_size": _resolve_process_group(group).size(),
            "label": getattr(_LABEL, "name", "")})


def collective_stats_from_comm(record, label: str | None = None,
                               group: str | None = None) -> dict:
    """``collective_stats``'s schema ({bytes_by_op, counts, total_bytes},
    per-device bytes = result bytes x ring-traffic factor) over the entries
    of a ``CommRecord`` (or its list), those with ``label`` and ``group``
    where given."""
    entries = getattr(record, "entries", record)
    totals: Counter = Counter()
    counts: Counter = Counter()
    for e in entries:
        if (label is not None and e["label"] != label) or (
                group is not None and e["group"] != group):
            continue
        totals[e["op"]] += int(e["bytes"] * _FACTOR[e["op"]](e["group_size"]))
        counts[e["op"]] += 1
    return {"bytes_by_op": dict(totals), "counts": dict(counts),
            "total_bytes": int(sum(totals.values()))}
