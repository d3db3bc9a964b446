# Copied from src/repro/core/templates.py; imports point at repro_torch.
"""Fusion templates (paper §4.1, Fig. 3 right column).

A template is a tiny typed pattern graph.  Kernel-fusion templates describe
*choices* that the path search weighs by cost; the ``injective`` vocabulary is
the paper's: convolution, pooling, nonlinear, deconvolution, depth-wise
convolution, upsample, reorganization.

Templates here are pairwise; longer fused chains are built by the path search
chaining compatible pairs (the paper: "more than two operations can be fused;
the number of operations to be fused is not the limitation"), subject to the
capacity condition checked by the tiling solver (fusion condition 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core.xgraph import XGraph, CONV_LIKE, POOL_LIKE

CONVS = frozenset(CONV_LIKE - {"fc"})
POOLS = frozenset(POOL_LIKE)
ELTWISE = frozenset({"eltwise_add"})
MISC = frozenset({"upsample", "reorg"})
INJECTIVE = CONVS | POOLS | ELTWISE | MISC


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: used as dict key
class Template:
    name: str
    vertices: dict  # var -> frozenset of allowed op types
    edges: tuple    # ((producer_var, consumer_var), ...)
    # Extra semantic check on a complete embedding {var: node_name}.
    predicate: Optional[Callable[[XGraph, dict], bool]] = None

    def var_types(self, var: str) -> frozenset:
        return self.vertices[var]


def _no_stride_gap(g: XGraph, m: dict) -> bool:
    # A fused consumer must be able to stream the producer's output tile;
    # any injective pair qualifies on our engines (LOAD/CONV/POOL/MISC all
    # read NHWC row-major tiles), so no extra constraint today.
    return True


def _eltwise_two_inputs(g: XGraph, m: dict) -> bool:
    return len(g.nodes[m["b"]].inputs) == 2


def _distinct_siblings(g: XGraph, m: dict) -> bool:
    return m["a"] != m["b"]


# --- kernel fusion templates -------------------------------------------------
CONV_POOL = Template(
    "conv_pool",
    vertices={"a": CONVS, "b": POOLS},
    edges=(("a", "b"),),
    predicate=_no_stride_gap,
)

CONV_ELTWISE = Template(
    "conv_eltwise",
    vertices={"a": CONVS, "b": ELTWISE},
    edges=(("a", "b"),),
    predicate=_eltwise_two_inputs,
)

CONV_CONV = Template(  # longitudinal conv+conv (paper §4: "Conv + Conv")
    "conv_conv",
    vertices={"a": CONVS, "b": CONVS},
    edges=(("a", "b"),),
)

POOL_CONV = Template(
    "pool_conv",
    vertices={"a": POOLS, "b": CONVS},
    edges=(("a", "b"),),
)

ELTWISE_CONV = Template(
    "eltwise_conv",
    vertices={"a": ELTWISE, "b": CONVS},
    edges=(("a", "b"),),
)

MISC_ADJ = Template(  # upsample/reorg chained with conv (YOLO-style necks)
    "misc_adjacent",
    vertices={"a": MISC | CONVS, "b": MISC | CONVS},
    edges=(("a", "b"),),
)

HORIZONTAL = Template(  # siblings sharing one input (Inception, paper §5.2)
    "horizontal_share",
    vertices={"x": INJECTIVE | frozenset({"input"}), "a": CONVS, "b": CONVS},
    edges=(("x", "a"), ("x", "b")),
    predicate=_distinct_siblings,
)

KERNEL_TEMPLATES: tuple[Template, ...] = (
    CONV_POOL, CONV_ELTWISE, CONV_CONV, POOL_CONV, ELTWISE_CONV, MISC_ADJ,
)

ALL_TEMPLATES: tuple[Template, ...] = KERNEL_TEMPLATES + (HORIZONTAL,)


def pairwise_fusable(template_matches: dict) -> set:
    """Collapse pairwise template embeddings into a set of fusable (u, v)
    producer->consumer node pairs, consumed by the path search."""
    pairs: set[tuple[str, str]] = set()
    for tmpl, matches in template_matches.items():
        if tmpl.name == "horizontal_share":
            continue
        for m in matches:
            pairs.add((m["a"], m["b"]))
    return pairs
