# Copied from src/repro/core/xgraph.py; imports point at repro_torch.
"""XGraph — DNNVM's coarse-grained, framework-independent computing-graph IR.

An ``XGraph`` is a DAG <U, E, T> (paper §4.2): vertices are coarse NN
operations, edges are dataflow dependencies, and every vertex carries a
labelling (op type + attributes) used by the fusion templates.

Data layout convention (paper §3.1 / Fig. 2c): feature maps are NHWC with
batch N=1 by default; weights are matmul panels (kh*kw*IC, OC).  Dimension
transformation ops (flatten / concat) exist as nodes after the front-end only
if they could not be folded; the layout pass marks them ``folded=True`` so the
back-end emits strided SAVEs instead of data movement (DESIGN.md §2.2).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Iterator

# Op taxonomy.  COMPUTE ops map to CONV/POOL/MISC engines; the rest are either
# folded by the front-end or scheduled to the host by the partition pass.
CONV_LIKE = {"conv", "deconv", "depthwise_conv", "dilated_conv", "fc"}
POOL_LIKE = {"maxpool", "avgpool", "global_avgpool"}
MISC_OPS = {"eltwise_add", "upsample", "reorg", "concat", "flatten"}
POINTWISE = {"relu", "relu6", "leaky_relu", "sigmoid", "tanh"}
INTRINSIC = {"bn", "scale", "bias_add", "pad"}  # folded by intrinsic fusion
HOST_OPS = {"softmax", "detection", "nms"}
# ``injective`` per paper §4.1: ops the kernel-fusion templates may include.
INJECTIVE = CONV_LIKE | POOL_LIKE | {"eltwise_add", "upsample", "reorg"}


@dataclasses.dataclass
class XNode:
    name: str
    op: str
    inputs: tuple[str, ...]
    attrs: dict = dataclasses.field(default_factory=dict)

    def __repr__(self) -> str:  # compact for debug dumps
        return f"XNode({self.name}:{self.op}<-{list(self.inputs)})"


class XGraph:
    """Insertion-ordered DAG of XNodes with NHWC shape inference."""

    def __init__(self, name: str = "xgraph"):
        self.name = name
        self.nodes: dict[str, XNode] = {}
        self._consumers: dict[str, list[str]] = {}
        self._shapes: dict[str, tuple[int, int, int, int]] = {}

    # ------------------------------------------------------------- building
    def add(self, op: str, name: str, inputs: Iterable[str] = (), **attrs) -> str:
        if name in self.nodes:
            raise ValueError(f"duplicate node {name!r}")
        inputs = tuple(inputs)
        for i in inputs:
            if i not in self.nodes:
                raise ValueError(f"{name!r} references unknown input {i!r}")
        node = XNode(name, op, inputs, attrs)
        self.nodes[name] = node
        self._consumers[name] = []
        for i in inputs:
            self._consumers[i].append(name)
        self._shapes[name] = self._infer_shape(node)
        return name

    def input(self, name: str, shape: tuple[int, int, int, int]) -> str:
        return self.add("input", name, (), shape=tuple(shape))

    # ---------------------------------------------------------- structure
    def consumers(self, name: str) -> list[str]:
        return list(self._consumers[name])

    def producers(self, name: str) -> list[str]:
        return list(self.nodes[name].inputs)

    def topo_order(self) -> list[str]:
        return list(self.nodes)  # insertion order is topological by add()

    def __iter__(self) -> Iterator[XNode]:
        return iter(self.nodes.values())

    def __len__(self) -> int:
        return len(self.nodes)

    def shape(self, name: str) -> tuple[int, int, int, int]:
        return self._shapes[name]

    def compute_nodes(self) -> list[str]:
        return [n.name for n in self if n.op != "input"]

    def remove(self, name: str) -> None:
        """Remove a node, reconnecting its consumers to its single input."""
        node = self.nodes[name]
        if len(node.inputs) != 1:
            raise ValueError(f"can only remove single-input nodes, {name} has {node.inputs}")
        (src,) = node.inputs
        for c in self._consumers[name]:
            cn = self.nodes[c]
            cn.inputs = tuple(src if i == name else i for i in cn.inputs)
            self._consumers[src].append(c)
        self._consumers[src].remove(name)
        del self.nodes[name], self._consumers[name], self._shapes[name]

    def replace_op(self, name: str, op: str, **attr_updates) -> None:
        self.nodes[name].op = op
        self.nodes[name].attrs.update(attr_updates)
        self._shapes[name] = self._infer_shape(self.nodes[name])

    # ------------------------------------------------------ shape inference
    def _infer_shape(self, node: XNode) -> tuple[int, int, int, int]:
        a = node.attrs
        op = node.op
        if op == "input":
            return tuple(a["shape"])
        ish = [self._shapes[i] for i in node.inputs]
        n, h, w, c = ish[0]
        if op in ("conv", "dilated_conv", "depthwise_conv"):
            kh, kw = a["kernel"]
            sh, sw = a.get("stride", (1, 1))
            dh, dw = a.get("dilation", (1, 1))
            ekh, ekw = dh * (kh - 1) + 1, dw * (kw - 1) + 1
            ph, pw = _padding(a.get("pad", "same"), ekh, ekw)
            oh = (h + 2 * ph - ekh) // sh + 1
            ow = (w + 2 * pw - ekw) // sw + 1
            oc = c if op == "depthwise_conv" else a["oc"]
            return (n, oh, ow, oc)
        if op == "deconv":
            kh, kw = a["kernel"]
            sh, sw = a.get("stride", (2, 2))
            return (n, h * sh, w * sw, a["oc"])
        if op in ("maxpool", "avgpool"):
            kh, kw = a["kernel"]
            sh, sw = a.get("stride", a["kernel"])
            ph, pw = _padding(a.get("pad", "valid"), kh, kw)
            ceil = a.get("ceil_mode", True)  # Caffe convention
            rnd: Callable[[float], int] = math.ceil if ceil else math.floor
            oh = int(rnd((h + 2 * ph - kh) / sh)) + 1
            ow = int(rnd((w + 2 * pw - kw) / sw)) + 1
            return (n, oh, ow, c)
        if op == "global_avgpool":
            return (n, 1, 1, c)
        if op == "fc":
            return (n, 1, 1, a["oc"])
        if op == "eltwise_add":
            for s in ish[1:]:
                if s != ish[0]:
                    raise ValueError(f"eltwise_add shape mismatch {ish}")
            return ish[0]
        if op == "concat":
            axis_c = sum(s[3] for s in ish)
            for s in ish[1:]:
                if s[:3] != ish[0][:3]:
                    raise ValueError(f"concat spatial mismatch {ish}")
            return (n, h, w, axis_c)
        if op == "flatten":
            return (n, 1, 1, h * w * c)
        if op == "upsample":
            f = a.get("factor", 2)
            return (n, h * f, w * f, c)
        if op == "reorg":
            s = a.get("stride", 2)
            return (n, h // s, w // s, c * s * s)
        if op in POINTWISE or op in INTRINSIC or op in HOST_OPS:
            return ish[0]
        raise ValueError(f"shape inference: unknown op {op!r}")

    # --------------------------------------------------------- cost helpers
    def macs(self, name: str) -> int:
        """Multiply-accumulates of one op (paper Eq. 3 divided by 2)."""
        node = self.nodes[name]
        a, op = node.attrs, node.op
        n, oh, ow, oc = self.shape(name)
        if op in ("conv", "dilated_conv"):
            ic = self.shape(node.inputs[0])[3]
            kh, kw = a["kernel"]
            return n * oh * ow * oc * ic * kh * kw
        if op == "depthwise_conv":
            kh, kw = a["kernel"]
            return n * oh * ow * oc * kh * kw
        if op == "deconv":
            ic = self.shape(node.inputs[0])[3]
            kh, kw = a["kernel"]
            return n * oh * ow * oc * ic * kh * kw // (a.get("stride", (2, 2))[0] ** 2)
        if op == "fc":
            ish = self.shape(node.inputs[0])
            return n * oc * ish[1] * ish[2] * ish[3]
        if op in ("maxpool", "avgpool", "global_avgpool"):
            return 0  # POOL engine, counted as misc elems not MACs
        return 0

    def ops(self, name: str) -> int:
        return 2 * self.macs(name)

    def total_ops(self) -> int:
        return sum(self.ops(n) for n in self.nodes)

    def misc_elems(self, name: str) -> int:
        """Element throughput demand for POOL/MISC engines."""
        node = self.nodes[name]
        n, oh, ow, oc = self.shape(name)
        if node.op in ("maxpool", "avgpool"):
            kh, kw = node.attrs["kernel"]
            return n * oh * ow * oc * kh * kw
        if node.op == "global_avgpool":
            ish = self.shape(node.inputs[0])
            return n * ish[1] * ish[2] * ish[3]
        if node.op in ("eltwise_add", "upsample", "reorg"):
            return n * oh * ow * oc * len(node.inputs)
        return 0

    def fmap_bytes(self, name: str, elem_bytes: int = 1) -> int:
        n, h, w, c = self.shape(name)
        return n * h * w * c * elem_bytes

    def param_bytes(self, name: str, elem_bytes: int = 1) -> int:
        node = self.nodes[name]
        a, op = node.attrs, node.op
        if op in ("conv", "dilated_conv", "deconv"):
            ic = self.shape(node.inputs[0])[3]
            kh, kw = a["kernel"]
            oc = a["oc"]
            return kh * kw * ic * oc * elem_bytes + oc * 4  # int32 bias
        if op == "depthwise_conv":
            kh, kw = a["kernel"]
            c = self.shape(node.inputs[0])[3]
            return kh * kw * c * elem_bytes + c * 4
        if op == "fc":
            ish = self.shape(node.inputs[0])
            return ish[1] * ish[2] * ish[3] * a["oc"] * elem_bytes + a["oc"] * 4
        return 0

    # ----------------------------------------------------------- utilities
    def is_chain(self, group: list) -> bool:
        """True when ``group`` is a linear producer chain (or a single op)."""
        return all(group[i] in self.nodes[group[i + 1]].inputs
                   for i in range(len(group) - 1)) or len(group) == 1

    def exposed_outputs(self, group: list) -> list:
        """Nodes of an execution group whose feature maps land in DDR: a
        chain exposes only its tail, a horizontal (sibling) group exposes
        every member.  Shared by the assembler and the memory planner — the
        two must agree or addresses go stale."""
        return [group[-1]] if self.is_chain(group) else list(group)

    def validate(self) -> None:
        seen: set[str] = set()
        for node in self:
            for i in node.inputs:
                if i not in seen:
                    raise ValueError(f"{node.name} uses {i} before definition")
            seen.add(node.name)

    def summary(self) -> str:
        lines = [f"XGraph {self.name}: {len(self)} nodes, {self.total_ops()/1e9:.2f} GOPs"]
        for node in self:
            lines.append(
                f"  {node.name:28s} {node.op:16s} {str(self.shape(node.name)):>22s}"
                f" <- {','.join(node.inputs)}")
        return "\n".join(lines)


def _padding(pad, kh: int, kw: int) -> tuple[int, int]:
    if pad == "same":
        return (kh - 1) // 2, (kw - 1) // 2
    if pad == "valid":
        return 0, 0
    if isinstance(pad, (tuple, list)):
        return tuple(pad)  # type: ignore[return-value]
    if isinstance(pad, int):
        return pad, pad
    raise ValueError(f"bad pad {pad!r}")
