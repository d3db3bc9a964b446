# Copied from src/repro/core/quantize.py; imports point at repro_torch.
"""Int8 fixed-point quantization (paper §2.3.4 / §6.1).

"Our data quantization method is similar with Angel-Eye: the radix position
of the fixed-point data in each layer is chosen differently and we adopt the
quantization method with the best accuracy by enumerating possible solutions."

* Weights: per-layer fraction from the weight range, refined by enumerating
  neighbouring radix positions and keeping the lowest quantization MSE.
* Activations: per-node fraction from a float calibration run.
* Biases: int32 at fraction f_in + f_w (so they add directly into the
  accumulator).
* Intrinsic folds: conv+BN+Scale parameter pre-computation happens here, at
  weight-preparation time — the graph pass (frontend.fold_intrinsics) only
  records what to fold.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.xgraph import XGraph

F_MIN, F_MAX = -12, 24


def best_fraction(data: np.ndarray, bits: int = 8, search: int = 1) -> int:
    """Radix position minimizing quantization MSE (enumerated, paper-style)."""
    amax = float(np.max(np.abs(data))) or 1e-9
    qmax = 2 ** (bits - 1) - 1
    f0 = int(np.floor(np.log2(qmax / amax)))
    best_f, best_err = f0, None
    for f in range(f0 - search, f0 + search + 1):
        q = np.clip(np.round(data * 2.0 ** f), -(qmax + 1), qmax)
        err = float(np.mean((q * 2.0 ** -f - data) ** 2))
        if best_err is None or err < best_err:
            best_f, best_err = f, err
    return int(np.clip(best_f, F_MIN, F_MAX))


def quantize_to(data: np.ndarray, f: int, bits: int = 8) -> np.ndarray:
    qmax = 2 ** (bits - 1) - 1
    q = np.clip(np.round(data * 2.0 ** f), -(qmax + 1), qmax)
    return q.astype(np.int8 if bits == 8 else np.int32)


def fold_conv_intrinsics(w: np.ndarray, b: np.ndarray, folded: list) -> tuple:
    """Pre-compute conv+BN+Scale/bias chains into (w', b') (paper §4.1.1).

    ``folded`` is the conv node's ``folded_intrinsics`` attr: a list of
    (op, params) applied in graph order after the conv.
    """
    w, b = w.copy(), b.copy()
    for op, p in folded:
        if op == "bn":
            g_ = p.get("gamma", 1.0)
            beta = p.get("beta", 0.0)
            mu, var, eps = p["mean"], p["var"], p.get("eps", 1e-5)
            scale = g_ / np.sqrt(var + eps)
            w = w * scale  # broadcast over OC (last axis of HWIO)
            b = (b - mu) * scale + beta
        elif op == "scale":
            w = w * p["alpha"]
            b = b * p["alpha"] + p.get("beta", 0.0)
        elif op == "bias_add":
            b = b + p.get("bias", 0.0)
        else:
            raise ValueError(f"unknown intrinsic {op}")
    return w, b


@dataclasses.dataclass
class QuantizedModel:
    weights: dict      # node -> int8 ndarray (HWIO / (IN,OC) for fc)
    biases: dict       # node -> int32 ndarray at fraction f_in + f_w
    f_w: dict          # node -> weight fraction
    f_a: dict          # node -> activation fraction (every node, incl. input)

    def shift_for(self, g: XGraph, name: str) -> int:
        """Requantization shift of a conv/fc node: f_in + f_w - f_out."""
        f_in = self.f_a[g.nodes[name].inputs[0]]
        return f_in + self.f_w[name] - self.f_a[name]


def calibrate(g: XGraph, float_params: dict, calib_input: np.ndarray,
              run_float) -> QuantizedModel:
    """Quantize a float model given one calibration batch.

    ``run_float(g, float_params, x) -> {node: activation}`` is provided by the
    executor (avoids a circular import).
    """
    acts = run_float(g, float_params, calib_input)
    f_a = {name: best_fraction(np.asarray(a)) for name, a in acts.items()}
    # concat/eltwise require a shared output fraction <= each input's
    for node in g:
        if node.op in ("concat", "eltwise_add"):
            f_a[node.name] = min([f_a[node.name]] + [f_a[i] for i in node.inputs])

    weights, biases, f_w = {}, {}, {}
    for node in g:
        if node.name not in float_params:
            continue
        p = float_params[node.name]
        w, b = p["w"], p.get("b", np.zeros(p["w"].shape[-1], np.float32))
        if node.attrs.get("folded_intrinsics"):
            w, b = fold_conv_intrinsics(w, b, node.attrs["folded_intrinsics"])
        fw = best_fraction(w)
        f_in = f_a[node.inputs[0]]
        weights[node.name] = quantize_to(w, fw)
        biases[node.name] = quantize_to(b, f_in + fw, bits=32)
        f_w[node.name] = fw
    return QuantizedModel(weights, biases, f_w, f_a)
