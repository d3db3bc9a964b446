"""Weights carried across from the reference package.

The port never imports ``repro``; these functions read the reference's
objects by attribute, so a test can hand the same quantized model or float
parameters to both packages.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.quantize import QuantizedModel


def qm_from_reference(qm) -> QuantizedModel:
    """The reference's ``QuantizedModel`` (numpy ``weights``/``biases``,
    int ``f_w``/``f_a``) as the port's."""
    return QuantizedModel(
        weights={k: np.asarray(v, np.int8).copy() for k, v in qm.weights.items()},
        biases={k: np.asarray(v, np.int32).copy() for k, v in qm.biases.items()},
        f_w={k: int(v) for k, v in qm.f_w.items()},
        f_a={k: int(v) for k, v in qm.f_a.items()})


def params_from_reference(params: dict) -> dict:
    """Float parameters ({node: {"w", "b"}}) as float32 numpy copies."""
    return {node: {k: np.asarray(v, np.float32).copy() for k, v in p.items()}
            for node, p in params.items()}
