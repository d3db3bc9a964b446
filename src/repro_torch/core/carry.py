"""Weights carried across from the reference package.

The port never imports ``repro``; these functions read the reference's
objects by attribute or as numpy arrays, so a test can hand the same
quantized model, float parameters or LM weights to both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.executor import resolve_device
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


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor.  A
    bfloat16 array (``ml_dtypes.bfloat16``, which ``torch.from_numpy``
    refuses) travels as its 16-bit pattern."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def lm_params_from_reference(params: dict, device=None) -> dict:
    """The reference LM's parameter pytree (nested dicts of arrays) as the
    port's nested dicts of tensors, dtypes kept, on ``device`` (None means
    CUDA, and raises where CUDA is absent; tests pass "cpu")."""
    dev = resolve_device(device)
    return {k: lm_params_from_reference(v, dev) if isinstance(v, dict)
            else _tensor(v, dev) for k, v in params.items()}


def lm_cache_from_reference(cache: dict, device=None) -> dict:
    """The reference LM's decode cache, a flat dict of arrays (``{"k",
    "v"}``; xLSTM's ``{"m_state", "s_h", "s_c"}``; Zamba2's ``{"ssm", "k",
    "v"}``), as tensors on ``device`` (None means CUDA, as above)."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in cache.items()}


def train_state_from_reference(state: dict, device=None) -> dict:
    """The reference's train state ``{"params", "opt": {"m", "v",
    "step"}}`` (arrays, bf16 moments and the int32 ``step`` included) as
    the port's nested dicts of tensors on ``device`` (None means CUDA, as
    above)."""
    return lm_params_from_reference(state, device)
