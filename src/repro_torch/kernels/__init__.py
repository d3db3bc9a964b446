"""Hand-written CUDA kernels (``csrc/``) with their launchers and plain
PyTorch versions."""
from __future__ import annotations

import torch


def refuse_autograd(name: str, *tensors) -> None:
    """Raise where autograd would need a backward ``name``'s kernel does not
    have: grad mode on and an input that requires grad.  The kernels launch
    through ``ctypes``, so their outputs carry no ``grad_fn``; without this a
    training step would drop every gradient through them silently.  (The
    reference cannot differentiate its Pallas kernels either.)"""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: its kernel is not differentiable; "
            f"call it under torch.no_grad() or on inputs that do not "
            f"require grad")
