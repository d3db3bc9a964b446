# Ported from src/repro/models/api.py (jax -> torch).
"""Family dispatcher: one API over the ported architectures.

* ``init_params(cfg, generator, device)``  real tensors on the device
* ``init_cache / decode_step``             serving (one token, KV/SSM state)

The dense, MoE and VLM families run ``nn.model``, the ``ssm`` family
(xLSTM) ``nn.xlstm`` and the ``hybrid`` family (Zamba2) ``nn.zamba``.  The
``audio`` family (Seamless) and the dry-run's ``abstract_params``/
``input_specs`` are not ported yet (ROADMAP, Queue 1 items 7 and 8).  Every
entry point runs on CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.executor import resolve_device
from repro_torch.nn import model, xlstm, zamba

NOT_PORTED = {"audio": "Seamless"}


def _mod(cfg: ArchConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        return model
    if cfg.family == "ssm":
        return xlstm
    if cfg.family == "hybrid":
        return zamba
    if cfg.family in NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family ({NOT_PORTED[cfg.family]}) "
            f"is not ported yet (ROADMAP, Queue 1 item 7)")
    raise ValueError(f"unknown family {cfg.family}")


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None,
                device=None):
    """Random weights on ``device`` (default CUDA); ``generator`` defaults
    to one on that device seeded with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return _mod(cfg).init_params(cfg, generator, dev)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    return _mod(cfg).init_cache(cfg, batch, max_len, resolve_device(device))


def decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    return _mod(cfg).decode_step(cfg, params, cache, tokens, pos)
