# Ported from src/repro/models/api.py (jax -> torch).
"""Family dispatcher: one API over all the architectures.

* ``init_params(cfg, generator, device)``  real tensors on the device
* ``abstract_params(cfg)``                 the same on the ``meta`` device
                                           (shapes and dtypes, no memory)
* ``loss_fn(cfg, params, batch)``          scalar LM loss
* ``init_cache / decode_step``             serving (one token, KV/SSM state)
* ``input_specs(cfg, shape)``              ``meta`` stand-ins for every model
                                           input of an (arch x shape) cell

The dense, MoE and VLM families run ``nn.model``, the ``ssm`` family
(xLSTM) ``nn.xlstm``, the ``hybrid`` family (Zamba2) ``nn.zamba`` and the
``audio`` family (Seamless) ``nn.encdec``.  Every entry point that makes
tensors runs on CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.core.executor import resolve_device
from repro_torch.nn import encdec, model, xlstm, zamba

ENC_FRACTION = {  # seamless: encoder/decoder split of seq_len per shape kind
    "train": 0.5, "prefill": 0.875, "decode": None,
}
SEAMLESS_DECODE_ENC_LEN = 4096
META = torch.device("meta")


def _mod(cfg: ArchConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        return model
    if cfg.family == "ssm":
        return xlstm
    if cfg.family == "hybrid":
        return zamba
    if cfg.family == "audio":
        return encdec
    raise ValueError(f"unknown family {cfg.family}")


def init_params(cfg: ArchConfig, generator: torch.Generator | None = None,
                device=None):
    """Random weights on ``device`` (default CUDA); ``generator`` defaults
    to one on that device seeded with 0."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return _mod(cfg).init_params(cfg, generator, dev)


def abstract_params(cfg: ArchConfig):
    """The parameter dictionary as ``meta`` tensors (no allocation)."""
    return _mod(cfg).init_params(cfg, None, META)


def loss_fn(cfg: ArchConfig, params, batch):
    return _mod(cfg).loss_fn(cfg, params, batch)


def _cache(cfg: ArchConfig, batch: int, max_len: int, dev):
    if cfg.family == "audio":
        return encdec.init_cache(cfg, batch, max_len, SEAMLESS_DECODE_ENC_LEN,
                                 dev)
    return _mod(cfg).init_cache(cfg, batch, max_len, dev)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    """Zeroed decode state; Seamless's cross K/V span
    ``SEAMLESS_DECODE_ENC_LEN`` encoder frames."""
    return _cache(cfg, batch, max_len, resolve_device(device))


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int):
    return _cache(cfg, batch, max_len, META)


def decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    return _mod(cfg).decode_step(cfg, params, cache, tokens, pos)


# ------------------------------------------------------------- input specs
def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeCfg) -> dict:
    """``meta`` stand-ins for one (arch x shape) cell.

    train/prefill: the token/frame batch (modality stubs included);
    decode: one token per sequence + the absolute position scalar (the KV
    cache is part of the serve state, see abstract_cache)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            se = int(S * ENC_FRACTION[shape.kind])
            sd = S - se
            return {"frames": _spec((B, se, cfg.d_model), torch.bfloat16),
                    "tokens": _spec((B, sd), i32),
                    "labels": _spec((B, sd), i32)}
        if cfg.family == "vlm":
            npat = min(cfg.n_patches, S // 2)
            st = S - npat
            return {"patch_embeds": _spec((B, npat, cfg.d_model),
                                          torch.bfloat16),
                    "tokens": _spec((B, st), i32),
                    "labels": _spec((B, st), i32)}
        return {"tokens": _spec((B, S), i32), "labels": _spec((B, S), i32)}
    # decode: one new token against a seq_len-deep cache
    return {"tokens": _spec((B,), i32), "pos": _spec((), i32)}
