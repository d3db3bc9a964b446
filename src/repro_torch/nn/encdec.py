# Ported from src/repro/nn/encdec.py (jax.numpy -> torch).
"""Encoder-decoder transformer (seamless-m4t backbone).

Encoder input is the modality stub: precomputed speech-frame embeddings
(B, S_enc, D) from ``input_specs`` (as in the reference, the conformer
frontend is not modeled).  The decoder is a standard causal stack with
cross-attention.  Attention keeps ``sdpa``'s default ``impl="xla"``, as the
reference does, so this family runs no hand-written kernel.  Layer
parameters are stacked on a leading L axis; the reference's ``lax.scan``
over layers is a Python loop over that axis, under ``layers.remat`` when
``cfg.remat`` (the reference's ``jax.remat``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import attention as attn
from repro_torch.nn import layers as nnl
from repro_torch.nn.model import lm_loss


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init_params(cfg: ArchConfig, generator: torch.Generator | None,
                device: torch.device):
    """Normal(0, 0.02) weights drawn on ``device`` from ``generator``, with
    the reference's keys and shapes; norm gains are fp32 ones."""
    dt = _dtype(cfg)
    d, hd = cfg.d_model, cfg.head_dim
    h, kv, f, V = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab

    def norm(*shape):
        return torch.randn(shape, generator=generator, dtype=dt,
                           device=device).mul_(0.02)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    def stack(L, extra_cross: bool):
        p = {
            "ln1": ones(L, d),
            "wq": norm(L, d, h * hd),
            "wk": norm(L, d, kv * hd),
            "wv": norm(L, d, kv * hd),
            "wo": norm(L, h * hd, d),
            "ln2": ones(L, d),
            "w1": norm(L, d, f),
            "w2": norm(L, f, d),
        }
        if extra_cross:
            p.update({
                "lnx": ones(L, d),
                "xwq": norm(L, d, h * hd),
                "xwk": norm(L, d, kv * hd),
                "xwv": norm(L, d, kv * hd),
                "xwo": norm(L, h * hd, d),
            })
        return p

    return {"embed": norm(V, d), "enc": stack(cfg.enc_layers, False),
            "dec": stack(cfg.n_layers, True), "ln_enc": ones(d),
            "ln_f": ones(d)}


def _layer(stack: dict, i: int) -> dict:
    return {k: v[i] for k, v in stack.items()}


def _positions(x):
    """Positions 0..S-1 of each row of ``x`` (B,S,D), replicated on its
    mesh where ``x`` is a DTensor."""
    b, s = x.shape[:2]
    return nnl.replicate_like(torch.arange(s, dtype=torch.int32,
                                           device=x.device)[None].expand(b, s),
                              x)


def _self_block(cfg, x, lp, pos, causal):
    h = nnl.rms_norm(x, lp["ln1"])
    q, k, v = attn.qkv(h, lp, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    q = nnl.apply_rope(q, pos, cfg.rope_theta)
    k = nnl.apply_rope(k, pos, cfg.rope_theta)
    o = attn.sdpa(q, k, v, causal=causal)
    return x + nnl.residual(attn.attn_out(o, lp))


def _cross(cfg, x, lp, enc_kv, decode: bool = False):
    """Cross-attention to the encoder's K/V.  A decode step attends through
    ``decode_attend`` over every frame (the same arithmetic as a
    non-causal ``sdpa`` of one query), which also takes a cross cache whose
    frames are sharded (``shard.cache_specs``, heads that do not
    divide)."""
    h = nnl.rms_norm(x, lp["lnx"])
    q = attn._split_heads(h @ lp["xwq"], cfg.n_heads, cfg.head_dim)
    k, v = enc_kv
    if decode:
        q = nnl.constrain(q, "dp", None, "tp", None)
        o = attn.decode_attend(q, {"k": k, "v": v}, k.shape[1] - 1)
    else:
        o = attn.sdpa(q, k, v, causal=False)
    b, s2, hh, dd = o.shape
    return x + nnl.residual(o.reshape(b, s2, hh * dd) @ lp["xwo"])


def _cross_kv(cfg, enc_out, lp):
    """The cross-attention keys and values of one decoder layer."""
    k = attn._split_heads(enc_out @ lp["xwk"], cfg.n_kv_heads, cfg.head_dim)
    v = attn._split_heads(enc_out @ lp["xwv"], cfg.n_kv_heads, cfg.head_dim)
    return k, v


def _mlp(cfg, x, lp):
    h = nnl.rms_norm(x, lp["ln2"])
    return x + nnl.mlp(h, lp, cfg.act)


def encode(cfg: ArchConfig, params, frames):
    """frames (B, S_enc, D) -> encoder output (B, S_enc, D).  Plain frames
    meet DTensor params replicated on their mesh."""
    x = nnl.replicate_like(frames, params["ln_enc"]).to(_dtype(cfg))
    pos = _positions(x)

    def body(x, lp):
        x = _self_block(cfg, x, lp, pos, causal=False)
        return _mlp(cfg, x, lp)

    bfn = nnl.remat(body) if cfg.remat else body
    for i in range(cfg.enc_layers):
        x = bfn(x, _layer(params["enc"], i))
    return nnl.rms_norm(x, params["ln_enc"])


def _unembed(params, x):
    """Tied unembedding; a vocab-sharded table gives vocab-sharded
    logits."""
    return nnl.constrain(x @ params["embed"].T.to(x.dtype), "dp", None, "tp")


def decode_train(cfg: ArchConfig, params, enc_out, tokens):
    """Teacher-forced decoder over ``tokens`` (B, S_dec) cross-attending to
    ``enc_out``.  Returns logits (B, S_dec, V)."""
    x = nnl.embed(tokens, params["embed"]).to(_dtype(cfg))
    pos = _positions(x)

    def body(x, lp):
        x = _self_block(cfg, x, lp, pos, causal=True)
        x = _cross(cfg, x, lp, _cross_kv(cfg, enc_out, lp))
        return _mlp(cfg, x, lp)

    bfn = nnl.remat(body) if cfg.remat else body
    for i in range(cfg.n_layers):
        x = bfn(x, _layer(params["dec"], i))
    x = nnl.rms_norm(x, params["ln_f"])
    return _unembed(params, x)


def loss_fn(cfg: ArchConfig, params, batch):
    enc_out = encode(cfg, params, batch["frames"])
    logits = decode_train(cfg, params, enc_out, batch["tokens"])
    return lm_loss(logits, batch["labels"])


# --------------------------------------------------------------------- decode
def init_cache(cfg: ArchConfig, batch: int, max_len: int, enc_len: int,
               device=None, enc_out=None, params=None):
    """Self-attention KV caches of ``max_len`` steps and cross-attention
    K/V over ``enc_len`` encoder frames.  As in the reference the cross K/V
    start as zeros; given ``enc_out`` (B, enc_len, D) and ``params`` they
    are filled with each decoder layer's projections of it, which
    ``decode_step`` then cross-attends to."""
    dt = _dtype(cfg)
    Ld = cfg.n_layers

    def zeros(s):
        return torch.zeros((Ld, batch, s, cfg.n_kv_heads, cfg.head_dim),
                           dtype=dt, device=device)

    cache = {"k": zeros(max_len), "v": zeros(max_len), "xk": zeros(enc_len),
             "xv": zeros(enc_len)}
    if enc_out is not None:
        for i in range(Ld):
            cache["xk"][i], cache["xv"][i] = _cross_kv(
                cfg, enc_out, _layer(params["dec"], i))
    return cache


def decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    """One token: tokens (B,), pos the absolute position (an int).

    Returns (logits (B,V), cache).  Unlike the reference, the self-attention
    caches are updated in place (``attention.cache_update``) and the cache
    itself is returned; the cross K/V are read, never written."""
    pos = int(pos)
    x = nnl.embed(tokens, params["embed"])[:, None, :].to(_dtype(cfg))
    p = _positions(x) + pos
    for i in range(cfg.n_layers):
        lp = _layer(params["dec"], i)
        h = nnl.rms_norm(x, lp["ln1"])
        q, k, v = attn.qkv(h, lp, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        # q, k and v laid out as the KV cache (``shard.cache_specs``)
        q, k, v = (nnl.constrain(t, "dp", None, "tp", None) for t in (
            nnl.apply_rope(q, p, cfg.rope_theta),
            nnl.apply_rope(k, p, cfg.rope_theta), v))
        lc = attn.cache_update({"k": cache["k"][i], "v": cache["v"][i]},
                               k, v, pos)
        o = attn.decode_attend(q, lc, pos)
        x = x + nnl.residual(attn.attn_out(o, lp))
        x = _cross(cfg, x, lp, (cache["xk"][i], cache["xv"][i]),
                   decode=True)
        x = _mlp(cfg, x, lp)
    x = nnl.rms_norm(x, params["ln_f"])
    return _unembed(params, x)[:, 0], cache
