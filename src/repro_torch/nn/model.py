# Ported from src/repro/nn/model.py (jax.numpy -> torch).
"""Universal causal transformer LM: dense / MoE / SWA / VLM backbone.

Layer parameters are stacked on a leading L axis, as in the reference's
pytree; the reference's ``lax.scan`` over layers is a Python loop over that
axis, each layer under ``_remat`` (the reference's layer remat policy).
``lm_loss`` is the families' shared cross-entropy.  With DTensor
parameters under a mesh context the dense family runs tensor-parallel: the
reference's ``constrain`` calls pin q, k, v, o, the residual and the
logits, and the token lookup is vocab-parallel
(``layers.vocab_parallel_embedding``) where indexing would gather the
table.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.nn import attention as attn
from repro_torch.nn import layers as nnl


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _remat(cfg: ArchConfig, body):
    """Layer remat policy: "full" recomputes the whole block in backward;
    "dots" saves matmul outputs and recomputes only the cheap elementwise
    chains (the reference's ``dots_saveable``)."""
    if not cfg.remat:
        return body
    return nnl.remat(body, dots=cfg.remat_policy == "dots")


def lm_loss(logits, labels):
    """Mean next-token cross-entropy: fp32 logsumexp minus the label's
    logit, as every reference family computes it (vocab-sharded logits are
    gathered over the model axis first)."""
    logits = nnl.gather_dim(logits, -1).float()
    labels = nnl.replicate_like(labels, logits)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)


def init_params(cfg: ArchConfig, generator: torch.Generator | None,
                device: torch.device):
    """Normal(0, 0.02) weights drawn on ``device`` from ``generator`` (which
    must live on that device), with the reference's keys and shapes; norm
    gains are fp32 ones."""
    dt = _dtype(cfg)
    d, hd = cfg.d_model, cfg.head_dim
    h, kv, f, L, V = (cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.n_layers,
                      cfg.vocab)

    def norm(*shape):
        return torch.randn(shape, generator=generator, dtype=dt,
                           device=device).mul_(0.02)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    layers = {
        "ln1": ones(L, d),
        "ln2": ones(L, d),
        "wq": norm(L, d, h * hd),
        "wk": norm(L, d, kv * hd),
        "wv": norm(L, d, kv * hd),
        "wo": norm(L, h * hd, d),
    }
    if cfg.moe:
        e = cfg.moe.n_experts
        layers["router"] = norm(L, d, e)
        layers["w1"] = norm(L, e, d, f)
        layers["w2"] = norm(L, e, f, d)
        if cfg.act == "silu_gated":
            layers["w3"] = norm(L, e, d, f)
    else:
        layers["w1"] = norm(L, d, f)
        layers["w2"] = norm(L, f, d)
        if cfg.act == "silu_gated":
            layers["w3"] = norm(L, d, f)
    params = {"embed": norm(V, d), "layers": layers, "ln_f": ones(d)}
    if not cfg.tie_embeddings:
        params["unembed"] = norm(V, d)
    return params


# ------------------------------------------------------------------ positions
def positions_for(cfg: ArchConfig, batch: int, seq: int, offset: int = 0,
                  device=None):
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    pos = pos.expand(batch, seq)
    if not cfg.mrope:
        return pos
    # M-RoPE stub grid: the first n_patches positions are image patches on a
    # (g x g) grid at t=0; text follows temporally.
    npat = min(cfg.n_patches, seq)
    g = max(1, int(npat ** 0.5))
    idx = torch.arange(seq, device=device)
    is_img = idx < npat
    t = torch.where(is_img, 0, idx - npat + 1)
    hh = torch.where(is_img, idx // g, idx - npat + 1)
    ww = torch.where(is_img, idx % g, idx - npat + 1)
    p3 = torch.stack([t, hh, ww]).to(torch.int32)[:, None, :] + offset
    return p3.expand(3, batch, seq)


def _rope(cfg: ArchConfig, x, pos):
    if cfg.mrope:
        return nnl.apply_mrope(x, pos, cfg.rope_theta)
    return nnl.apply_rope(x, pos, cfg.rope_theta)


def _layer_params(params, i: int) -> dict:
    return {k: v[i] for k, v in params["layers"].items()}


def _ffn(cfg: ArchConfig, h, lp):
    if cfg.moe:
        return nnl.moe_mlp(h, lp, cfg.act, cfg.moe.top_k)
    return nnl.mlp(h, lp, cfg.act), 0.0


def _embed(cfg: ArchConfig, params, tokens):
    return nnl.embed(tokens, params["embed"]).to(_dtype(cfg))


def _unembed(params, x):
    w_out = params.get("unembed", params["embed"])
    return nnl.constrain(x @ w_out.T.to(x.dtype), "dp", None, "tp")


# -------------------------------------------------------------------- forward
def _layer(cfg: ArchConfig, x, lp, pos, impl):
    h = nnl.rms_norm(x, lp["ln1"])
    q, k, v = attn.qkv(h, lp, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    q = nnl.constrain(_rope(cfg, q, pos), "dp", None, "tp", None)
    k = nnl.constrain(_rope(cfg, k, pos), "dp", None, "tp", None)
    v = nnl.constrain(v, "dp", None, "tp", None)
    o = attn.sdpa(q, k, v, causal=True, window=cfg.window, impl=impl)
    o = nnl.constrain(o, "dp", None, "tp", None)
    x = x + nnl.constrain(attn.attn_out(o, lp), "dp", None, None)
    y, aux = _ffn(cfg, nnl.rms_norm(x, lp["ln2"]), lp)
    return x + y, aux


def forward(cfg: ArchConfig, params, tokens, patch_embeds=None):
    """tokens (B, S_text); patch_embeds (B, n_patches, D) for VLM.

    Returns (logits (B,S,V), aux_loss)."""
    x = _embed(cfg, params, tokens)
    if patch_embeds is not None:
        x = torch.cat([nnl.placed_like(patch_embeds.to(x.dtype), x), x],
                      dim=1)
    b, s, _ = x.shape
    pos = nnl.replicate_like(positions_for(cfg, b, s, device=x.device), x)

    def body(x, lp):
        return _layer(cfg, x, lp, pos, cfg.attn_impl)

    body_fn = _remat(cfg, body)
    aux = 0.0
    for i in range(cfg.n_layers):
        x, a = body_fn(x, _layer_params(params, i))
        aux = aux + a
    x = nnl.rms_norm(x, params["ln_f"])
    return _unembed(params, x), aux


def loss_fn(cfg: ArchConfig, params, batch):
    logits, aux = forward(cfg, params, batch["tokens"],
                          batch.get("patch_embeds"))
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:          # VLM: loss on text only
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    return lm_loss(logits, labels) + 0.01 * aux


# --------------------------------------------------------------------- decode
def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    size = min(max_len, cfg.window) if cfg.window else max_len
    shape = (cfg.n_layers, batch, size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=device)}


def decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    """One token: tokens (B,), pos the absolute position (an int).

    Returns (logits (B,V), cache).  The cache is updated in place (see
    ``attention.cache_update``) and returned."""
    pos = int(pos)
    x = _embed(cfg, params, tokens)[:, None, :]
    b = x.shape[0]
    shape = (3, b, 1) if cfg.mrope else (b, 1)
    p = nnl.replicate_like(torch.full(shape, pos, dtype=torch.int32,
                                      device=x.device), x)
    for i in range(cfg.n_layers):
        lp = _layer_params(params, i)
        h = nnl.rms_norm(x, lp["ln1"])
        q, k, v = attn.qkv(h, lp, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        q = nnl.constrain(_rope(cfg, q, p), "dp", None, "tp", None)
        k = nnl.constrain(_rope(cfg, k, p), "dp", None, "tp", None)
        v = nnl.constrain(v, "dp", None, "tp", None)
        layer_cache = attn.cache_update({"k": cache["k"][i],
                                         "v": cache["v"][i]}, k, v, pos,
                                        window=cfg.window)
        o = attn.decode_attend(q, layer_cache, pos, window=cfg.window)
        x = x + nnl.constrain(attn.attn_out(o, lp), "dp", None, None)
        y, _ = _ffn(cfg, nnl.rms_norm(x, lp["ln2"]), lp)
        x = x + y
    x = nnl.rms_norm(x, params["ln_f"])
    return _unembed(params, x)[:, 0], cache
