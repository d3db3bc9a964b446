# Ported from src/repro/nn/zamba.py (jax.numpy -> torch).
"""Zamba2-style hybrid: a Mamba2 backbone with ONE shared-weight
attention+MLP block applied every ``cfg.shared_attn_every`` layers.

Mamba2 (SSD form) reuses the chunked linear recurrence (``kernels/ssm_scan``):
k ~ B-projection (ssm_state dim), v ~ x heads (head_dim), q ~ C-projection,
per-head scalar decay from the dt/A gate.  The shared block has distinct
per-application norms and rank-r LoRA adapters on its projections (Zamba2's
design); its input is [hidden, original embedding] concatenated, as in the
paper.  Under ``cfg.remat`` each Mamba2 block runs under ``layers.remat``
(the reference's ``jax.remat``); in backward the scan's gradient comes from
``ops.ScanFunction`` on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssm_scan import ops
from repro_torch.nn import attention as attn
from repro_torch.nn import layers as nnl
from repro_torch.nn import recurrent as rec
from repro_torch.nn.model import lm_loss


def _dims(cfg: ArchConfig):
    inner = 2 * cfg.d_model
    h = cfg.n_heads
    return inner, h, inner // h, cfg.ssm_state


def _napp(cfg: ArchConfig) -> int:
    return cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0


def init_params(cfg: ArchConfig, generator: torch.Generator | None,
                device: torch.device):
    """Normal(0, 0.02) weights drawn on ``device`` from ``generator``, with
    the reference's keys and shapes; norm gains are fp32 ones and the decay
    bias ``a_log`` fp32 zeros."""
    dt = getattr(torch, cfg.dtype)
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    inner, h, hd, N = _dims(cfg)
    napp = _napp(cfg)
    r = cfg.shared_attn_lora_rank

    def norm(*shape):
        return torch.randn(shape, generator=generator, dtype=dt,
                           device=device).mul_(0.02)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    mamba = {
        "ln": ones(L, d),
        "w_in": norm(L, d, 2 * inner),                  # x path + gate path
        "w_bcdt": norm(L, inner, 2 * N + h),            # B, C, dt per head
        "a_log": torch.zeros((L, h), dtype=torch.float32, device=device),
        "w_out": norm(L, inner, d),
    }
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    shared = {
        "ln1": ones(2 * d),
        "wq": norm(2 * d, hq), "wk": norm(2 * d, hkv),
        "wv": norm(2 * d, hkv), "wo": norm(hq, d),
        "ln2": ones(d),
        "w1": norm(d, cfg.d_ff), "w3": norm(d, cfg.d_ff),
        "w2": norm(cfg.d_ff, d),
    }
    lora = {  # per-application rank-r adapters on q and w1
        "qa": norm(napp, 2 * d, r), "qb": norm(napp, r, hq),
        "m1a": norm(napp, d, r), "m1b": norm(napp, r, cfg.d_ff),
        "ln1": ones(napp, 2 * d),
        "ln2": ones(napp, d),
    }
    return {"embed": norm(V, d), "mamba": mamba, "shared": shared,
            "lora": lora, "ln_f": ones(d)}


def _layer(stack: dict, i: int) -> dict:
    return {k: v[i] for k, v in stack.items()}


def _mamba_qkvg(cfg, hin, lp):
    """q and k (the C and B projections) are shared by all heads: they are
    returned with one head, (B,S,1,N), which ``ssm_scan`` expands over v's
    heads (stride 0; the kernel reads them in place without a copy, on a
    mesh each rank over its own heads)."""
    inner, h, hd, N = _dims(cfg)
    b, s, _ = hin.shape
    up = hin @ lp["w_in"]
    xpath, gate = torch.chunk(up, 2, dim=-1)
    bcdt = xpath @ lp["w_bcdt"]
    Bm, Cm, dt_ = torch.split(bcdt, [N, N, h], dim=-1)
    # per-head decay: a = -softplus(dt + a_log); k=B (shared across heads),
    # v=x heads, q=C
    log_a = -F.softplus(dt_.float() + lp["a_log"][None, None, :])  # (B,S,H)
    dt_g = F.softplus(dt_.float())                                 # input gate
    k = Bm[:, :, None, :]
    q = Cm[:, :, None, :]
    v = xpath.reshape(b, s, h, hd) * dt_g[..., None].to(xpath.dtype)
    return q, k, nnl.constrain(v, "dp", None, "tp", None), log_a, gate


def _mamba_block(cfg, x, lp, chunk: int):
    inner, h, hd, N = _dims(cfg)
    hin = nnl.rms_norm(x, lp["ln"])
    q, k, v, log_a, gate = _mamba_qkvg(cfg, hin, lp)
    y = ops.ssm_scan(q, k, v, log_a, chunk=chunk)
    b, s = x.shape[:2]
    y = y.reshape(b, s, inner) * F.silu(gate)
    return x + nnl.residual(y @ lp["w_out"])


def _shared_in(cfg, x, x0, sp, la):
    """Norm of [hidden, embedding] and the q/k/v projections (q through the
    application's LoRA) of the shared block, heads split."""
    cat = torch.cat([x, nnl.placed_like(x0, x)], dim=-1)
    h = nnl.rms_norm(cat, la["ln1"] * sp["ln1"])
    wq = sp["wq"] + la["qa"] @ la["qb"]
    hd = cfg.head_dim
    q = attn._split_heads(h @ wq, cfg.n_heads, hd)
    k = attn._split_heads(h @ sp["wk"], cfg.n_kv_heads, hd)
    v = attn._split_heads(h @ sp["wv"], cfg.n_kv_heads, hd)
    return q, k, v


def _shared_out(x, o, sp, la):
    """Attention output projection and the LoRA-adapted gated MLP."""
    x = x + nnl.residual(attn.attn_out(o, sp))
    h2 = nnl.rms_norm(x, la["ln2"] * sp["ln2"])
    w1 = sp["w1"] + la["m1a"] @ la["m1b"]
    y = F.silu(h2 @ w1) * (h2 @ sp["w3"])
    return x + nnl.residual(y @ sp["w2"])


def _shared_block(cfg, x, x0, sp, la):
    """Shared attention+MLP; input = concat(hidden, embedding residual).
    Attention keeps ``sdpa``'s default ``impl``, as the reference does."""
    b, s, _ = x.shape
    q, k, v = _shared_in(cfg, x, x0, sp, la)
    pos = nnl.replicate_like(torch.arange(s, dtype=torch.int32,
                                          device=x.device)[None].expand(b, s),
                             x)
    q = nnl.apply_rope(q, pos, cfg.rope_theta)
    k = nnl.apply_rope(k, pos, cfg.rope_theta)
    o = attn.sdpa(q, k, v, causal=True)
    return _shared_out(x, o, sp, la)


def forward(cfg: ArchConfig, params, tokens, patch_embeds=None):
    """tokens (B, S).  Returns (logits (B,S,V), 0.0).  One ``ssm_scan`` per
    Mamba2 layer; the shared block follows every ``shared_attn_every``."""
    x = nnl.embed(tokens, params["embed"]).to(getattr(torch, cfg.dtype))
    x0 = x
    chunk = rec.chunk_for(x.shape[1])
    k = cfg.shared_attn_every
    mp = params["mamba"]

    def mbody(x, lp):
        return _mamba_block(cfg, x, lp, chunk)

    body = nnl.remat(mbody) if cfg.remat else mbody
    off = 0
    for gi in range(_napp(cfg)):
        for i in range(off, off + k):
            x = body(x, _layer(mp, i))
        off += k
        x = _shared_block(cfg, x, x0, params["shared"],
                          _layer(params["lora"], gi))
    for i in range(off, cfg.n_layers):
        x = body(x, _layer(mp, i))
    x = nnl.rms_norm(x, params["ln_f"])
    return _unembed(params, x), 0.0


def loss_fn(cfg: ArchConfig, params, batch):
    logits, _ = forward(cfg, params, batch["tokens"])
    return lm_loss(logits, batch["labels"])


# --------------------------------------------------------------------- decode
def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None):
    inner, h, hd, N = _dims(cfg)
    napp = _napp(cfg)
    kv = (max(napp, 1), batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = getattr(torch, cfg.dtype)
    return {
        "ssm": torch.zeros((cfg.n_layers, batch, h, N, hd),
                           dtype=torch.float32, device=device),
        "k": torch.zeros(kv, dtype=dt, device=device),
        "v": torch.zeros(kv, dtype=dt, device=device),
    }


def decode_step(cfg: ArchConfig, params, cache, tokens, pos: int):
    """One token: tokens (B,), pos the absolute position (an int).

    Returns (logits (B,V), cache).  Unlike the reference, the SSM states
    and the shared block's KV caches are updated in place (see
    ``recurrent.linear_step`` and ``attention.cache_update``) and the cache
    itself is returned."""
    pos = int(pos)
    x = nnl.embed(tokens, params["embed"])[:, None, :].to(
        getattr(torch, cfg.dtype))
    x0 = x
    inner, h, hd, N = _dims(cfg)
    k_every = cfg.shared_attn_every
    mp = params["mamba"]
    b = x.shape[0]

    def mstep(x, i):
        lp = _layer(mp, i)
        hin = nnl.rms_norm(x, lp["ln"])
        q, kk, v, log_a, gate = _mamba_qkvg(cfg, hin, lp)
        y, _ = rec.linear_step(q[:, 0].expand(b, h, N),
                               kk[:, 0].expand(b, h, N), v[:, 0],
                               log_a[:, 0], cache["ssm"][i])
        y = y.reshape(b, 1, inner) * F.silu(gate)
        return x + nnl.residual(y @ lp["w_out"])

    p = nnl.replicate_like(torch.full((b, 1), pos, dtype=torch.int32,
                                      device=x.device), x)
    off = 0
    for gi in range(_napp(cfg)):
        for i in range(off, off + k_every):
            x = mstep(x, i)
        off += k_every
        sp, la = params["shared"], _layer(params["lora"], gi)
        q, kk, vv = _shared_in(cfg, x, x0, sp, la)
        # q, k and v laid out as the KV cache (``shard.cache_specs``)
        q, kk, vv = (nnl.constrain(t, "dp", None, "tp", None) for t in (
            nnl.apply_rope(q, p, cfg.rope_theta),
            nnl.apply_rope(kk, p, cfg.rope_theta), vv))
        lc = attn.cache_update({"k": cache["k"][gi], "v": cache["v"][gi]},
                               kk, vv, pos)
        o = attn.decode_attend(q, lc, pos)
        x = _shared_out(x, o, sp, la)
    for i in range(off, cfg.n_layers):
        x = mstep(x, i)
    x = nnl.rms_norm(x, params["ln_f"])
    return _unembed(params, x)[:, 0], cache


def _unembed(params, x):
    """Tied unembedding; a vocab-sharded table gives vocab-sharded
    logits."""
    return nnl.constrain(x @ params["embed"].T.to(x.dtype), "dp", None, "tp")
