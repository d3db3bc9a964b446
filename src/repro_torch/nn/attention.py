# Ported from src/repro/nn/attention.py (jax.numpy -> torch).
"""GQA attention: full / causal / sliding-window, prefill and single-token
decode with a KV cache, and the hand-written flash kernel for the
score+softmax+value contraction of a causal prefill (``impl="flash"``)."""
from __future__ import annotations

import torch

NEG = -1e30


def _split_heads(x, n_heads, d_head):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, d_head)


def qkv(x, p, n_heads, n_kv, d_head):
    q = _split_heads(x @ p["wq"], n_heads, d_head)
    k = _split_heads(x @ p["wk"], n_kv, d_head)
    v = _split_heads(x @ p["wv"], n_kv, d_head)
    return q, k, v


def sdpa(q, k, v, *, causal: bool = True, window: int = 0,
         q_offset: int = 0, impl: str = "xla", kv_len_mask=None):
    """q (B,Sq,H,D), k/v (B,Sk,KV,D) with H % KV == 0.  Returns (B,Sq,H,D).

    ``impl``: "flash" (the CUDA kernel, for a causal, window-free, unmasked
    call; anything else takes the plain path), "xla_chunked" or "xla" (the
    plain tensor code, named after the reference's).
    ``q_offset``: absolute position of q[0] (decode: Sk-1 or cache length).
    ``kv_len_mask``: optional (B, Sk) validity mask (ragged decode caches).
    """
    if impl == "flash" and causal and window == 0 and kv_len_mask is None:
        from repro_torch.kernels.flash_attention import ops as flash

        return flash.flash_attention(q, k, v, q_offset=q_offset)
    if impl == "xla_chunked" and kv_len_mask is None:
        return sdpa_chunked(q, k, v, causal=causal, window=window,
                            q_offset=q_offset)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, sq, kv, g, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    logits = logits * (1.0 / d ** 0.5)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = logits.masked_fill(~mask, NEG)
    if kv_len_mask is not None:
        logits = logits.masked_fill(~kv_len_mask[:, None, None, None, :], NEG)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(b, sq, h, d)


def sdpa_chunked(q, k, v, *, causal=True, window=0, q_offset=0,
                 blk: int = 1024):
    """Flash-style attention in plain tensor ops: a loop over KV blocks with
    online max/sum renormalization, so the S x S score matrix never exists
    as a whole tensor (the reference's ``lax.scan`` is a Python loop)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if sk % blk or (causal and sq != sk) or window:
        return sdpa(q, k, v, causal=causal, window=window, q_offset=q_offset,
                    impl="xla")
    g = h // kv
    qg = (q.reshape(b, sq, kv, g, d) * (1.0 / d ** 0.5)).to(q.dtype)
    qpos = torch.arange(sq, device=q.device) + q_offset
    m = torch.full((b, kv, g, sq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kv, g, sq, d), dtype=torch.float32, device=q.device)
    for ki in range(sk // blk):
        kb = k[:, ki * blk:(ki + 1) * blk]
        vb = v[:, ki * blk:(ki + 1) * blk]
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kb).float()
        if causal:
            kpos = ki * blk + torch.arange(blk, device=q.device)
            s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = alpha * l + torch.sum(p, dim=-1)
        acc = (acc * alpha[..., None]
               + torch.einsum("bkgqs,bskd->bkgqd", p.to(q.dtype), vb).float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def attn_out(o, p):
    b, s, h, d = o.shape
    return o.reshape(b, s, h * d) @ p["wo"]


# ----------------------------------------------------------------- KV cache
def cache_init(batch, max_len, n_kv, d_head, dtype, device=None):
    return {
        "k": torch.zeros((batch, max_len, n_kv, d_head), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, n_kv, d_head), dtype=dtype,
                         device=device),
    }


def cache_update(cache, k_new, v_new, pos: int, window: int = 0):
    """Insert one decode step at absolute position ``pos``.  With SWA the
    cache is a rolling buffer of size ``window`` (slot = pos % window).

    Unlike the reference (a functional ``dynamic_update_slice``), the write
    is in place: ``cache`` itself is updated and returned, so a stacked
    cache whose layer views were passed in changes with it."""
    slot = (pos % window) if window else pos
    cache["k"][:, slot:slot + 1] = k_new
    cache["v"][:, slot:slot + 1] = v_new
    return cache


def decode_attend(q, cache, pos: int, *, window: int = 0):
    """Single-token decode: q (B,1,H,D) against the cache.

    Full attention: attends to cache[:pos+1].  SWA: rolling buffer masked to
    the last ``window`` positions (no re-ordering needed: softmax is
    permutation-invariant over keys)."""
    b, _, h, d = q.shape
    k, v = cache["k"], cache["v"]
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, 1, kv, g, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    logits = logits * (1.0 / d ** 0.5)
    slots = torch.arange(sk, device=q.device)
    if window:
        valid = slots < min(pos + 1, window)       # rolling occupancy
    else:
        valid = slots <= pos
    logits = logits.masked_fill(~valid, NEG)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(b, 1, h, d)
