# Ported from src/repro/nn/attention.py (jax.numpy -> torch).
"""GQA attention: full / causal / sliding-window, prefill and single-token
decode with a KV cache, and the hand-written flash kernel for the
score+softmax+value contraction of a causal prefill (``impl="flash"``).

Attention is independent per head, so on DTensors (tensor-parallel, q, k
and v sharded on the head dim, the batch on the data axes) ``sdpa`` and
``decode_attend`` run on each rank's local heads (``layers.per_shard``):
the kernel, whose ``ctypes`` launch cannot take a DTensor, sees plain
tensors of the rank's H/model q heads and KV/model kv heads.  Heads that
do not divide the model axis replicate; a decode cache whose sequence is
sharded instead (``shard.cache_specs``) combines the ranks' partial
softmaxes with all-reduces (flash-decode)."""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as fc
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.nn.layers import (gather_dim, grad_as_forward, per_shard,
                                   summed)

NEG = -1e30


def _split_heads(x, n_heads, d_head):
    b, s, _ = x.shape
    if isinstance(x, DTensor):
        ways = 1
        for i, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == x.ndim - 1:
                ways *= x.device_mesh.size(i)
        if n_heads % ways:          # heads that do not divide replicate
            x = gather_dim(x, -1)
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
    if isinstance(q, DTensor):
        return _per_head(sdpa, q, k, v, causal=causal, window=window,
                         q_offset=q_offset, impl=impl,
                         kv_len_mask=kv_len_mask)
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


def _head_matched(q, k):
    """q replicated on each mesh dim where it is head-sharded and the kv
    heads are not (they do not divide), so each rank's local q heads read
    the kv heads it holds (q head h reads kv head h // (H/KV))."""
    want = tuple(Replicate() if pq == Shard(2) and pk != Shard(2) else pq
                 for pq, pk in zip(q.placements, k.placements))
    return q if want == q.placements else q.redistribute(q.device_mesh,
                                                           want)


def _per_head(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` on each rank's local heads and rows (a partial
    sum, such as the cross-attention K/V of a row-parallel encoder output,
    is summed first); the output takes q's placements."""
    q = _head_matched(q, k)
    kw = {n: (x.to_local() if isinstance(x, DTensor) else x)
          for n, x in kw.items()}
    pl = [summed(t.placements) for t in (q, k, v)]
    return per_shard(lambda a, b, c: fn(a, b, c, **kw), (q, k, v), pl,
                     list(pl[0]))


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
    return grad_as_forward(o.reshape(b, s, h * d)) @ p["wo"]


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
    for name, new in (("k", k_new), ("v", v_new)):
        # a sharded cache is written through its local shard, laid out as
        # the new entry's but for a sharded sequence: only the rank that
        # holds the slot writes it
        c = cache[name]
        local, start = _local(c), _seq_start(c)
        if start <= slot < start + local.shape[1]:
            local[:, slot - start:slot - start + 1] = _local(new)
    return cache


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _seq_dims(t) -> list[int]:
    """The mesh dims that shard a (B, S, KV, D) cache's sequence."""
    if not isinstance(t, DTensor):
        return []
    return [i for i, p in enumerate(t.placements)
            if isinstance(p, Shard) and p.dim == 1]


def _seq_start(t) -> int:
    """The first sequence slot of this rank's shard (major to minor over
    the mesh dims that shard it)."""
    idx = 0
    for i in _seq_dims(t):
        idx = idx * t.device_mesh.size(i) + t.device_mesh.get_local_rank(i)
    return idx * _local(t).shape[1]


def decode_attend(q, cache, pos: int, *, window: int = 0):
    """Single-token decode: q (B,1,H,D) against the cache.

    Full attention: attends to cache[:pos+1].  SWA: rolling buffer masked to
    the last ``window`` positions (no re-ordering needed: softmax is
    permutation-invariant over keys)."""
    if isinstance(q, DTensor) and _seq_dims(cache["k"]):
        return _decode_seq_sharded(q, cache, pos, window)
    if isinstance(q, DTensor):
        return _per_head(
            lambda q, k, v: decode_attend(q, {"k": k, "v": v}, pos,
                                          window=window),
            q, cache["k"], cache["v"])
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


def _decode_seq_sharded(q, cache, pos: int, window: int):
    """Decode against a cache whose sequence is sharded (its kv heads do
    not divide the model axis, or the batch is too small for the data
    axes): each rank scores its own slots, and one max and two sum
    all-reduces over the sequence's mesh dims combine the partial
    softmaxes (flash-decode).  Heads that the cache does not shard are
    whole on every rank, so q's are gathered where they are sharded."""
    k, v = cache["k"], cache["v"]
    q = _head_matched(q, k)
    mesh = k.device_mesh
    groups = [mesh.get_group(i) for i in _seq_dims(k)]
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    b, _, h, d = ql.shape
    sk, kv = kl.shape[1], kl.shape[2]
    qg = ql.reshape(b, 1, kv, h // kv, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, kl).float()
    logits = logits * (1.0 / d ** 0.5)
    slots = torch.arange(sk, device=ql.device) + _seq_start(k)
    valid = slots < min(pos + 1, window) if window else slots <= pos
    logits = logits.masked_fill(~valid, NEG)
    m = torch.amax(logits, dim=-1, keepdim=True)
    for g in groups:
        m = fc.all_reduce(m, "max", g)
    p = torch.exp(logits - m)
    den = torch.sum(p, dim=-1, keepdim=True)
    num = torch.einsum("bkgqs,bskd->bkgqd", p, vl.float())
    for g in groups:
        den = fc.all_reduce(den, "sum", g)
        num = fc.all_reduce(num, "sum", g)
    out = (num / den).to(ql.dtype).permute(0, 3, 1, 2, 4).reshape(b, 1, h, d)
    return DTensor.from_local(out, mesh, q.placements, run_check=False)
