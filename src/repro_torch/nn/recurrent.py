# Ported from src/repro/nn/recurrent.py (jax.numpy -> torch).
"""Chunked linear recurrences — the shared machinery for mLSTM (xLSTM) and
Mamba2 (SSD), plus the sequential sLSTM cell.

The recurrence  S_t = a_t * S_{t-1} + k_t v_t^T ,  y_t = S_t^T q_t  (with
per-(step, head) scalar decay a_t) is evaluated in the chunk-parallel form:
within a chunk of length L the contribution is a masked (decay-weighted)
attention-like contraction, across chunks the state S (K x V per head) is
carried from one chunk to the next.  The reference's ``lax.scan`` loops are
Python loops; on the card the model layers reach the chunked form through
``kernels/ssm_scan`` (``ops.ssm_scan``), whose CPU branch is
``chunked_linear_scan`` below.
"""
from __future__ import annotations

import torch


def chunk_for(seq: int, default: int = 128) -> int:
    """Chunk length of a sequence, as the reference's ``nn/flags.chunk_for``
    outside its measurement mode: ``default`` when it divides the sequence,
    else the whole sequence."""
    return default if seq % default == 0 else seq


def chunked_linear_scan(q, k, v, log_a, *, chunk: int = 128, state0=None):
    """q,k: (B,S,H,K); v: (B,S,H,V); log_a: (B,S,H) <= 0 (log decay).

    Returns y (B,S,H,V), final state (B,H,K,V).  As in the reference, the
    decay mask is cast to q's dtype and the within-chunk products run in
    q's dtype; the state update runs in fp32.  (The reference's ``unroll``
    only steers XLA's cost analysis and has no counterpart here.)"""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    L = min(chunk, s)
    if s % L:
        raise ValueError(f"seq {s} not divisible by chunk {L}")
    n = s // L

    qc = q.reshape(b, n, L, h, dk).permute(1, 0, 3, 2, 4)   # (n,B,H,L,K)
    kc = k.reshape(b, n, L, h, dk).permute(1, 0, 3, 2, 4)
    vc = v.reshape(b, n, L, h, dv).permute(1, 0, 3, 2, 4)
    lac = log_a.reshape(b, n, L, h).permute(1, 0, 3, 2)     # (n,B,H,L)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))

    S = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
         if state0 is None else state0)
    ys = []
    for qb, kb, vb, lab in zip(qc, kc, vc, lac):
        cum = torch.cumsum(lab, dim=-1)                       # (B,H,L)
        # within-chunk decay-masked "attention": A[i,j] = exp(cum_i - cum_j)
        # for j <= i (contribution of step j's kv to step i's output)
        diff = cum[..., :, None] - cum[..., None, :]          # (B,H,L,L)
        # exp of the masked diff, not the reference's where(tri, exp(diff),
        # 0): the same values, but the upper triangle's exp (e^{+100} and
        # more over a long chunk) never overflows into 0 * inf = nan under
        # autograd
        A = torch.exp(diff.masked_fill(~tri, float("-inf"))).to(qb.dtype)
        scores = torch.einsum("bhik,bhjk->bhij", qb, kb) * A
        intra = torch.einsum("bhij,bhjv->bhiv", scores, vb)
        # inter-chunk: state carried in, decayed per step
        decay_in = torch.exp(cum)[..., None].to(qb.dtype)    # (B,H,L,1)
        inter = torch.einsum("bhik,bhkv->bhiv", qb * decay_in, S.to(qb.dtype))
        # state update: S' = a_total * S + sum_j exp(cum_L - cum_j) k_j v_j^T
        total = cum[..., -1:]                                  # (B,H,1)
        w = torch.exp(total - cum)[..., None]                  # (B,H,L,1)
        S = (torch.exp(total)[..., None] * S.float()
             + torch.einsum("bhjk,bhjv->bhkv", kb.float() * w, vb.float()))
        ys.append((intra + inter).to(vb.dtype))
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(b, s, h, dv)
    return y, S


def linear_step(q, k, v, log_a, state):
    """One decode step.  q,k (B,H,K); v (B,H,V); log_a (B,H); state
    (B,H,K,V) fp32.

    Returns y (B,H,V), new state.  Unlike the reference (functional), the
    new state is written into ``state`` itself, which is returned: a
    decode cache passed in by layer views changes with it."""
    a = torch.exp(log_a.float())[..., None, None]
    state.mul_(a).add_(torch.einsum("bhk,bhv->bhkv", k.float(), v.float()))
    y = torch.einsum("bhk,bhkv->bhv", q.float(), state)
    return y.to(q.dtype), state


# ------------------------------------------------------------------- sLSTM
def _slstm_cell(g, h, c, r_gates):
    """One sLSTM step on fp32 gate pre-activations ``g`` (B,4D)."""
    gi, gf, gz, go = torch.chunk(g + h @ r_gates, 4, dim=-1)
    i, f = torch.sigmoid(gi), torch.sigmoid(gf)
    z, o = torch.tanh(gz), torch.sigmoid(go)
    c = f * c + i * z
    h = o * torch.tanh(c)
    return h, c


def slstm_scan(x, p, state0=None):
    """Sequential sLSTM block core: x (B,S,D) -> (B,S,D), state.

    A true recurrence (non-linear state dependence), so a loop over time.
    ``r_gates`` is cast to fp32 once before the loop (the reference casts it
    in every step; the values are the same).  As in the reference, the
    state returned is ``state0``, not the final one."""
    b, s, d = x.shape
    gates = x @ p["w_gates"] + p["b_gates"]                   # (B,S,4D)
    if state0 is None:
        state0 = (torch.zeros((b, d), dtype=torch.float32, device=x.device),
                  torch.zeros((b, d), dtype=torch.float32, device=x.device))
    r = p["r_gates"].float()
    h, c = state0
    hs = []
    for t in range(s):
        h, c = _slstm_cell(gates[:, t].float(), h, c, r)
        hs.append(h)
    return torch.stack(hs, 1).to(x.dtype), state0


def slstm_step(x, p, state):
    """One decode step: x (B,D), state (h, c).  Returns (h in x's dtype,
    (h, c))."""
    h, c = state
    g = x @ p["w_gates"] + p["b_gates"]
    h, c = _slstm_cell(g.float(), h, c, p["r_gates"].float())
    return h.to(x.dtype), (h, c)
