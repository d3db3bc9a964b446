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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.nn.layers import laid_out, per_shard


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
    decode cache passed in by layer views changes with it.  A DTensor
    state (``shard.cache_specs`` places it) is stepped on each rank's own
    shard (``_placed_step``)."""
    if isinstance(state, DTensor):
        return _placed_step(q, k, v, log_a, state)
    return _step(q, k, v, log_a, state).to(q.dtype), state


def _step(q, k, v, log_a, state):
    """The fp32 update of plain ``state`` in place; y (B,H,V) in fp32."""
    a = torch.exp(log_a.float())[..., None, None]
    state.mul_(a).add_(torch.einsum("bhk,bhv->bhkv", k.float(), v.float()))
    return torch.einsum("bhk,bhkv->bhv", q.float(), state)


# the layout of the operands q and k (B,H,K), v (B,H,V), log_a (B,H) and
# of y (B,H,V) where a (B,H,K,V) state is sharded on dim 0, 1, 2 or 3 of
# one mesh dim; replicated elsewhere
_STEP_LAYOUT = {0: (Shard(0), Shard(0), Shard(0), Shard(0)),
                1: (Shard(1), Shard(1), Shard(1), Shard(1)),
                2: (Shard(2), Replicate(), Replicate(), Partial()),
                3: (Replicate(), Shard(2), Replicate(), Shard(2))}
_REPLICATED = (Replicate(),) * 4


def _placed_step(q, k, v, log_a, state):
    """``linear_step`` of a DTensor state on its local shard.  The operands
    are laid out once at entry to match it: a shard of K takes q's and k's
    rows of K and the whole of v, and its y is a partial sum over K, summed
    in fp32 before the cast.  The shard is updated in place."""
    mesh = state.device_mesh
    lay = [_STEP_LAYOUT[p.dim] if isinstance(p, Shard) else _REPLICATED
           for p in state.placements]

    def local(t, j: int):
        return laid_out(t, state, [row[j] for row in lay]).to_local()

    yl = _step(local(q, 0), local(k, 0), local(v, 1), local(log_a, 2),
               state.to_local())
    shape = (*q.shape[:2], v.shape[-1])
    y = DTensor.from_local(yl, mesh, [row[3] for row in lay], run_check=False,
                           shape=shape,
                           stride=(shape[1] * shape[2], shape[2], 1))
    y = y.redistribute(mesh, [Replicate() if isinstance(p, Partial) else p
                              for p in y.placements])
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
    state returned is ``state0``, not the final one.  On DTensors the loop
    runs on each rank's own rows (``_on_rows``)."""
    b, s, d = x.shape
    gates = x @ p["w_gates"] + p["b_gates"]                   # (B,S,4D)
    if state0 is None:
        state0 = (torch.zeros((b, d), dtype=torch.float32, device=x.device),
                  torch.zeros((b, d), dtype=torch.float32, device=x.device))
    r = p["r_gates"].float()
    return _on_rows(_slstm_loop, 1, gates, r, *state0).to(x.dtype), state0


def _slstm_loop(gates, r, h, c):
    hs = []
    for t in range(gates.shape[1]):
        h, c = _slstm_cell(gates[:, t].float(), h, c, r)
        hs.append(h)
    return torch.stack(hs, 1)


def slstm_step(x, p, state):
    """One decode step: x (B,D), state (h, c).  Returns (h in x's dtype,
    (h, c))."""
    g = x @ p["w_gates"] + p["b_gates"]
    h, c = _on_rows(lambda g, r, h, c: _slstm_cell(g.float(), h, c, r), 2,
                    g, p["r_gates"].float(), *state)
    return h.to(x.dtype), (h, c)


def _on_rows(fn, n_out: int, gates, r, h, c):
    """``fn(gates, r, h, c)`` (``n_out`` outputs).  Where ``gates`` is a
    DTensor it runs on each rank's own rows (``layers.per_shard``): the
    gates, the state and the outputs keep their batch shards and are whole
    elsewhere, r is whole, so each rank runs the recurrence of its rows in
    full, as one card does, with no collective inside the loop.  r's
    gradient is a partial sum over the mesh dims that shard the rows."""
    if not isinstance(gates, DTensor):
        return fn(gates, r, h, c)
    rows = tuple(p if p == Shard(0) else Replicate()
                 for p in gates.placements)
    whole = (Replicate(),) * gates.device_mesh.ndim
    r_grad = tuple(Partial() if p == Shard(0) else p for p in rows)
    return per_shard(fn, (gates, r, h, c), (rows, whole, rows, rows),
                     list(rows) if n_out == 1 else (list(rows),) * n_out,
                     (rows, r_grad, rows, rows))
