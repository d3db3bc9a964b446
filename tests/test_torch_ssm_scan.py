"""The port's chunked linear scan and sLSTM cell against the JAX package on
the same numpy inputs: ``chunked_linear_scan``, ``linear_step``,
``sequential_ref``, ``slstm_scan``/``slstm_step``, the scan wrapper
(which takes its plain version on the CPU) against the Pallas kernel in
interpret mode, and a plain-torch model of the bf16 route's two CUDA
kernels (intra-chunk pass, slab-wise state pass, bf16 hi/lo operand
splits) against the Pallas kernel and the step-by-step recurrence.  On the card the CUDA kernel is held against the plain
version in fp32 and, in bf16 and fp16, against ``scan_fp32``, whose match
with the Pallas kernel's bf16 numerics is checked here
(``test_torch_cuda.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ops import ssm_scan as jax_ssm_scan
from repro.kernels.ssm_scan.ref import sequential_ref as jax_sequential
from repro.nn import recurrent as jrec
from repro_torch.kernels.ssm_scan import ops
from repro_torch.nn import recurrent as trec

TOL = dict(rtol=2e-4, atol=2e-4)       # the JAX package's own (fp32)


def _inputs(rng, b, s, h, dk, dv, decay=0.2):
    """``tests/test_kernels_ssm.py``'s inputs, as numpy arrays."""
    q = rng.standard_normal((b, s, h, dk)).astype(np.float32) * 0.3
    k = rng.standard_normal((b, s, h, dk)).astype(np.float32) * 0.3
    v = rng.standard_normal((b, s, h, dv)).astype(np.float32)
    la = -np.abs(rng.standard_normal((b, s, h))).astype(np.float32) * decay
    return q, k, v, la


def _t(arrays, dtype=torch.float32):
    q, k, v, la = (torch.from_numpy(a) for a in arrays)
    return q.to(dtype), k.to(dtype), v.to(dtype), la


def _j(arrays, dtype=jnp.float32):
    q, k, v, la = (jnp.asarray(a) for a in arrays)
    return q.astype(dtype), k.astype(dtype), v.astype(dtype), la


# the JAX package's chunked-vs-sequential parameter sets
CHUNKED = [(1, 32, 2, 8, 8, 8), (2, 64, 2, 4, 16, 16), (1, 64, 4, 16, 16, 32),
           (1, 48, 1, 8, 8, 16)]
# its Pallas-vs-chunked sets, plus K > V and a sequence the kernel's 64-step
# sub-chunks do not divide
PALLAS = [(1, 32, 2, 8, 8, 8), (2, 64, 2, 4, 16, 16), (1, 64, 1, 16, 32, 32),
          (1, 64, 2, 16, 8, 16), (1, 80, 2, 8, 12, 80)]


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", CHUNKED)
def test_chunked_linear_scan_matches(b, s, h, dk, dv, chunk):
    arrays = _inputs(np.random.default_rng(s + dk), b, s, h, dk, dv)
    y, S = trec.chunked_linear_scan(*_t(arrays), chunk=chunk)
    jy, jS = jrec.chunked_linear_scan(*_j(arrays), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), **TOL)
    assert S.dtype == torch.float32 and tuple(S.shape) == (b, h, dk, dv)


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", CHUNKED[:2])
def test_sequential_ref_matches(b, s, h, dk, dv, chunk):
    arrays = _inputs(np.random.default_rng(s + dv), b, s, h, dk, dv)
    np.testing.assert_allclose(ops.sequential_ref(*_t(arrays)).numpy(),
                               np.asarray(jax_sequential(*_j(arrays))), **TOL)


def test_chunked_linear_scan_bf16_matches():
    """bf16 inputs: the decay mask and the within-chunk products in bf16,
    the state in fp32, as the reference does it."""
    arrays = _inputs(np.random.default_rng(4), 1, 64, 2, 16, 16)
    y, S = trec.chunked_linear_scan(*_t(arrays, torch.bfloat16), chunk=16)
    jy, jS = jrec.chunked_linear_scan(*_j(arrays, jnp.bfloat16), chunk=16)
    assert y.dtype == torch.bfloat16 and S.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", PALLAS)
def test_wrapper_matches_pallas_fp32(b, s, h, dk, dv, chunk):
    """The wrapper on CPU tensors (its plain version) == the Pallas kernel
    in interpret mode, and ``scan_fp32`` (the plain version on upcast
    inputs) too."""
    arrays = _inputs(np.random.default_rng(3 * s + dv), b, s, h, dk, dv)
    want = np.asarray(jax_ssm_scan(*_j(arrays), chunk=chunk))
    ops.reset_counts()
    got = ops.ssm_scan(*_t(arrays), chunk=chunk)
    assert ops.PLAIN_CALLS["ssm_scan"] == 1
    assert ops.LAUNCHES["ssm_scan"] == 0
    assert got.shape == (b, s, h, dv) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(ops.scan_fp32(*_t(arrays)).numpy(), want,
                               **TOL)


@pytest.mark.parametrize("b,s,h,dk,dv,chunk", PALLAS[:4])
def test_scan_fp32_rounded_matches_pallas_bf16(b, s, h, dk, dv, chunk):
    """The Pallas kernel on bf16 inputs upcasts them, runs in fp32 and
    rounds y to bf16: ``scan_fp32`` rounded to bf16 agrees with it to
    ``OUT_REL_TOL`` of each output row's largest value."""
    arrays = _inputs(np.random.default_rng(5 * s + dk), b, s, h, dk, dv)
    want = jax_ssm_scan(*_j(arrays, jnp.bfloat16), chunk=chunk)
    assert want.dtype == jnp.bfloat16
    got = ops.scan_fp32(*_t(arrays, torch.bfloat16)).to(torch.bfloat16)
    err = ops.row_rel_err(got, torch.tensor(np.asarray(
        want.astype(jnp.float32))))
    assert err <= ops.OUT_REL_TOL[torch.bfloat16]


def test_wrapper_reads_broadcast_heads():
    """Zamba2's q and k are one projection broadcast over the heads
    (stride 0): the wrapper takes the views as they are."""
    rng = np.random.default_rng(8)
    q, k, v, la = _inputs(rng, 2, 32, 3, 4, 8)
    qb = torch.from_numpy(q[:, :, :1]).expand(2, 32, 3, 4)
    kb = torch.from_numpy(k[:, :, :1]).expand(2, 32, 3, 4)
    assert qb.stride(2) == 0
    got = ops.ssm_scan(qb, kb, torch.from_numpy(v), torch.from_numpy(la),
                       chunk=16)
    want = jax_ssm_scan(*_j((np.broadcast_to(q[:, :, :1], q.shape),
                             np.broadcast_to(k[:, :, :1], k.shape), v, la)),
                        chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrapper_rejects_what_it_does_not_take():
    q, k, v, la = _t(_inputs(np.random.default_rng(0), 1, 48, 2, 4, 4))
    with pytest.raises(ValueError, match="not divisible"):
        ops.ssm_scan(q, k, v, la, chunk=32)
    with pytest.raises(ValueError, match="float32"):
        ops.ssm_scan(q, k, v, la.double(), chunk=16)
    with pytest.raises(ValueError, match="dtypes differ"):
        ops.ssm_scan(q, k.double(), v, la, chunk=16)
    with pytest.raises(ValueError, match="shapes do not match"):
        ops.ssm_scan(q, k[:, :, :1], v, la, chunk=16)


def test_linear_step_matches_and_updates_in_place():
    rng = np.random.default_rng(11)
    q, k, v, la = _inputs(rng, 2, 1, 3, 4, 8)
    S0 = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
    state = torch.from_numpy(S0.copy())
    y, S = trec.linear_step(
        *(torch.from_numpy(a[:, 0]) for a in (q, k, v, la)), state)
    jy, jS = jrec.linear_step(*(jnp.asarray(a[:, 0]) for a in (q, k, v, la)),
                              jnp.asarray(S0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), **TOL)
    assert S is state


def test_decode_steps_reproduce_the_scan():
    """``linear_step`` over a sequence == the chunked scan (the port's
    prefill/decode consistency for SSM caches)."""
    q, k, v, la = _t(_inputs(np.random.default_rng(12), 1, 40, 2, 4, 8))
    y_scan, S_final = trec.chunked_linear_scan(q, k, v, la, chunk=8)
    S = torch.zeros(1, 2, 4, 8)
    ys = [trec.linear_step(q[:, t], k[:, t], v[:, t], la[:, t], S)[0]
          for t in range(40)]
    torch.testing.assert_close(torch.stack(ys, 1), y_scan, **TOL)
    torch.testing.assert_close(S, S_final, **TOL)


def _slstm_params(rng, d):
    def w(*shape, scale=0.2):
        return rng.standard_normal(shape).astype(np.float32) * scale

    return {"w_gates": w(d, 4 * d), "r_gates": w(d, 4 * d),
            "b_gates": w(4 * d, scale=0.1)}


def test_slstm_scan_and_step_match():
    rng = np.random.default_rng(13)
    p = _slstm_params(rng, 16)
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    tp = {k: torch.from_numpy(a) for k, a in p.items()}
    jp = {k: jnp.asarray(a) for k, a in p.items()}
    y, st0 = trec.slstm_scan(torch.from_numpy(x), tp)
    jy, jst0 = jrec.slstm_scan(jnp.asarray(x), jp)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    # the reference returns the initial state, and so does the port
    assert all(float(t.abs().max()) == 0 for t in st0)
    h = rng.standard_normal((2, 16)).astype(np.float32) * 0.5
    c = rng.standard_normal((2, 16)).astype(np.float32) * 0.5
    hy, (th, tc) = trec.slstm_step(torch.from_numpy(x[:, 0]), tp,
                                   (torch.from_numpy(h), torch.from_numpy(c)))
    jhy, (jh, jc) = jrec.slstm_step(jnp.asarray(x[:, 0]), jp,
                                    (jnp.asarray(h), jnp.asarray(c)))
    for a, b in ((hy, jhy), (th, jh), (tc, jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # stepping the cell over the sequence reproduces the scan
    state = (torch.zeros(2, 16), torch.zeros(2, 16))
    outs = []
    for t in range(12):
        o, state = trec.slstm_step(torch.from_numpy(x[:, t]), tp, state)
        outs.append(o)
    torch.testing.assert_close(torch.stack(outs, 1), y, **TOL)


def test_row_rel_err_catches_a_dropped_chunk():
    """A kernel that drops one chunk's k v^T from the carried state (the
    chunk's own outputs right, every later one missing its contribution)
    reads far above the bf16 limit, while the right answer reads 0."""
    L = 16
    q, k, v, la = _t(_inputs(np.random.default_rng(14), 1, 64, 2, 8, 8,
                             decay=0.01))
    want, _ = trec.chunked_linear_scan(q, k, v, la, chunk=L)
    y0, S0 = trec.chunked_linear_scan(q[:, :L], k[:, :L], v[:, :L],
                                      la[:, :L], chunk=L)
    y1, _ = trec.chunked_linear_scan(q[:, L:2 * L], k[:, L:2 * L],
                                     v[:, L:2 * L], la[:, L:2 * L], chunk=L,
                                     state0=S0)
    decay = torch.exp(la[:, L:2 * L].sum(1))[..., None, None]   # (B,H,1,1)
    y2, _ = trec.chunked_linear_scan(q[:, 2 * L:], k[:, 2 * L:], v[:, 2 * L:],
                                     la[:, 2 * L:], chunk=L,
                                     state0=S0 * decay)
    dropped = torch.cat([y0, y1, y2], 1)
    assert ops.row_rel_err(want, want) == 0.0
    assert ops.row_rel_err(dropped, want) > 10 * ops.OUT_REL_TOL[
        torch.bfloat16]


# ------------------------------------------- the bf16 route's decomposition
def _split(x):
    """x as a bf16 high half and the bf16 of what it leaves (x = hi + lo to
    about 16 bits beyond bf16), both returned in fp32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _bf16_route(q, k, v, log_a, vt, split=_split):
    """What ``scan_intra_kernel`` and ``scan_state_kernel`` compute, in plain
    torch, without the final rounding of y.  Intra pass, per (batch, head,
    chunk of ``ops.CHUNK`` steps, the last one ragged): cum by a scan, P =
    q k^T (bf16 operands, fp32 sums) masked and decayed below the diagonal,
    kept as bf16 hi and lo halves, and exp(cum_i), w_j = exp(cum_T - cum_j),
    exp(cum_T) (``split`` makes the halves).  State pass, per slab of ``vt`` columns of V: S carried
    across the chunks in fp32, each product on bf16 operands with every
    fp32 operand split into hi and lo: y = exp(cum_i) (q S_hi + q S_lo) +
    P_hi v + P_lo v, then S = exp(cum_T) S + k^T (v w)_hi + k^T (v w)_lo."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    T = ops.CHUNK
    y = torch.zeros((b, s, h, dv))
    for bi in range(b):
        for hh in range(h):
            chunks = []
            for t0 in range(0, s, T):
                qc, kc = (t[bi, t0:t0 + T, hh].float() for t in (q, k))
                cum = torch.cumsum(log_a[bi, t0:t0 + T, hh].float(), 0)
                tn = qc.shape[0]
                tri = torch.tril(torch.ones(tn, tn, dtype=torch.bool))
                P = torch.where(tri, (qc @ kc.T) * torch.exp(
                    cum[:, None] - cum[None, :]), 0.0)
                chunks.append((t0, qc, kc, split(P), torch.exp(cum),
                               torch.exp(cum[-1] - cum), torch.exp(cum[-1])))
            for c0 in range(0, dv, vt):
                S = torch.zeros((dk, min(vt, dv - c0)))
                for t0, qc, kc, (ph, pl), ein, w, et in chunks:
                    vs = v[bi, t0:t0 + T, hh, c0:c0 + vt].float()
                    sh, sl = split(S)
                    y[bi, t0:t0 + T, hh, c0:c0 + vt] = (
                        ein[:, None] * (qc @ sh + qc @ sl) + ph @ vs + pl @ vs)
                    vh, vl = split(vs * w[:, None])
                    S = et * S + kc.T @ vh + kc.T @ vl
    return y


# (b, s, h, K, V, q and k broadcast over the heads): ragged last chunks,
# K != V, V not a multiple of a slab, broadcast heads
ROUTE = [(1, 200, 2, 16, 24, False), (2, 96, 1, 40, 24, False),
         (1, 130, 3, 8, 40, True), (1, 64, 2, 24, 16, False)]


def _route_inputs(case, seed):
    """bf16-representable inputs (the route's operands are exact), numpy."""
    b, s, h, dk, dv, bcast = case
    q, k, v, la = _inputs(np.random.default_rng(seed), b, s, h, dk, dv,
                          decay=0.3)
    if bcast:
        q = np.broadcast_to(q[:, :, :1], q.shape).copy()
        k = np.broadcast_to(k[:, :, :1], k.shape).copy()
    r = [torch.from_numpy(a).to(torch.bfloat16).float().numpy()
         for a in (q, k, v)]
    return (*r, la)


@pytest.mark.parametrize("case", ROUTE)
@pytest.mark.parametrize("vt", ops.SLABS[torch.bfloat16])
def test_bf16_route_decomposition_matches_sequential(case, vt):
    """The route's arithmetic, before y is rounded, against the step-by-step
    recurrence at the fp32 tolerance (2e-4 of each output row's largest
    value): the hi/lo splits keep it near fp32 rounding."""
    arrays = _route_inputs(case, sum(case[:5]))
    q, k, v, la = _t(arrays)
    if case[5]:
        q, k = (t[:, :, :1].expand(t.shape) for t in (q, k))
    got = _bf16_route(q, k, v, la, vt)
    want = ops.sequential_ref(*_t(arrays))
    assert ops.row_rel_err(got, want) <= 2e-4


@pytest.mark.parametrize("case", ROUTE)
def test_bf16_route_decomposition_matches_pallas_bf16(case):
    """Rounded to bf16, the route's arithmetic agrees with the Pallas kernel
    (interpret mode) on the same bf16 inputs to ``OUT_REL_TOL`` of each
    output row's largest value, the tolerance the card holds the kernels
    to."""
    arrays = _route_inputs(case, 7 * case[1] + case[3])
    want = jax_ssm_scan(*_j(arrays, jnp.bfloat16), chunk=case[1])
    got = _bf16_route(*_t(arrays, torch.bfloat16), ops.SLABS[
        torch.bfloat16][-1]).to(torch.bfloat16)
    err = ops.row_rel_err(got, torch.tensor(np.asarray(
        want.astype(jnp.float32))))
    assert err <= ops.OUT_REL_TOL[torch.bfloat16]


def test_bf16_route_needs_the_low_halves():
    """Dropping the lo halves (bf16 operands only) leaves an error far above
    the fp32 tolerance that the full route meets: the splits are what keep
    the tensor-core route at fp32 accuracy."""
    arrays = _route_inputs((1, 128, 1, 32, 32, False), 3)
    q, k, v, la = _t(arrays)
    want = ops.sequential_ref(q, k, v, la)
    full = ops.row_rel_err(_bf16_route(q, k, v, la, 32), want)
    hi_only = ops.row_rel_err(_bf16_route(
        q, k, v, la, 32, split=lambda x: (x.to(torch.bfloat16).float(),
                                          torch.zeros_like(x))), want)
    assert full <= 2e-4 < hi_only and 10 * full < hi_only


@pytest.mark.parametrize("case", ROUTE)
def test_bf16_route_rounds_like_fp32(case):
    """Rounded to bf16, the route's arithmetic on bf16 inputs differs from
    ``scan_fp32`` rounded to bf16 in at most ``ROUND_SHARE_TOL`` of the
    elements (the card's element-wise check of the kernel); without the lo
    halves it differs in far more, although it stays inside the row-relative
    ``OUT_REL_TOL``."""
    arrays = _route_inputs(case, 3 * case[1] + case[4])
    q, k, v, la = _t(arrays)
    if case[5]:
        q, k = (t[:, :, :1].expand(t.shape) for t in (q, k))
    want = ops.scan_fp32(q, k, v, la)
    full = _bf16_route(q, k, v, la, 32).to(torch.bfloat16)
    hi_only = _bf16_route(q, k, v, la, 32, split=lambda x: (
        x.to(torch.bfloat16).float(), torch.zeros_like(x))).to(
        torch.bfloat16)
    assert ops.round_mismatch(full, want) <= ops.ROUND_SHARE_TOL
    assert ops.round_mismatch(hi_only, want) > 8 * ops.ROUND_SHARE_TOL


def test_slab_choice_covers_both_regimes():
    """The bf16 route's slab widths by the wrapper's rule, the widest that
    fits and is no wider than V: xLSTM's K = V = 1024 takes 32 (the only
    width whose state fits the registers), Zamba2's K = 64, V = 128 takes
    one 128-column slab per head; a narrow V takes 32, the narrowest."""
    widths = ops.SLABS[torch.bfloat16]
    assert ops.pick_slab((32,), 4, 4, 1024, 132) == 32
    assert ops.pick_slab(widths, 4, 32, 128, 132) == 128
    assert ops.pick_slab(widths, 1, 1, 24, 132) == 32
    assert ops.pick_slab(widths, 2, 2, 96, 132) == 32
    assert ops.pick_slab((64, 32), 4, 32, 128, 132,
                         dtype=torch.float32) == 64
