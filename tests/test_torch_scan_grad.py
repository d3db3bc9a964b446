"""Kernels under autograd: the scan's backward (``ops.plain_backward``,
the plain version of the backward kernels' passes: dq forward in time, dk
and dv in reverse, d log_a from their row dots) against ``torch.autograd``
through ``chunked_linear_scan`` and against ``jax.grad`` of the
reference's ``chunked_linear_scan``; ``ops.ScanFunction`` (the card's
wiring, here around the plain scan) with Zamba2's head-broadcast q and k;
and the kernels without a backward (flash, both conv kernels) refusing
autograd on the CPU.  fp32; each tolerance is stated beside its check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import recurrent as jrec
from repro_torch.kernels.conv_fused import ops as conv_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssm_scan import ops
from repro_torch.nn.recurrent import chunked_linear_scan

# (B, S, H, K, V, the reference's chunk, q and k broadcast over the heads,
# log_a: "sigmoid" (log sigmoid of a normal), "near 0" (-1e-3 |normal|),
# "near -20" (-20 - |normal| / 10)).  The backward's own chunks are 64 steps.
CASES = {
    "several chunks": (2, 96, 3, 5, 7, 32, False, "sigmoid"),
    "K != V": (2, 64, 2, 12, 4, 16, False, "sigmoid"),
    "stride-0 q, k": (2, 64, 4, 8, 16, 16, True, "sigmoid"),
    "ragged S": (1, 50, 2, 6, 6, 50, False, "sigmoid"),
    # edges of the 64-step chunks: a ragged last chunk (the reverse pass's
    # first), one chunk exactly, one step past it
    "S=200, ragged last chunk": (2, 200, 2, 6, 9, 40, False, "sigmoid"),
    "S=64": (1, 64, 2, 8, 8, 64, False, "sigmoid"),
    "S=65": (2, 65, 2, 8, 8, 13, False, "sigmoid"),
    "K > V": (1, 130, 2, 24, 6, 26, False, "sigmoid"),
    "K < V": (1, 130, 2, 6, 24, 26, False, "sigmoid"),
    "one-head q, k over 4 heads": (2, 140, 4, 8, 12, 28, True, "sigmoid"),
    "log_a near 0": (2, 130, 2, 6, 6, 26, False, "near 0"),
    # the reference's where(tri, exp(diff), 0) overflows under jax.grad
    # once a chunk's log decay passes about -88: its chunk is 4 steps here
    "log_a near -20": (2, 132, 2, 6, 6, 4, False, "near -20"),
}
# fp32 against torch.autograd: the same algebra in another order; the
# d log_a reduction sums differences of O(S) terms
TOL = dict(rtol=1e-4, atol=5e-4)


def _inputs(case, seed=0):
    b, s, h, k, v, _, bcast, decay = case
    rng = np.random.default_rng(seed)
    hq = 1 if bcast else h
    q = (rng.standard_normal((b, s, hq, k)) / k ** 0.5).astype(np.float32)
    kk = (rng.standard_normal((b, s, hq, k)) / k ** 0.5).astype(np.float32)
    vv = rng.standard_normal((b, s, h, v)).astype(np.float32)
    x = rng.standard_normal((b, s, h))
    la = {"sigmoid": np.log(1 / (1 + np.exp(-x))),
          "near 0": -1e-3 * np.abs(x),
          "near -20": -20 - np.abs(x) / 10}[decay].astype(np.float32)
    dy = rng.standard_normal((b, s, h, v)).astype(np.float32)
    return q, kk, vv, la, dy


def _leaves(arrs):
    return [torch.from_numpy(a).requires_grad_(True) for a in arrs]


def _expand(t, h):
    b, s, _, k = t.shape
    return t.expand(b, s, h, k)


def _plain(chunk):
    return lambda q, k, v, la: chunked_linear_scan(q, k, v, la,
                                                   chunk=chunk)[0]


def _autograd(case):
    """dq, dk, dv, d log_a of <chunked_linear_scan, dy> by torch.autograd
    (summed over the heads for broadcast q and k)."""
    h, chunk = case[2], case[5]
    q, k, v, la, dy = _inputs(case)
    ql, kl, vl, lal = _leaves((q, k, v, la))
    y = chunked_linear_scan(_expand(ql, h), _expand(kl, h), vl, lal,
                            chunk=chunk)[0]
    return torch.autograd.grad(y, (ql, kl, vl, lal), torch.from_numpy(dy))


@pytest.mark.parametrize("name", CASES)
def test_scan_backward_matches_autograd(name):
    case = CASES[name]
    h = case[2]
    q, k, v, la, dy = (torch.from_numpy(a) for a in _inputs(case))
    got = ops.plain_backward(_expand(q, h), _expand(k, h), v, la, dy)
    want = _autograd(case)
    for g, w, nm in zip(got, want, ("dq", "dk", "dv", "dlog_a")):
        if case[6] and nm in ("dq", "dk"):
            g = g.sum(2, keepdim=True)
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL, err_msg=nm)


@pytest.mark.parametrize("name", CASES)
def test_scan_backward_matches_jax_grad(name):
    """Against ``jax.grad`` of the reference's chunked scan (the recurrence
    the JAX package differentiates; it has no Pallas backward)."""
    case = CASES[name]
    h, chunk, bcast = case[2], case[5], case[6]
    q, k, v, la, dy = _inputs(case)

    def f(q, k, v, la):
        if bcast:
            q = jnp.broadcast_to(q, q.shape[:2] + (h,) + q.shape[3:])
            k = jnp.broadcast_to(k, k.shape[:2] + (h,) + k.shape[3:])
        y, _ = jrec.chunked_linear_scan(q, k, v, la, chunk=chunk)
        return jnp.sum(y * dy)

    want = jax.grad(f, argnums=(0, 1, 2, 3))(q, k, v, la)
    tq, tk, tv, tla, tdy = (torch.from_numpy(a) for a in (q, k, v, la, dy))
    got = ops.plain_backward(_expand(tq, h), _expand(tk, h), tv, tla, tdy)
    for g, w, nm in zip(got, want, ("dq", "dk", "dv", "dlog_a")):
        if bcast and nm in ("dq", "dk"):
            g = g.sum(2, keepdim=True)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=nm)


@pytest.mark.parametrize("name", CASES)
def test_scan_function_gradients_through_expand(name):
    """``ScanFunction`` (the card's autograd wiring) around the plain scan:
    autograd's expand backward sums dq and dk over the heads."""
    case = CASES[name]
    h, chunk = case[2], case[5]
    q, k, v, la, dy = _inputs(case)
    ql, kl, vl, lal = _leaves((q, k, v, la))
    y = ops.ScanFunction.apply(_expand(ql, h), _expand(kl, h), vl, lal,
                               _plain(chunk))
    got = torch.autograd.grad(y, (ql, kl, vl, lal), torch.from_numpy(dy))
    for g, w in zip(got, _autograd(case)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_plain_backward_counts_no_kernel_launch():
    """Only ``kernel_scan`` counts as a launch; the CPU branch of the
    wrapper differentiates the plain version itself."""
    case = CASES["several chunks"]
    q, k, v, la, dy = _inputs(case)
    ql, kl, vl, lal = _leaves((q, k, v, la))
    ops.reset_counts()
    y = ops.ssm_scan(ql, kl, vl, lal, chunk=case[5])
    torch.autograd.grad(y, (ql, kl, vl, lal), torch.from_numpy(dy))
    assert ops.LAUNCHES == {"ssm_scan": 0, "ssm_scan_backward": 0}
    assert ops.PLAIN_CALLS["ssm_scan"] == 1
    y = ops.ScanFunction.apply(ql, kl, vl, lal, _plain(case[5]))
    torch.autograd.grad(y, (ql, kl, vl, lal), torch.from_numpy(dy))
    assert ops.LAUNCHES["ssm_scan_backward"] == 0


def test_meta_backward_gives_shapes_and_dtypes():
    """On ``meta`` tensors (the dry run) ``ScanFunction``'s backward is
    ``meta_backward``: each gradient in its input's shape and dtype, the
    broadcast q and k summed over the heads by autograd, nothing
    counted."""
    b, s, h, k, v = 2, 96, 4, 8, 16
    q0, k0 = (torch.empty((b, s, 1, k), device="meta", dtype=torch.bfloat16,
                          requires_grad=True) for _ in range(2))
    vv = torch.empty((b, s, h, v), device="meta", dtype=torch.bfloat16,
                     requires_grad=True)
    la = torch.empty((b, s, h), device="meta", requires_grad=True)
    ops.reset_counts()
    y = ops.ssm_scan(q0, k0, vv, la)
    grads = torch.autograd.grad(y, (q0, k0, vv, la), torch.empty_like(y))
    assert [(g.shape, g.dtype, g.device.type) for g in grads] == [
        (t.shape, t.dtype, "meta") for t in (q0, k0, vv, la)]
    assert ops.LAUNCHES == {"ssm_scan": 0, "ssm_scan_backward": 0}


def test_plain_mask_survives_long_chunks_under_autograd():
    """The plain scan's decay mask takes exp of the masked difference, so
    a chunk whose cumulative log decay passes -100 (e^{+100} above the
    diagonal) gives finite gradients, as the reference's values."""
    case = (1, 256, 2, 4, 4, 256, False, "sigmoid")
    q, k, v, la, dy = _inputs(case)
    la = np.full_like(la, -0.8)
    ql, kl, vl, lal = _leaves((q, k, v, la))
    y = chunked_linear_scan(ql, kl, vl, lal, chunk=256)[0]
    want, _ = jrec.chunked_linear_scan(q, k, v, la, chunk=256)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(y, (ql, kl, vl, lal), torch.from_numpy(dy))
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# ------------------------------------------------- kernels with no backward
def test_flash_attention_refuses_autograd_on_cpu():
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 16)).astype(
        np.float32)) for _ in range(3))
    flash_ops.flash_attention(q, k, v)                  # no grad: runs
    with pytest.raises(RuntimeError, match="flash_attention has no "
                       "backward"):
        flash_ops.flash_attention(q.requires_grad_(True), k, v)
    with torch.no_grad():
        flash_ops.flash_attention(q, k, v)


def test_conv_kernels_refuse_autograd_on_cpu():
    """The int8 kernels' operands cannot require grad themselves; a float
    operand that does is refused before anything runs."""
    x = torch.zeros((1, 4, 4, 8), requires_grad=True)
    w = torch.zeros((1, 1, 8, 8), requires_grad=True)
    vec = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="fused_horizontal has no "
                       "backward"):
        conv_ops.fused_horizontal(x, w, vec, vec, vec, stride=(1, 1),
                                  pad=(0, 0))
    with pytest.raises(RuntimeError, match="fused_chain has no backward"):
        conv_ops.fused_chain(x, [w], [vec], [], chain=(), oh=4, ow=4, oc=8)
