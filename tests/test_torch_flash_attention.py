"""The port's flash attention against the JAX package's Pallas kernel (in
interpret mode) on the same numpy inputs.  On the CPU the port's wrapper
takes its plain version.  On the card the CUDA kernel is held against that
plain version in fp32, and in bf16 and fp16 against ``attention_fp32``, whose
match with the Pallas kernel's bf16 numerics is checked here
(``test_torch_cuda.py``, ``chip_smoke.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import ops
from repro_torch.nn import attention as tattn

# (b, sq, sk, h, kv, d, blk, offset): the JAX package's own CASES
# (tests/test_kernels_flash.py) plus SmolLM-360M's 15:5 grouping
CASES = [
    (1, 64, 64, 2, 2, 16, 16, 0),       # MHA
    (1, 64, 64, 4, 2, 16, 16, 0),       # GQA 2:1
    (2, 32, 32, 6, 2, 8, 8, 0),         # GQA 3:1
    (1, 16, 64, 2, 1, 16, 16, 48),      # q_offset (chunked prefill tail)
    (1, 128, 128, 2, 2, 32, 32, 0),     # more blocks
    (1, 32, 32, 15, 5, 64, 16, 0),      # SmolLM-360M 15:5, head_dim 64
]


def _qkv(rng, b, sq, sk, h, kv, d):
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, kv, d)).astype(np.float32),
            rng.standard_normal((b, sk, kv, d)).astype(np.float32))


def _both(arrays, dtype):
    """The same numpy inputs as JAX arrays and as CPU tensors of
    ``dtype`` (both round float32 to bf16 to nearest even)."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(dtype) for a in arrays])


@pytest.mark.parametrize("b,sq,sk,h,kv,d,blk,off", CASES)
def test_plain_matches_pallas_fp32(b, sq, sk, h, kv, d, blk, off):
    rng = np.random.default_rng(sq + h)
    (jq, jk, jv), (q, k, v) = _both(_qkv(rng, b, sq, sk, h, kv, d),
                                    torch.float32)
    want = jax_flash(jq, jk, jv, q_offset=off, blk_q=blk, blk_k=blk)
    ops.reset_counts()
    got = ops.flash_attention(q, k, v, q_offset=off)
    assert ops.PLAIN_CALLS["flash_attention"] == 1
    assert ops.LAUNCHES["flash_attention"] == 0
    assert got.shape == (b, sq, h, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_plain_matches_pallas_noncausal():
    rng = np.random.default_rng(9)
    (jq, jk, jv), (q, k, v) = _both(_qkv(rng, 1, 32, 64, 2, 2, 16),
                                    torch.float32)
    want = jax_flash(jq, jk, jv, causal=False, blk_q=16, blk_k=16)
    got = ops.flash_attention(q, k, v, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("h,kv,d", [(2, 2, 16), (15, 5, 64)])
def test_plain_matches_pallas_bf16(h, kv, d):
    """bf16 at the JAX package's own tolerance (5e-2): the Pallas kernel
    scales q in bf16 and keeps fp32 weights, the plain version rounds the
    scores and the softmax weights to bf16."""
    rng = np.random.default_rng(7)
    (jq, jk, jv), (q, k, v) = _both(_qkv(rng, 1, 64, 64, h, kv, d),
                                    torch.bfloat16)
    want = jax_flash(jq, jk, jv, blk_q=16, blk_k=16).astype(jnp.float32)
    got = ops.flash_attention(q, k, v)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=0.05, atol=0.05)


@pytest.mark.parametrize("b,sq,sk,h,kv,d,blk,off", CASES)
def test_fp32_oracle_matches_pallas_bf16(b, sq, sk, h, kv, d, blk, off):
    """``attention_fp32`` (the CUDA kernel's arithmetic, against which the
    card checks it) rounded to bf16 is the Pallas kernel's bf16 output to
    within ``OUT_REL_TOL``: both scale q in bf16 and keep fp32 weights."""
    rng = np.random.default_rng(sq + h + 1)
    (jq, jk, jv), (q, k, v) = _both(_qkv(rng, b, sq, sk, h, kv, d),
                                    torch.bfloat16)
    want = jax_flash(jq, jk, jv, q_offset=off, blk_q=blk, blk_k=blk)
    got = ops.attention_fp32(q, k, v, q_offset=off)
    assert got.dtype == torch.float32
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert ops.row_rel_err(got.to(torch.bfloat16), want) \
        <= ops.OUT_REL_TOL[torch.bfloat16]
    assert ops.row_rel_err(got, want) <= ops.OUT_REL_TOL[torch.bfloat16] / 2


def test_row_rel_err_catches_a_dropped_key_tile():
    """The card's bf16 limit is far below what one skipped 64-key tile of
    2048 keys does to a row (the fault a loose absolute limit let pass)."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(rng, 1, 64, 2048, 4, 1, 128))
    want = ops.attention_fp32(q, k, v, causal=False)
    keep = torch.cat([torch.arange(1024), torch.arange(1088, 2048)])
    bad = ops.attention_fp32(q, k[:, keep], v[:, keep], causal=False)
    tol = ops.OUT_REL_TOL[torch.bfloat16]
    assert ops.row_rel_err(want.to(torch.bfloat16), want) <= tol
    assert ops.row_rel_err(bad.to(torch.bfloat16), want) > 10 * tol


def test_gqa_head_order():
    """Query head h reads kv head h // g: with every kv head's values a
    constant of its own, each output head is that constant."""
    b, s, h, kv, d = 1, 16, 6, 2, 16
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, kv, d)).astype(np.float32))
    v = torch.arange(kv, dtype=torch.float32)[None, None, :, None].expand(
        b, s, kv, d).contiguous()
    out = ops.flash_attention(q, k, v)
    want = (torch.arange(h) // (h // kv)).float()
    assert torch.allclose(out[0, :, :, 0], want.expand(s, h), atol=1e-6)


def test_wrapper_checks_its_arguments():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="query heads"):
        ops.flash_attention(q, torch.zeros(1, 8, 3, 16),
                            torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError, match="dtypes differ"):
        ops.flash_attention(q, torch.zeros(1, 8, 2, 16, dtype=torch.float64),
                            torch.zeros(1, 8, 2, 16))
    with pytest.raises(ValueError, match="do not match"):
        ops.flash_attention(q, torch.zeros(1, 8, 2, 16),
                            torch.zeros(1, 8, 2, 32))
    meta = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="runs on CUDA or the CPU"):
        ops.flash_attention(q.to("meta"), meta, meta)


def test_aligned_copies_only_what_the_kernel_cannot_read():
    t = torch.zeros(2, 8, 4, 16)
    assert ops._aligned(t) is t
    head_slice = t[:, :, :2]                            # a view, still aligned
    assert ops._aligned(head_slice) is head_slice
    odd = torch.zeros(2, 8, 4, 18)[..., :16]           # strides not a multiple of 8
    fixed = ops._aligned(odd)
    assert fixed is not odd and fixed.is_contiguous()
    shifted = torch.zeros(2 * 8 * 4 * 16 + 1)[1:].view(2, 8, 4, 16)
    assert ops._aligned(shifted).data_ptr() % 16 == 0


def test_sdpa_routes_only_causal_windowless_calls_to_flash():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 32, 32, 4, 2, 16))
    ops.reset_counts()
    flash = tattn.sdpa(q, k, v, impl="flash")
    assert ops.PLAIN_CALLS["flash_attention"] == 1
    for kw in ({"window": 8}, {"causal": False},
               {"kv_len_mask": torch.ones(1, 32, dtype=torch.bool)}):
        tattn.sdpa(q, k, v, impl="flash", **kw)
    assert ops.PLAIN_CALLS["flash_attention"] == 1
    plain = tattn.sdpa(q, k, v, impl="xla")
    torch.testing.assert_close(flash, plain, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,sq,sk,h,kv,off,causal", [
    (4, 2048, 2048, 32, 8, 0, True),     # Granite-8B prefill, g = 4
    (1, 200, 333, 15, 5, 0, True),       # SmolLM-360M's g = 3, ragged
    (2, 129, 257, 8, 8, 0, True),        # MHA, g = 1, ragged
    (1, 200, 333, 15, 5, 100, True),     # q_offset, g = 3
    (4, 128, 2048, 32, 8, 1920, True),   # Granite's q_offset tail
    (1, 100, 300, 6, 2, 0, False),       # non-causal, g = 3
])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128),
                                     (torch.float16, 64),
                                     (torch.float32, 128)])
def test_tile_plan_covers_every_row_once(b, sq, sk, h, kv, off, causal,
                                         dtype, d):
    """The launcher's plan for either kernel: every (position, head) row
    of a kv head lies in exactly one row tile and is stored once, spare
    rows of the last tile are not, tiles go heaviest first, and each tile
    walks exactly the kv tiles its rows need (all keys up to its last
    position under the causal mask, no tile wholly above it)."""
    plan = ops.tile_plan(b, sq, sk, h, kv, d, dtype, off, causal)
    tc = dtype != torch.float32
    assert plan["kernel"] == ("wgmma" if tc else "cuda_core")
    bm, bn, g = plan["bm"], plan["bn"], plan["g"]
    assert (bm, bn) == (ops.TC_TILE if tc else ops.FP32_TILE)
    assert plan["items"] == (len(plan["tiles"]), b * kv)
    stored = {}
    for r0, last in plan["tiles"]:
        rows = [r for r in range(r0, r0 + bm) if r < sq * g]
        for r in rows:
            key = (r // g, r % g)               # (position, head in group)
            stored[key] = stored.get(key, 0) + 1
        need = (min(sk, (rows[-1] // g) + off + 1) if causal else sk)
        assert (last - 1) * bn < need <= last * bn
    assert sorted(stored) == [(p, j) for p in range(sq) for j in range(g)]
    assert set(stored.values()) == {1}
    starts = [r0 for r0, _ in plan["tiles"]]
    assert starts == sorted(starts, reverse=True)
