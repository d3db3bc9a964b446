"""The port's LM serving path against the JAX package on the same weights
and numpy inputs: configs, layers, ``forward`` under each ``attn_impl``,
``decode_step`` with its cache, the ``serve`` loop's greedy tokens, and the
``lm_bridge`` planner.  JAX weights reach the port through
``carry.lm_params_from_reference``; everything runs in fp32 on the CPU, where
the port's flash wrapper takes its plain version."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import lm_bridge as jbridge
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.nn import attention as jattn
from repro.nn import layers as jlayers
from repro.nn import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch.core import lm_bridge as tbridge
from repro_torch.core.carry import (lm_cache_from_reference,
                                    lm_params_from_reference)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.nn import attention as tattn
from repro_torch.nn import layers as tlayers
from repro_torch.nn import model as tmodel

LM_ARCHS = ["granite-8b", "mixtral-8x7b", "qwen2-vl-7b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch, **kw):
    """The same smoke config from both packages."""
    return (dataclasses.replace(jconfigs.get(arch).smoke(), **kw),
            dataclasses.replace(tconfigs.get(arch).smoke(), **kw))


def _params(jcfg, seed=0):
    jp = japi.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, lm_params_from_reference(jax.tree.map(np.asarray, jp),
                                        device="cpu")


def _np(x):
    return np.asarray(x, np.float32)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_configs_and_smoke_configs_match(arch):
    j, t = jconfigs.get(arch), tconfigs.get(arch)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.smoke()) == dataclasses.asdict(t.smoke())
    assert (j.n_params, j.head_dim) == (t.n_params, t.head_dim)
    assert jconfigs.shapes_for(j) == tconfigs.shapes_for(t)


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_lm_bridge_plans_match(arch):
    j, t = jconfigs.get(arch), tconfigs.get(arch)
    for seq, batch in ((4096, 1), (32768, 4), (524288, 1)):
        assert dataclasses.asdict(jbridge.plan_attention(j, seq, batch)) == \
            dataclasses.asdict(tbridge.plan_attention(t, seq, batch))
        assert jbridge.plan_ssm_chunk(j, seq) == tbridge.plan_ssm_chunk(t, seq)
    assert jbridge.report(j) == tbridge.report(t)


# ------------------------------------------------------------------- layers
def test_layers_match():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    g, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(
        tlayers.layer_norm(tx, torch.from_numpy(g), torch.from_numpy(b)),
        _np(jlayers.layer_norm(x, g, b)), **TOL)
    np.testing.assert_allclose(
        tlayers.rms_norm(tx, torch.from_numpy(g)),
        _np(jlayers.rms_norm(x, g)), **TOL)
    h = rng.standard_normal((2, 8, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 1000, (2, 8)).astype(np.int32)
    pos3 = rng.integers(0, 1000, (3, 2, 8)).astype(np.int32)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(h), torch.from_numpy(pos), 1e7),
        _np(jlayers.apply_rope(h, pos, 1e7)), **TOL)
    np.testing.assert_allclose(
        tlayers.apply_mrope(torch.from_numpy(h), torch.from_numpy(pos3)),
        _np(jlayers.apply_mrope(h, pos3)), **TOL)


@pytest.mark.parametrize("act", ["silu_gated", "gelu"])
def test_mlp_and_moe_match(act):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    dense = {k: (rng.standard_normal(s) * 0.2).astype(np.float32) for k, s in
             (("w1", (32, 48)), ("w3", (32, 48)), ("w2", (48, 32)))}
    moe = {k: (rng.standard_normal(s) * 0.2).astype(np.float32) for k, s in
           (("router", (32, 4)), ("w1", (4, 32, 48)), ("w3", (4, 32, 48)),
            ("w2", (4, 48, 32)))}
    t = lambda p: {k: torch.from_numpy(v) for k, v in p.items()}  # noqa: E731
    np.testing.assert_allclose(tlayers.mlp(torch.from_numpy(x), t(dense), act),
                               _np(jlayers.mlp(x, dense, act)), **TOL)
    got, aux = tlayers.moe_mlp(torch.from_numpy(x), t(moe), act, 2)
    want, jaux = jlayers.moe_mlp(x, moe, act, 2)
    np.testing.assert_allclose(got, _np(want), **TOL)
    assert abs(float(aux) - float(jaux)) < 1e-5


@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_chunked_matches(causal):
    """The Python loop over kv blocks == the reference's ``lax.scan``."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((2, 256, 6, 16), (2, 256, 2, 16), (2, 256, 2, 16)))
    got = tattn.sdpa_chunked(*map(torch.from_numpy, (q, k, v)),
                             causal=causal, blk=64)
    want = jattn.sdpa_chunked(q, k, v, causal=causal, blk=64)
    np.testing.assert_allclose(got, _np(want), rtol=3e-5, atol=3e-5)


# ----------------------------------------------------------------- forward
def _batch(cfg, rng, B=2, S=64):
    toks = rng.integers(0, cfg.vocab, (B, S - cfg.n_patches)).astype(np.int32)
    pe = (rng.standard_normal((B, cfg.n_patches, cfg.d_model))
          .astype(np.float32) if cfg.family == "vlm" else None)
    return toks, pe


@pytest.mark.parametrize("impl", ["flash", "xla", "xla_chunked"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches(arch, impl):
    jcfg, tcfg = _cfgs(arch, attn_impl=impl)
    jp, tp = _params(jcfg)
    toks, pe = _batch(jcfg, np.random.default_rng(0))
    want, jaux = jmodel.forward(jcfg, jp, jnp.asarray(toks),
                                None if pe is None else jnp.asarray(pe))
    flash_ops.reset_counts()
    got, aux = tmodel.forward(tcfg, tp, torch.as_tensor(toks, dtype=torch.long),
                              None if pe is None else torch.from_numpy(pe))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert abs(float(aux) - float(jaux)) < 1e-5
    # the flash path goes through the wrapper once per layer, except where
    # the sliding window sends it to the plain path
    calls = flash_ops.PLAIN_CALLS["flash_attention"]
    assert calls == (tcfg.n_layers if impl == "flash" and not tcfg.window
                     else 0)


def test_prefill_step_matches_flash_model_path():
    """``make_prefill_step`` under ``attn_impl="flash"`` == the reference's,
    as ``test_flash_in_model_path`` drives it."""
    jcfg, tcfg = _cfgs("granite-8b", attn_impl="flash")
    jp, tp = _params(jcfg)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (1, 64))
    want = jserve.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    got = tserve.make_prefill_step(tcfg)(
        tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_init_params_keys_shapes_dtypes_match():
    for arch in LM_ARCHS:
        jcfg, tcfg = _cfgs(arch, dtype="bfloat16")
        jp = jax.tree.map(np.asarray, japi.init_params(jcfg))
        tp = tapi.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
        jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
        tflat = {}
        for k, v in tp.items():
            for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
                tflat[(k, kk) if kk else (k,)] = vv
        assert len(jflat) == len(tflat)
        for path, a in jflat:
            t = tflat[tuple(p.key for p in path)]
            assert tuple(t.shape) == a.shape
            assert str(t.dtype).split(".")[-1] == a.dtype.name
        w = tp["layers"]["wq"].float()
        assert abs(float(w.std()) - 0.02) < 2e-3


def test_bf16_weights_carry_across_bit_equal():
    jcfg, _ = _cfgs("granite-8b", dtype="bfloat16")
    jp = japi.init_params(jcfg)
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp),
                                  device="cpu")
    wq = tp["layers"]["wq"]
    assert wq.dtype == torch.bfloat16
    ref = np.asarray(jp["layers"]["wq"]).view(np.uint16)
    assert np.array_equal(wq.view(torch.int16).numpy().view(np.uint16), ref)
    assert tp["ln_f"].dtype == torch.float32


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("arch,window", [("granite-8b", 0),
                                         ("mixtral-8x7b", 8),
                                         ("qwen2-vl-7b", 0)])
def test_decode_steps_match(arch, window):
    """16 decode steps: logits and cache against the reference.  Mixtral
    with an 8-slot window rolls its cache over, as the reference's
    ``test_swa_decode_rolls_over_window`` does."""
    kw = {"window": window} if window else {}
    jcfg, tcfg = _cfgs(arch, **kw)
    jp, tp = _params(jcfg, seed=3)
    jcache = japi.init_cache(jcfg, 2, 16)
    tcache = tapi.init_cache(tcfg, 2, 16, device="cpu")
    assert tuple(tcache["k"].shape) == jcache["k"].shape
    toks = np.random.default_rng(9).integers(0, jcfg.vocab, (2, 16))
    step = jax.jit(lambda p, c, t, pos: japi.decode_step(jcfg, p, c, t, pos))
    for t in range(16):
        want, jcache = step(jp, jcache, jnp.asarray(toks[:, t], jnp.int32),
                            jnp.int32(t))
        got, tcache = tapi.decode_step(tcfg, tp, tcache,
                                       torch.as_tensor(toks[:, t]), t)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    carried = lm_cache_from_reference(jax.tree.map(np.asarray, jcache),
                                      device="cpu")
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), carried[k].numpy(),
                                   **TOL)


@pytest.mark.parametrize("arch", ["granite-8b", "mixtral-8x7b"])
def test_decode_matches_prefill(arch):
    """Teacher-forced decode logits == the flash prefill's at each
    position, within the port."""
    jcfg, tcfg = _cfgs(arch, attn_impl="flash")
    _, tp = _params(jcfg, seed=5)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, tcfg.vocab, (1, 16)))
    full, _ = tmodel.forward(tcfg, tp, toks)
    cache = tapi.init_cache(tcfg, 1, 16, device="cpu")
    outs = []
    for t in range(16):
        lg, cache = tapi.decode_step(tcfg, tp, cache, toks[:, t], t)
        outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=1e-4,
                               atol=1e-4)


# ----------------------------------------------------------------- serving
def test_serve_loop_tokens_match():
    """The serve loop (prefill-by-decode, then greedy decode) gives the
    reference's ``make_serve_step`` tokens."""
    jcfg, tcfg = _cfgs("granite-8b")
    jp, tp = _params(jcfg, seed=1)
    B, P, G = 2, 8, 8
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab, (B, P))
    serve = jax.jit(jserve.make_serve_step(jcfg))
    cache = japi.init_cache(jcfg, B, P + G)
    for p in range(P - 1):
        _, cache = serve(jp, cache, jnp.asarray(prompt[:, p], jnp.int32),
                         jnp.int32(p))
    tok, want = jnp.asarray(prompt[:, -1], jnp.int32), []
    for p in range(P - 1, P + G - 1):
        tok, cache = serve(jp, cache, tok, jnp.int32(p))
        want.append(np.asarray(tok))
    got = tserve.serve_loop(tcfg, tp, prompt, G, device="cpu")
    assert got["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], np.stack(want, 1))


def test_serve_main_smoke_on_cpu(capsys):
    res = tserve.main(["--arch", "granite-8b", "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "4", "--gen-len", "3"])
    assert res["tokens"].shape == (2, 3)
    assert "generated 3 steps x 2 seqs" in capsys.readouterr().out
