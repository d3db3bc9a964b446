"""The port's Seamless (``audio`` family, ``nn.encdec``) against the JAX
package on the same weights and numpy inputs: ``encode``,
``decode_train``, ``loss_fn``, ``init_cache``, ``decode_step``,
``make_prefill_step`` and ``models.api``'s Seamless entries, then
``serve.main`` at smoke size.  JAX weights reach the port through
``carry.lm_params_from_reference``; fp32 on the CPU, at 1e-4 (the LM
slices' tolerance).  Seamless runs no kernel: attention stays ``xla``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.nn import encdec as jenc
from repro_torch import configs as tconfigs
from repro_torch.configs.base import SHAPES as TSHAPES
from repro_torch.core.carry import (lm_cache_from_reference,
                                    lm_params_from_reference)
from repro_torch.kernels.conv_fused import ops as conv_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi
from repro_torch.nn import encdec as tenc

ARCH = "seamless-m4t-large-v2"
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(**kw):
    return (dataclasses.replace(jconfigs.get(ARCH).smoke(), **kw),
            dataclasses.replace(tconfigs.get(ARCH).smoke(), **kw))


def _params(jcfg, seed=0):
    jp = japi.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, lm_params_from_reference(jax.tree.map(np.asarray, jp),
                                        device="cpu")


def _batch(cfg, b=2, se=24, sd=12, seed=0):
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((b, se, cfg.d_model)).astype(
                np.float32),
            "tokens": rng.integers(0, cfg.vocab, (b, sd)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (b, sd)).astype(np.int32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(x):
    return np.asarray(x, np.float32)


def test_family_is_served():
    jcfg, tcfg = _cfgs()
    assert tapi._mod(tcfg) is tenc
    jp, tp = _params(jcfg)
    assert jax.tree.structure(jp) == jax.tree.structure(
        jax.tree.map(lambda _: 0, {k: v for k, v in tp.items()}))
    tp2 = tapi.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(
            jax.tree.map(lambda t: t, tp2))):
        assert a.shape == tuple(b.shape) and str(a.dtype) == str(
            b.dtype).removeprefix("torch.")


@pytest.mark.parametrize("remat", [False, True])
def test_encode_and_decode_train_match(remat):
    jcfg, tcfg = _cfgs(remat=remat)
    jp, tp = _params(jcfg)
    b = _batch(jcfg)
    je = jenc.encode(jcfg, jp, jnp.asarray(b["frames"]))
    te = tenc.encode(tcfg, tp, torch.from_numpy(b["frames"]))
    np.testing.assert_allclose(te.numpy(), _np(je), **TOL)
    jl = jenc.decode_train(jcfg, jp, je, jnp.asarray(b["tokens"]))
    tl = tenc.decode_train(tcfg, tp, te, torch.from_numpy(b["tokens"]))
    assert tuple(tl.shape) == (2, 12, tcfg.vocab)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)


def test_prefill_step_matches_and_runs_no_kernel():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    b = _batch(jcfg, se=40, sd=8)
    want = jserve.make_prefill_step(jcfg)(jp, jax.tree.map(jnp.asarray, b))
    for mod in (conv_ops, flash_ops, scan_ops):
        mod.reset_counts()
    got = tserve.make_prefill_step(tcfg)(tp, _t(b))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    for mod in (conv_ops, flash_ops, scan_ops):
        assert not any(mod.PLAIN_CALLS.values())
        assert not any(mod.LAUNCHES.values())


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match(remat):
    """``loss_fn`` and its gradient leaf by leaf against
    ``jax.value_and_grad``, with remat off and on (the values may not
    change with it)."""
    jcfg, tcfg = _cfgs(remat=remat)
    jp, tp = _params(jcfg)
    b = _batch(jcfg)
    jv, jg = jax.value_and_grad(lambda p: japi.loss_fn(
        jcfg, p, jax.tree.map(jnp.asarray, b)))(jp)
    flat, tree = jax.tree.flatten(tp)
    leaves = [t.clone().requires_grad_(True) for t in flat]
    tv = tapi.loss_fn(tcfg, jax.tree.unflatten(tree, leaves), _t(b))
    grads = torch.autograd.grad(tv, leaves)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    for g, w in zip(grads, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-4, atol=2e-6)


def test_init_cache_matches():
    jcfg, tcfg = _cfgs()
    jc = japi.init_cache(jcfg, 2, 16)
    tc = tapi.init_cache(tcfg, 2, 16, "cpu")
    assert set(jc) == set(tc) == {"k", "v", "xk", "xv"}
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape
        assert not tc[k].any()
    assert tc["xk"].shape[2] == tapi.SEAMLESS_DECODE_ENC_LEN
    ac = tapi.abstract_cache(tcfg, 2, 16)
    assert all(t.device.type == "meta" and t.shape == tc[k].shape
               for k, t in ac.items())


def test_decode_steps_match_with_encoder_cache():
    """Teacher-forced ``decode_step`` from a cache whose cross K/V come
    from the encoder output: each step's logits equal the reference's from
    the same cache, and the whole equals ``decode_train``."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    b = _batch(jcfg, se=20, sd=10)
    te = tenc.encode(tcfg, tp, torch.from_numpy(b["frames"]))
    full = tenc.decode_train(tcfg, tp, te, torch.from_numpy(b["tokens"]))
    cache = tenc.init_cache(tcfg, 2, 10, 20, "cpu", enc_out=te, params=tp)
    jcache = jenc.init_cache(jcfg, 2, 10, 20)
    jcache = {**jcache, "xk": jnp.asarray(cache["xk"].numpy()),
              "xv": jnp.asarray(cache["xv"].numpy())}
    got = []
    for t in range(10):
        tok = b["tokens"][:, t]
        jl, jcache = japi.decode_step(jcfg, jp, jcache, jnp.asarray(tok), t)
        tl, cache = tapi.decode_step(tcfg, tp, cache, torch.from_numpy(tok),
                                     t)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
        got.append(tl)
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-4)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), _np(jcache[k]), **TOL)


def test_decode_from_carried_cache_matches():
    """A reference cache (zero cross K/V of 4096 frames, as ``init_cache``
    makes it) carried across mid-sequence continues identically."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab, (2, 6)).astype(np.int32)
    jcache = japi.init_cache(jcfg, 2, 8)
    for t in range(3):
        _, jcache = japi.decode_step(jcfg, jp, jcache, jnp.asarray(toks[:, t]),
                                     t)
    cache = lm_cache_from_reference(jax.tree.map(np.asarray, jcache), "cpu")
    for t in range(3, 6):
        jl, jcache = japi.decode_step(jcfg, jp, jcache, jnp.asarray(toks[:, t]),
                                      t)
        tl, cache = tapi.decode_step(tcfg, tp, cache,
                                     torch.from_numpy(toks[:, t]), t)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)


def test_input_specs_and_abstract_params_match():
    jcfg, tcfg = _cfgs()
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        js = japi.input_specs(jcfg, JSHAPES[shape])
        ts = tapi.input_specs(tcfg, TSHAPES[shape])
        assert set(js) == set(ts)
        for k in js:
            assert ts[k].device.type == "meta"
            assert tuple(ts[k].shape) == js[k].shape
            assert str(ts[k].dtype).removeprefix("torch.") == str(
                js[k].dtype)
    ja = japi.abstract_params(jcfg)
    ta = tapi.abstract_params(tcfg)
    for a, b in zip(jax.tree.leaves(ja), jax.tree.leaves(ta)):
        assert b.device.type == "meta" and tuple(b.shape) == a.shape


def test_serve_loop_tokens_match():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(0)
    B, P, G = 2, 5, 4
    prompt = rng.integers(0, jcfg.vocab, (B, P)).astype(np.int32)
    cache = japi.init_cache(jcfg, B, P + G)
    serve = jserve.make_serve_step(jcfg)
    for p in range(P - 1):
        _, cache = serve(jp, cache, jnp.asarray(prompt[:, p]), jnp.int32(p))
    tok, want = jnp.asarray(prompt[:, -1]), []
    for p in range(P - 1, P + G - 1):
        tok, cache = serve(jp, cache, tok, jnp.int32(p))
        want.append(np.asarray(tok))
    got = tserve.serve_loop(tcfg, tp, prompt, G, device="cpu")
    np.testing.assert_array_equal(got["tokens"], np.stack(want, 1))


def test_serve_main_smoke_on_cpu(capsys):
    res = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "4", "--gen-len", "3"])
    assert res["tokens"].shape == (2, 3)
    assert "generated 3 steps x 2 seqs" in capsys.readouterr().out
