"""The port's recurrent LM families, xLSTM (``ssm``) and Zamba2
(``hybrid``), against the JAX package on the same weights and numpy inputs:
``forward`` (through ``make_prefill_step``), ``decode_step`` with its
cache, the ``serve`` loop's greedy tokens, and the cache carried across
mid-sequence.  JAX weights reach the port through
``carry.lm_params_from_reference``; everything runs in fp32 on the CPU,
where the scan wrapper takes its plain version."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import api as japi
from repro_torch import configs as tconfigs
from repro_torch.core.carry import (lm_cache_from_reference,
                                    lm_params_from_reference)
from repro_torch.kernels.ssm_scan import ops as scan_ops
from repro_torch.launch import serve as tserve
from repro_torch.models import api as tapi

ARCHS = ["xlstm-1.3b", "zamba2-1.2b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch, **kw):
    """The same smoke config from both packages."""
    return (dataclasses.replace(jconfigs.get(arch).smoke(), **kw),
            dataclasses.replace(tconfigs.get(arch).smoke(), **kw))


def _params(jcfg, seed=0):
    jp = japi.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, lm_params_from_reference(jax.tree.map(np.asarray, jp),
                                        device="cpu")


def _scans(cfg) -> int:
    """Layers that run the chunked scan: the mLSTM blocks of xLSTM, every
    Mamba2 layer of Zamba2."""
    if cfg.family == "ssm":
        return cfg.n_layers - cfg.n_layers // cfg.slstm_every
    return cfg.n_layers


def _np(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("seq", [48, 256])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches(arch, seq):
    """``make_prefill_step`` == the reference's, one scan per recurrent
    layer; 48 steps run as one chunk of 48 (128 does not divide it), 256 as
    two chunks of 128."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg)
    toks = np.random.default_rng(seq).integers(0, jcfg.vocab, (2, seq))
    want = jserve.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(toks)})
    scan_ops.reset_counts()
    got = tserve.make_prefill_step(tcfg)(tp, {"tokens": torch.as_tensor(toks)})
    assert got.shape == (2, seq, tcfg.vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert scan_ops.PLAIN_CALLS["ssm_scan"] == _scans(tcfg)
    assert scan_ops.LAUNCHES["ssm_scan"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_keys_shapes_dtypes_match(arch):
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
    w = tp["embed"].float()
    assert abs(float(w.std()) - 0.02) < 2e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match(arch):
    """12 decode steps: logits and every cache entry against the
    reference."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, seed=3)
    jcache = japi.init_cache(jcfg, 2, 12)
    tcache = tapi.init_cache(tcfg, 2, 12, device="cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    toks = np.random.default_rng(9).integers(0, jcfg.vocab, (2, 12))
    step = jax.jit(lambda p, c, t, pos: japi.decode_step(jcfg, p, c, t, pos))
    for t in range(12):
        want, jcache = step(jp, jcache, jnp.asarray(toks[:, t], jnp.int32),
                            jnp.int32(t))
        got, tcache = tapi.decode_step(tcfg, tp, tcache,
                                       torch.as_tensor(toks[:, t]), t)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    carried = lm_cache_from_reference(jax.tree.map(np.asarray, jcache),
                                      device="cpu")
    assert carried.keys() == tcache.keys()
    for k in carried:
        np.testing.assert_allclose(tcache[k].numpy(), carried[k].numpy(),
                                   **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """Teacher-forced decode logits == the prefill's at each position,
    within the port."""
    _, tcfg = _cfgs(arch)
    _, tp = _params(_cfgs(arch)[0], seed=5)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, tcfg.vocab, (2, 24)))
    full = tserve.make_prefill_step(tcfg)(tp, {"tokens": toks})
    cache = tapi.init_cache(tcfg, 2, 24, device="cpu")
    outs = []
    for t in range(24):
        lg, cache = tapi.decode_step(tcfg, tp, cache, toks[:, t], t)
        outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, 1), full, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_carried_across_continues_the_reference(arch):
    """The reference decodes 6 tokens; its cache, carried to the port,
    decodes the next 6 as the reference does."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _params(jcfg, seed=7)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 12))
    jcache = japi.init_cache(jcfg, 2, 12)
    step = jax.jit(lambda p, c, t, pos: japi.decode_step(jcfg, p, c, t, pos))
    for t in range(6):
        _, jcache = step(jp, jcache, jnp.asarray(toks[:, t], jnp.int32),
                         jnp.int32(t))
    tcache = lm_cache_from_reference(jax.tree.map(np.asarray, jcache),
                                     device="cpu")
    for t in range(6, 12):
        want, jcache = step(jp, jcache, jnp.asarray(toks[:, t], jnp.int32),
                            jnp.int32(t))
        got, tcache = tapi.decode_step(tcfg, tp, tcache,
                                       torch.as_tensor(toks[:, t]), t)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_loop_tokens_match(arch):
    """The serve loop (prefill-by-decode, then greedy decode) gives the
    reference's ``make_serve_step`` tokens."""
    jcfg, tcfg = _cfgs(arch)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_smoke_on_cpu(arch, capsys):
    res = tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "4", "--gen-len", "3"])
    assert res["tokens"].shape == (2, 3)
    assert "generated 3 steps x 2 seqs" in capsys.readouterr().out
