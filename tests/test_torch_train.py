"""The port's training path against the JAX package on the same numpy
inputs: every family's ``loss_fn`` and its gradients (remat on and off),
AdamW, int8 error feedback, the synthetic data pipeline, and
``make_train_step`` from a carried state; then the reference's own
training checks (accumulation, a decreasing loss) on the port alone, and
the multi-device pieces that raise until their slice.  fp32 smoke configs
on the CPU; tolerances beside each check."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data.pipeline import SyntheticLM as JData
from repro.launch import train as jtrain
from repro.models import api as japi
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch import configs as tconfigs
from repro_torch.core.carry import (lm_params_from_reference,
                                    train_state_from_reference)
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import SyntheticLM as TData
from repro_torch.launch import train as ttrain
from repro_torch.models import api as tapi
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress

# one architecture per family
FAMILIES = {"dense": "smollm-360m", "moe": "mixtral-8x7b",
            "vlm": "qwen2-vl-7b", "ssm": "xlstm-1.3b",
            "hybrid": "zamba2-1.2b", "audio": "seamless-m4t-large-v2"}


def _cfgs(arch, **kw):
    """The same smoke config from both packages, cut to 2 layers (Zamba2:
    2 Mamba2 layers, the shared block after each)."""
    kw.setdefault("n_layers", 2)
    if arch == "zamba2-1.2b":
        kw.setdefault("shared_attn_every", 1)
    return (dataclasses.replace(jconfigs.get(arch).smoke(), **kw),
            dataclasses.replace(tconfigs.get(arch).smoke(), **kw))


def _data(cfg, pkg, batch=2, seq=32, **kw):
    cls = JData if pkg == "jax" else TData
    extra = {} if pkg == "jax" else {"device": "cpu"}
    return cls(vocab=cfg.vocab, batch=batch, seq=seq, family=cfg.family,
               d_model=cfg.d_model, n_patches=cfg.n_patches, **kw, **extra)


def _np(x):
    return np.asarray(x, np.float32)


def _torch_grads(cfg, params, batch):
    flat = [p.clone().requires_grad_(True) for p in leaves(params)]
    from repro_torch.core.tree import unflatten

    loss = tapi.loss_fn(cfg, unflatten(params, flat), batch)
    return loss.detach(), torch.autograd.grad(loss, flat)


# ------------------------------------------------------------- loss + grads
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("family", FAMILIES)
def test_loss_and_grads_match_value_and_grad(family, remat):
    """Loss at 1e-5 relative and each gradient leaf at 1e-4 relative, 2e-6
    absolute (fp32 sums in another order) against ``jax.value_and_grad``;
    remat ("dots" for the transformer families, whole blocks for the
    others) changes no value."""
    jcfg, tcfg = _cfgs(FAMILIES[family], remat=remat)
    jp = japi.init_params(jcfg, jax.random.PRNGKey(0))
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    jb = _data(jcfg, "jax").next()
    tb = _data(tcfg, "torch").next()
    jv, jg = jax.value_and_grad(lambda p: japi.loss_fn(jcfg, p, jb))(jp)
    tv, tg = _torch_grads(tcfg, tp, tb)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-5)
    assert len(tg) == len(jax.tree.leaves(jg))
    for g, w in zip(tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=1e-4, atol=2e-6)


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_remat_keeps_values(family):
    """Remat on and off give the same loss and gradients bit for bit on
    the CPU (the recompute repeats the same operations)."""
    _, off = _cfgs(FAMILIES[family], remat=False)
    on = dataclasses.replace(off, remat=True)
    params = tapi.init_params(off, torch.Generator().manual_seed(0), "cpu")
    batch = _data(off, "torch").next()
    l0, g0 = _torch_grads(off, params, batch)
    l1, g1 = _torch_grads(on, params, batch)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


# ---------------------------------------------------------------- optimizer
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(moment_dtype):
    """Three updates, the warmup included, from the same params, grads
    and moments: params and moments within 1e-6 (fp32 moments) or one bf16
    rounding (bf16 moments), the int32 step exact."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((8, 16)).astype(np.float32),
              "n": {"g": np.ones(16, np.float32)}}
    jcfg = jadamw.AdamWConfig(lr=1e-2, warmup_steps=4,
                              moment_dtype=moment_dtype)
    tcfg = tadamw.AdamWConfig(lr=1e-2, warmup_steps=4,
                              moment_dtype=moment_dtype)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    jo, to = jadamw.adamw_init(jp, jcfg), tadamw.adamw_init(tp, tcfg)
    atol = 1e-6 if moment_dtype == "float32" else 2 ** -8
    for _ in range(3):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), params)
        jp, jo = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, grads),
                                     jo, jcfg)
        tp, to = tadamw.adamw_update(tp, jax.tree.map(torch.from_numpy,
                                                      grads), to, tcfg)
        for a, b in zip(jax.tree.leaves(jp), leaves(tp)):
            np.testing.assert_allclose(b.numpy(), _np(a), rtol=1e-5,
                                       atol=1e-6)
        for key in ("m", "v"):
            for a, b in zip(jax.tree.leaves(jo[key]), leaves(to[key])):
                assert str(b.dtype) == f"torch.{moment_dtype}"
                np.testing.assert_allclose(b.float().numpy(), _np(a),
                                           rtol=atol, atol=1e-6)
        assert to["step"].dtype == torch.int32
        assert int(to["step"]) == int(jo["step"])


def test_quantize_ef_matches_reference():
    """Dequantized grads and errors equal the reference's (fp32, 1e-6),
    and the error feedback's identities hold as in the reference's test."""
    rng = np.random.default_rng(0)
    g = {"w": rng.standard_normal((32, 32)).astype(np.float32),
         "b": {"x": rng.standard_normal(7).astype(np.float32)}}
    jerr = jcompress.init_error(jax.tree.map(jnp.asarray, g))
    terr = tcompress.init_error(jax.tree.map(torch.from_numpy, g))
    for _ in range(2):
        jdeq, jerr = jcompress.quantize_ef(jax.tree.map(jnp.asarray, g), jerr)
        tdeq, terr = tcompress.quantize_ef(jax.tree.map(torch.from_numpy, g),
                                           terr)
        for a, b in zip(jax.tree.leaves((jdeq, jerr)),
                        leaves({"d": tdeq, "e": terr})):
            np.testing.assert_allclose(b.numpy(), _np(a), rtol=1e-6,
                                       atol=1e-6)
    w = torch.from_numpy(g["w"])
    d1, e1 = tcompress.quantize_ef({"w": w}, tcompress.init_error({"w": w}))
    torch.testing.assert_close(d1["w"] + e1["w"], w, rtol=1e-6, atol=1e-6)
    d2, e2 = tcompress.quantize_ef({"w": w}, e1)
    torch.testing.assert_close(d1["w"] + d2["w"], 2 * w - e2["w"], rtol=1e-5,
                               atol=1e-5)
    assert float(e2["w"].abs().max()) <= 1.5 * float(w.abs().max()) / 127


def test_compressed_psum_and_late_sync_raise():
    """The late sync and compression need a mesh (their multi-rank runs are
    in test_torch_multidevice.py); without one they raise."""
    cfg = tconfigs.get("smollm-360m").smoke()
    with pytest.raises(ValueError, match="need the mesh"):
        ttrain.make_train_step(cfg, grad_sync="late")
    with pytest.raises(ValueError, match="need the mesh"):
        ttrain.make_train_step(cfg, compress=True)
    with pytest.raises(ValueError, match="unknown grad_sync"):
        ttrain.make_train_step(cfg, grad_sync="early")


# --------------------------------------------------------------------- data
@pytest.mark.parametrize("family", FAMILIES)
def test_synthetic_batches_equal_reference(family):
    jcfg, tcfg = _cfgs(FAMILIES[family])
    jd, td = _data(jcfg, "jax", batch=4), _data(tcfg, "torch", batch=4)
    for _ in range(2):
        jb, tb = jd.next(), td.next()
        assert set(jb) == set(tb)
        for k in jb:
            assert str(tb[k].dtype).removeprefix("torch.") == str(jb[k].dtype)
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    assert td.state() == jd.state()


def test_synthetic_seek_and_host_sharding():
    d1 = TData(vocab=100, batch=4, seq=16, device="cpu")
    d2 = TData(vocab=100, batch=4, seq=16, device="cpu")
    a = [d1.next() for _ in range(3)]
    d2.seek(2)
    assert torch.equal(a[2]["tokens"], d2.next()["tokens"])
    h0 = TData(vocab=100, batch=8, seq=16, host_index=0, host_count=2,
               device="cpu")
    h1 = TData(vocab=100, batch=8, seq=16, host_index=1, host_count=2,
               device="cpu")
    j1 = JData(vocab=100, batch=8, seq=16, host_index=1, host_count=2)
    b0, b1 = h0.next(), h1.next()
    assert tuple(b0["tokens"].shape) == (4, 16)
    assert not torch.equal(b0["tokens"], b1["tokens"])
    np.testing.assert_array_equal(b1["tokens"].numpy(),
                                  np.asarray(j1.next()["tokens"]))
    with pytest.raises(ValueError, match="does not split"):
        TData(vocab=100, batch=5, seq=16, host_count=2, device="cpu")


# --------------------------------------------------------------- train step
@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("family", ["dense", "hybrid", "audio"])
def test_train_step_from_carried_state_matches(family, grad_accum):
    """One step from the reference's state carried across: loss and grad
    norm at 1e-5 relative, the moments at 1e-5 relative / 1e-6 absolute
    (m and v are 0.1 g and 0.05 g^2), the step exact.  The params at 1e-3
    lr, except where |g| < 1e-6: a first Adam step moves a weight by lr g /
    sqrt(g^2 + eps^2), lr itself where |g| >> eps = 1e-8 but a share of lr
    that follows g's fp32 noise where g is within that noise of zero (one
    element in 10^4 to 10^5 moves up to 8% of lr apart); those may differ
    by 2 lr."""
    jcfg, tcfg = _cfgs(FAMILIES[family])
    ocfg = dict(lr=1e-3, warmup_steps=2, moment_dtype="float32")
    js = jtrain.init_state(jcfg, jadamw.AdamWConfig(**ocfg))
    ts = train_state_from_reference(jax.tree.map(np.asarray, js), "cpu")
    jb = _data(jcfg, "jax", batch=4).next()
    tb = _data(tcfg, "torch", batch=4).next()
    js2, jm = jtrain.make_train_step(jcfg, jadamw.AdamWConfig(**ocfg),
                                     grad_accum=grad_accum)(js, jb)
    ts2, tm = ttrain.make_train_step(tcfg, tadamw.AdamWConfig(**ocfg),
                                     grad_accum=grad_accum)(ts, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    assert int(tm["step"]) == int(jm["step"]) == 1
    assert len(leaves(ts2)) == len(jax.tree.leaves(js2))
    for key in ("m", "v"):
        for a, b in zip(jax.tree.leaves(js2["opt"][key]),
                        leaves(ts2["opt"][key])):
            np.testing.assert_allclose(b.numpy(), _np(a), rtol=1e-5,
                                       atol=1e-6)
    lr = ocfg["lr"]
    for a, b, v in zip(jax.tree.leaves(js2["params"]), leaves(ts2["params"]),
                       jax.tree.leaves(js2["opt"]["v"])):
        g_abs = np.sqrt(_np(v) / (1 - 0.95))
        tol = np.where(g_abs < 1e-6, 2 * lr, 1e-3 * lr) + 1e-5 * np.abs(_np(a))
        assert (np.abs(b.numpy() - _np(a)) <= tol).all(), \
            float(np.abs(b.numpy() - _np(a)).max())


CFG = dataclasses.replace(tconfigs.get("smollm-360m").smoke(), n_layers=2)


def test_grad_accum_equivalent():
    """ga=4 over batch 8 == ga=1 on the same batch (fp32 accumulation), at
    the reference test's tolerances."""
    batch = TData(vocab=CFG.vocab, batch=8, seq=64, device="cpu").next()
    state = ttrain.init_state(CFG, device="cpu")
    s1 = ttrain.make_train_step(CFG, grad_accum=1)(state, batch)
    s4 = ttrain.make_train_step(CFG, grad_accum=4)(state, batch)
    assert abs(float(s1[1]["loss"]) - float(s4[1]["loss"])) < 1e-4
    for a, b in zip(leaves(s1[0]["params"]), leaves(s4[0]["params"])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   rtol=2e-3, atol=2e-4)


def test_loss_decreases():
    data = TData(vocab=CFG.vocab, batch=4, seq=64, device="cpu")
    state = ttrain.init_state(CFG, device="cpu")
    step = ttrain.make_train_step(CFG, tadamw.AdamWConfig(lr=3e-3,
                                                          warmup_steps=5))
    losses = []
    for _ in range(30):
        state, m = step(state, data.next())
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, \
        losses[:3] + losses[-3:]


def test_abstract_and_real_state_agree():
    cfg = tconfigs.get("zamba2-1.2b").smoke()
    abstract = ttrain.abstract_state(cfg)
    real = ttrain.init_state(cfg, device="cpu")
    ja = jtrain.abstract_state(jconfigs.get("zamba2-1.2b").smoke())
    pairs = list(zip(leaves(abstract), leaves(real), jax.tree.leaves(ja)))
    assert len(pairs) == len(jax.tree.leaves(ja))
    for a, r, j in pairs:
        assert a.device.type == "meta"
        assert a.shape == r.shape and a.dtype == r.dtype
        assert tuple(a.shape) == j.shape
    assert real["opt"]["m"]["embed"].dtype == torch.bfloat16
    assert real["opt"]["step"].dtype == torch.int32


def test_train_main_smoke_on_cpu(tmp_path, capsys):
    args = ["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "32", "--checkpoint-dir", str(tmp_path),
            "--checkpoint-every", "2"]
    res = ttrain.main(args + ["--steps", "3"])
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    again = ttrain.main(args + ["--steps", "4"])       # resumes at step 3
    out = capsys.readouterr().out
    assert "restored checkpoint at step 3" in out
    assert again["start"] == 3 and len(again["losses"]) == 1
    assert int(again["state"]["opt"]["step"]) == 4
