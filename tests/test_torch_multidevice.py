"""The port's multi-device slice on spawned gloo CPU ranks, against the JAX
package: the sharded train step three ways, TP serving, elastic restore
and the compressed all-reduce.

Each group runs ``tests/torch_ranks.py`` in a subprocess (one thread per
rank, a 60 s timeout per collective, 300 s for the group), so a hang fails
its test and no process group outlives it.  The reference runs here, in
this process, on the same numpy inputs; its own multi-device check of
``compressed_psum`` runs in a subprocess with 8 forced host devices, as
``tests/test_multidevice.py`` does.
"""
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import api as japi
from repro_torch.core.carry import lm_params_from_reference
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = ROOT / "tests" / "torch_ranks.py"
GRAD_ACCUM = 2
# the reference's own tolerances (tests/test_multidevice.py): loss of the
# sharded step against the unsharded one, params of "late" against "auto",
# the int8 compressed gradient against the exact mean
LOSS_TOL = 5e-3
PARAM_RTOL, PARAM_ATOL = 5e-3, 5e-4
COMPRESS_REL_TOL = 0.05
FP32_LOGITS_TOL = 1e-4      # TP=2 fp32 prefill against unsharded and JAX


def _env(**extra):
    return dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT / 'tests'}",
                OMP_NUM_THREADS="1", **extra)


def _paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_paths(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _ranks(case: str, in_dir) -> dict:
    out = in_dir / f"{case}.pkl"
    res = subprocess.run([sys.executable, str(RANKS), case, str(in_dir),
                          str(out)], capture_output=True, text=True,
                         env=_env(), timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


# ----------------------------------------------------------------- training
def _train_cfgs():
    jcfg = dataclasses.replace(jconfigs.get("smollm-360m").smoke(),
                               n_layers=2)
    return jcfg


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    """The reference's initial state and unsharded step, and the ranks'
    (2, 2) steps on the same numpy batch."""
    d = tmp_path_factory.mktemp("train")
    jcfg = _train_cfgs()
    state = jtrain.init_state(jcfg)
    np.savez(d / "params.npz", **_paths(state["params"]))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (8, 33)).astype(
        np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    np.savez(d / "batch.npz", **batch)
    _, jm = jax.jit(jtrain.make_train_step(jcfg, grad_accum=GRAD_ACCUM))(
        state, batch)
    return {"jax_loss": float(jm["loss"]), "params": state["params"],
            "batch": batch, "ranks": _ranks("train", d)}


def _port_step(cfg, params, batch):
    """The port's unsharded step from the reference's params."""
    from repro_torch.optim.adamw import AdamWConfig, init_moments

    p = lm_params_from_reference(params, "cpu")
    state = {"params": p, "opt": init_moments(p, AdamWConfig())}
    return ttrain.make_train_step(cfg, grad_accum=GRAD_ACCUM)(
        state, {k: torch.as_tensor(v) for k, v in batch.items()})


def _close(got: dict, want: dict):
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=PARAM_RTOL,
                                   atol=PARAM_ATOL, err_msg=k)


def test_sharded_train_step_matches_reference(train_run):
    """The (2, 2) step (smollm's 15 heads fall back to replicated
    attention at model 2 only where they do not divide) against the JAX
    package's unsharded step, and its params against the port's own
    unsharded step."""
    from repro_torch import configs

    r = train_run["ranks"]["auto"]
    assert abs(r["loss"] - train_run["jax_loss"]) < LOSS_TOL
    cfg = dataclasses.replace(configs.get("smollm-360m").smoke(), n_layers=2)
    new, m = _port_step(cfg, train_run["params"], train_run["batch"])
    assert abs(r["loss"] - float(m["loss"])) < 1e-5
    _close(_paths(r["params"]), _paths({k: v.numpy() if torch.is_tensor(v)
                                        else {kk: vv.numpy()
                                              for kk, vv in v.items()}
                                        for k, v in new["params"].items()}))


def test_late_grad_sync_matches_auto(train_run):
    """One mean all-reduce per step moves 1/grad_accum of the per-microbatch
    gradient all-reduce bytes over the data group, to the same params."""
    auto, late = train_run["ranks"]["auto"], train_run["ranks"]["late"]
    assert abs(late["loss"] - auto["loss"]) < LOSS_TOL
    _close(_paths(late["params"]), _paths(auto["params"]))
    a, b = auto["grad_sync"], late["grad_sync"]
    assert a["counts"]["all-reduce"] == GRAD_ACCUM * b["counts"]["all-reduce"]
    assert a["bytes_by_op"]["all-reduce"] == GRAD_ACCUM * b["bytes_by_op"][
        "all-reduce"]
    assert set(a["bytes_by_op"]) == set(b["bytes_by_op"]) == {"all-reduce"}


def test_compressed_late_sync_gradients(train_run):
    """int8 compressed sync: each gradient leaf within 5% of its largest
    value of the exact mean (the reference's bound)."""
    exact = _paths(train_run["ranks"]["late"]["grads"])
    got = _paths(train_run["ranks"]["late_compressed"]["grads"])
    for k, g in exact.items():
        rel = np.abs(got[k] - g).max() / (np.abs(g).max() + 1e-12)
        assert rel < COMPRESS_REL_TOL, (k, rel)


def test_each_data_rank_takes_its_host_rows(train_run):
    """``SyntheticLM(host_index=data rank, host_count=dp)`` feeds each data
    rank its own rows: the late step on them equals the unsharded step on
    the hosts' rows stacked in order."""
    from repro_torch import configs

    cfg = dataclasses.replace(configs.get("smollm-360m").smoke(), n_layers=2)
    hosts = [SyntheticLM(vocab=cfg.vocab, batch=8, seq=32, host_index=i,
                         host_count=2, device="cpu").next() for i in (0, 1)]
    batch = {k: np.concatenate([h[k].numpy() for h in hosts])
             for k in hosts[0]}
    new, m = _port_step(cfg, train_run["params"], batch)
    r = train_run["ranks"]["hosts"]
    assert abs(r["loss"] - float(m["loss"])) < 1e-5
    want = {k: (v.numpy() if torch.is_tensor(v) else
                {kk: vv.numpy() for kk, vv in v.items()})
            for k, v in new["params"].items()}
    _close(_paths(r["params"]), _paths(want))


# ------------------------------------------------------------------ serving
@pytest.fixture(scope="module")
def serve_inputs(tmp_path_factory):
    """Granite smoke (fp32) weights from the JAX package, its prefill, and
    the unsharded port's prefill and serve loop on the same inputs."""
    d = tmp_path_factory.mktemp("serve")
    jcfg = jconfigs.get("granite-8b").smoke()
    jparams = japi.init_params(jcfg)
    np.savez(d / "params.npz", **_paths(jparams))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab, (4, 64)).astype(np.int32)
    prompt = rng.integers(0, jcfg.vocab, (4, 8)).astype(np.int32)
    np.savez(d / "batch.npz", tokens=tokens, prompt=prompt)
    from repro_torch import configs

    cfg = dataclasses.replace(configs.get("granite-8b").smoke(),
                              attn_impl="flash")
    params = lm_params_from_reference(jparams, "cpu")
    with torch.no_grad():
        plain = tserve.make_prefill_step(cfg)(
            params, {"tokens": torch.as_tensor(tokens)}).numpy()
    return {"dir": d, "cfg": cfg, "plain": plain,
            "jax": np.asarray(jserve.make_prefill_step(jcfg)(
                jparams, {"tokens": tokens})),
            # 8 + 8 cache slots: at TP = 4 the cache shards its sequence
            "tokens": tserve.serve_loop(cfg, params, prompt, 8,
                                        "cpu")["tokens"]}


def _check_serve(r, s):
    assert np.abs(r["logits"] - s["jax"]).max() < FP32_LOGITS_TOL
    assert np.abs(r["logits"] - s["plain"]).max() < FP32_LOGITS_TOL
    np.testing.assert_array_equal(r["tokens"], s["tokens"])
    assert r["foreign_modules"] == []      # the ranks never load jax


def test_tp2_prefill_and_decode_match_unsharded_and_reference(serve_inputs):
    """Granite smoke in fp32 at TP = 2: the prefill (flash on each rank's
    local heads; no weight all-gather) against the unsharded port and the
    JAX prefill at 1e-4, and the serve loop's tokens equal to the
    unsharded loop's."""
    r, cfg = _ranks("serve", serve_inputs["dir"]), serve_inputs["cfg"]
    _check_serve(r, serve_inputs)
    assert r["local_q_heads"] == cfg.n_heads // 2
    assert r["ops"] == ["all-reduce"]      # activations only: no gather
    assert r["collectives"]["counts"]["all-reduce"] == 1 + 2 * cfg.n_layers


def test_tp4_replicates_kv_heads_that_do_not_divide(serve_inputs):
    """At TP = 4 the 2 kv heads do not divide: in the prefill k and v
    replicate (the reference's fallback); the decode cache shards its
    sequence instead and decodes flash-decode style.  Both still match at
    1e-4, and the greedy tokens the unsharded loop's."""
    r, cfg = _ranks("serve4", serve_inputs["dir"]), serve_inputs["cfg"]
    _check_serve(r, serve_inputs)
    assert r["local_q_heads"] == cfg.n_heads // 4
    assert "all-gather" in r["ops"]


# ------------------------------------------------------------------ elastic
@pytest.fixture(scope="module")
def elastic_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    jcfg = _train_cfgs()
    np.savez(d / "params.npz", **_paths(jtrain.init_state(jcfg)["params"]))
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (8, 33)).astype(
        np.int32)
    np.savez(d / "batch.npz", tokens=toks[:, :-1], labels=toks[:, 1:])
    return _ranks("elastic", d)


def test_elastic_remesh_restores_bit_equal(elastic_run):
    """4 -> 2 ranks: plan (1, 2), a mesh over ranks 0-1, every leaf of the
    (2, 2) checkpoint restored onto it bit-equal, and one more step."""
    r = elastic_run
    assert r["plan"] == ((1, 2), ("data", "model"))
    assert r["mesh"] == (1, 2) and r["step"] == 1
    assert r["bit_equal"]
    assert np.isfinite(r["loss"])


def test_run_with_retries_restores_onto_a_mesh(elastic_run):
    """``run_with_retries`` hands its placements tree to the store by
    keyword: the restored state lands on the 2-rank mesh bit-equal."""
    r = elastic_run
    assert r["health_bit_equal"] and r["health_start"] == 1
    assert r["calls"] == [1]


def test_error_feedback_rides_in_the_state(elastic_run):
    """The int8 error-feedback buffers are ``state["opt"]["err"]``, a
    partial sum over "data": the compressed step is pure, and a checkpoint
    and ``reshard_state`` carry the buffers onto (1, 2) with their sum kept
    to the bit; the restored state takes one more compressed step."""
    r = elastic_run
    assert r["err_nonzero"] and r["err_pure"]
    assert r["err_restored_bit_equal"] and r["err_moved_bit_equal"]
    assert "Partial" in r["err_placements"]
    assert np.isfinite(r["compressed_loss"])


# ----------------------------------------------------------------- compress
def test_compressed_psum_matches_reference_shard_map(tmp_path):
    """Four gloo ranks against the JAX ``compressed_psum`` under a
    ``shard_map`` over four forced host devices, on the same per-rank
    inputs: the same arithmetic in the same order, so equal to the bit."""
    rng = np.random.default_rng(3)
    g = (rng.standard_normal((4, 16)) / 10).astype(np.float32)
    err = (rng.standard_normal((4, 16)) / 1000).astype(np.float32)
    np.savez(tmp_path / "batch.npz", g=g, err=err)
    r = _ranks("compress", tmp_path)
    code = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
        import sys
        from functools import partial
        import jax, numpy as np
        from jax.experimental.shard_map import shard_map
        from jax.sharding import Mesh, PartitionSpec as P
        from repro.optim.compress import compressed_psum
        z = np.load(sys.argv[1])
        mesh = Mesh(np.asarray(jax.devices()[:4]), ("data",))

        @partial(shard_map, mesh=mesh, in_specs=(P("data"), P("data")),
                 out_specs=(P("data"), P("data")))
        def sync(gl, el):
            m, e = compressed_psum(gl[0], "data", el[0])
            return m[None], e[None]

        mean, new_err = sync(z["g"], z["err"])
        np.savez(sys.argv[2], mean=np.asarray(mean), err=np.asarray(new_err))
    """)
    res = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "batch.npz"),
                          str(tmp_path / "jax.npz")], capture_output=True,
                         text=True, env=_env(JAX_PLATFORMS="cpu"),
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(tmp_path / "jax.npz") as z:
        np.testing.assert_array_equal(r["mean"], z["mean"][0])
        np.testing.assert_array_equal(r["err"], z["err"])
    rel = np.abs(r["mean"] - g.mean(0)).max() / np.abs(g.mean(0)).max()
    assert rel < COMPRESS_REL_TOL
