"""The port's sharding rules, HLO collective parser, mesh planner and dry
run against the JAX package (pure logic: no process group in this
process; the dry run runs in a subprocess on a fake one)."""
import os
import pathlib
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.distributed import elastic as jelastic
from repro.launch import shard as jshard
from repro.launch.hlo_analysis import collective_stats as jcollective_stats
from repro.models import api as japi
from repro_torch import configs as tconfigs
from repro_torch.distributed import elastic as telastic
from repro_torch.launch import hlo_analysis
from repro_torch.launch import shard as tshard
from repro_torch.models import api as tapi

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIZES = [(16, 16), (2, 16), (16, 2), (2, 2)]       # (data, model)


def _meshes(data: int, model: int):
    """Stand-ins with the names and shape each package's rules read."""
    jm = types.SimpleNamespace(axis_names=("data", "model"),
                               devices=np.empty((data, model)))
    tm = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                               shape=(data, model))
    return jm, tm


def _jflat(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s)
            for path, s in flat}


def _tflat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_tflat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(v)
    return out


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
@pytest.mark.parametrize("data,model", SIZES)
def test_param_and_moment_specs_equal_reference(arch, data, model):
    """Every leaf of every config, abstract params from both packages."""
    jm, tm = _meshes(data, model)
    jp = japi.abstract_params(jconfigs.get(arch))
    tp = tapi.abstract_params(tconfigs.get(arch))
    want = _jflat(jshard.param_specs(jp, jm))
    assert want and _tflat(tshard.param_specs(tp, tm)) == want
    assert _tflat(tshard.moment_specs(tp, tm)) == _jflat(
        jshard.moment_specs(jp, jm))


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
@pytest.mark.parametrize("data,model", SIZES)
def test_batch_and_cache_specs_equal_reference(arch, data, model):
    jm, tm = _meshes(data, model)
    jcfg, tcfg = jconfigs.get(arch), tconfigs.get(arch)
    for shape in ("train_4k", "decode_32k"):
        js = japi.input_specs(jcfg, jconfigs.base.SHAPES[shape])
        ts = tapi.input_specs(tcfg, tconfigs.base.SHAPES[shape])
        assert _tflat(tshard.batch_specs(ts, tm)) == _jflat(
            jshard.batch_specs(js, jm))
    for batch, seq in ((128, 32768), (1, 4096)):
        jc = japi.abstract_cache(jcfg, batch, seq)
        tc = tapi.abstract_cache(tcfg, batch, seq)
        assert _tflat(tshard.cache_specs(tc, tcfg, tm)) == _jflat(
            jshard.cache_specs(jc, jcfg, jm))


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
@pytest.mark.parametrize("data,model", SIZES + [(1, 2), (1, 16)])
def test_smoke_cache_specs_equal_reference(arch, data, model):
    """Every family's decode cache at smoke size (xLSTM's m_state, s_h and
    s_c, Zamba2's ssm with its KV caches, Seamless's cross K/V, the KV
    caches of the others), the batch of the family tests and a batch of
    one."""
    jm, tm = _meshes(data, model)
    jcfg, tcfg = jconfigs.get(arch).smoke(), tconfigs.get(arch).smoke()
    for batch, seq in ((4, 16), (1, 64)):
        jc = japi.abstract_cache(jcfg, batch, seq)
        tc = tapi.abstract_cache(tcfg, batch, seq)
        want = _jflat(jshard.cache_specs(jc, jcfg, jm))
        assert want and _tflat(tshard.cache_specs(tc, tcfg, tm)) == want


def test_zero1_and_placements():
    """zero1_spec as the reference; a spec's placements per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    ps = tshard.param_spec("layers/w1", (126, 16384, 53248), 16)
    assert tuple(tshard.zero1_spec(ps, (126, 16384, 53248), 16)) == tuple(
        jshard.zero1_spec(jshard.param_spec("layers/w1",
                                            (126, 16384, 53248), 16),
                          (126, 16384, 53248), 16))
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                 shape=(2, 4, 2))
    assert tshard.placements(tshard.P(("pod", "data"), None, "model"),
                             mesh) == (Shard(0), Shard(0), Shard(2))
    assert tshard.placements(tshard.P(), mesh) == (Replicate(),) * 3
    one = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                shape=(1, 2))
    assert tshard.placements(tshard.P("data", "model"), one) == (
        Replicate(), Shard(1))


# copied from tests/test_shard_rules.py
HLO_FIXTURE = """\
HloModule test

%body.1 (p: (s32[], f32[128])) -> (s32[], f32[128]) {
  %ar = f32[128]{0} all-reduce(%x), channel_id=1, replica_groups=[16,16]<=[256], to_apply=%sum
  ROOT %t = tuple(%i, %ar)
}

%cond.1 (p: (s32[], f32[128])) -> pred[] {
  %iv = s32[] get-tuple-element(%p), index=0
  %c = s32[] constant(32)
  ROOT %cmp = pred[] compare(%iv, %c), direction=LT
}

ENTRY %main (a: f32[128]) -> f32[128] {
  %ag = f32[256,64]{1,0} all-gather(%a), channel_id=2, replica_groups=[16,16]<=[256], dimensions={0}
  %w = (s32[], f32[128]) while(%init), condition=%cond.1, body=%body.1
  ROOT %r = f32[128] get-tuple-element(%w), index=1
}
"""


def test_collective_stats_equals_reference_on_hlo_fixture():
    assert hlo_analysis.collective_stats(HLO_FIXTURE) == jcollective_stats(
        HLO_FIXTURE)


def test_collective_stats_from_comm_ring_factors():
    """The same factors and schema from a torch step's record: an
    all-reduce in a 32-trip loop of 16-rank groups equals the HLO
    fixture's."""
    rec = ([{"op": "all-reduce", "bytes": 128 * 4, "group": "g",
             "group_size": 16, "label": "grad_sync"}] * 32
           + [{"op": "all-gather", "bytes": 256 * 64 * 4, "group": "g",
               "group_size": 16, "label": ""}])
    st = hlo_analysis.collective_stats_from_comm(rec)
    want = jcollective_stats(HLO_FIXTURE)
    assert st["bytes_by_op"] == want["bytes_by_op"]
    assert st["counts"] == {"all-reduce": 32, "all-gather": 1}
    assert hlo_analysis.collective_stats_from_comm(
        rec, label="grad_sync")["counts"] == {"all-reduce": 32}


@pytest.mark.parametrize("model", [1, 2, 16])
def test_plan_mesh_equals_reference(model):
    for n in range(1, 65):
        try:
            want = jelastic.plan_mesh(n, model)
        except ValueError:
            with pytest.raises(ValueError):
                telastic.plan_mesh(n, model)
            continue
        assert telastic.plan_mesh(n, model) == want


def test_dryrun_cell_on_a_fake_mesh(tmp_path):
    """``run_cell`` at smoke size on a (4, 2) fake mesh: rank 0's state and
    batch bytes are the sum of its shard sizes from the specs, and the step
    issues collectives."""
    code = textwrap.dedent("""
        import json, math, sys
        import torch
        from repro_torch import configs
        from repro_torch.configs.base import ShapeCfg
        from repro_torch.core.tree import leaves
        from repro_torch.launch import dryrun, shard
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.launch.train import abstract_state, state_specs
        from repro_torch.models import api

        dryrun.fake_world(8)
        mesh = make_mesh((4, 2), ("data", "model"), "cpu")
        cfg = configs.get("granite-8b").smoke()
        sizes = {"data": 4, "model": 2}

        def shard_bytes(t, spec):
            shape = list(t.shape)
            for d, e in enumerate(spec):
                for a in (e if isinstance(e, tuple) else (e,)):
                    if a is not None:
                        shape[d] = math.ceil(shape[d] / sizes[a])
            return math.prod(shape) * t.element_size()

        out = {}
        for kind in ("train", "prefill"):
            sh = ShapeCfg(kind, kind, 32, 64 if kind == "train" else 8)
            rec = dryrun.run_cell("granite-8b", sh, "test", cfg=cfg,
                                  mesh=mesh)
            if kind == "train":
                st = abstract_state(cfg)
                specs = state_specs(st, mesh)
            else:
                st = api.abstract_params(cfg)
                specs = shard.param_specs(st, mesh)
            ins = api.input_specs(cfg, sh)
            want = sum(shard_bytes(t, s) for t, s in
                       zip(leaves(st), leaves(specs)))
            want_b = sum(shard_bytes(t, s) for t, s in
                         zip(leaves(ins), leaves(shard.batch_specs(ins,
                                                                   mesh))))
            out[kind] = [rec, want, want_b]
        print(json.dumps(out))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                  OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]
    import json

    out = json.loads(res.stdout.strip().splitlines()[-1])
    for kind, (rec, want, want_b) in out.items():
        assert rec["status"] == "ok" and rec["n_devices"] == 8
        assert rec["state_bytes"] == want and rec["batch_bytes"] == want_b
        assert rec["argument_size_in_bytes"] == want + want_b
        assert rec["collectives"]["total_bytes"] > 0
        assert rec["step_flops"] > 0
    assert out["train"][0]["grad_accum"] == 8
    assert "all-reduce" in out["prefill"][0]["collectives"]["bytes_by_op"]
