"""``launch.dryrun.run_cell`` for every config's family on fake process
groups: each arch (smoke) x train / prefill / decode (at batch 4 and 1)
on a (2, 2) mesh,
and the five families the dense path does not cover on a 16-way model
axis, where xLSTM's heads and Mixtral's experts (4 each at smoke size) do
not divide and replicate.  Meta DTensors, so no data moves; each mesh's
cells run in one subprocess (a fake group per process), both at once."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro import configs as jconfigs

ROOT = pathlib.Path(__file__).resolve().parents[1]
# decode_b1: a decode of one sequence (long_500k's batch), whose logits
# are replicated over the data axis
KINDS = ("train", "prefill", "decode", "decode_b1")
FAMILIES = ("xlstm-1.3b", "zamba2-1.2b", "mixtral-8x7b", "qwen2-vl-7b",
            "seamless-m4t-large-v2")
MESHES = {"2x2": ((2, 2), sorted(jconfigs.ARCHS)),
          "1x16": ((1, 16), FAMILIES)}

CODE = textwrap.dedent("""
    import json, sys
    from repro_torch import configs
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.launch import dryrun, shard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api

    dims = tuple(json.loads(sys.argv[1]))
    dryrun.fake_world(dims[0] * dims[1])
    mesh = make_mesh(dims, ("data", "model"), "cpu")
    heads = []
    meta_scan = ops.meta_scan

    def spy(q, k, v, log_a):
        heads.append(v.shape[2])
        return meta_scan(q, k, v, log_a)

    ops.meta_scan = spy
    out = {}
    for arch in json.loads(sys.argv[2]):
        cfg = configs.get(arch).smoke()
        for name, kind, rows in (("train", "train", 8),
                                 ("prefill", "prefill", 4),
                                 ("decode", "decode", 4),
                                 ("decode_b1", "decode", 1)):
            heads.clear()
            sh = ShapeCfg(name, kind, 64, rows)
            try:
                rec = dryrun.run_cell(arch, sh, "test", cfg=cfg, mesh=mesh)
            except Exception as e:
                rec = {"status": "error", "error": repr(e)[:2000]}
            rec["scan_heads"] = sorted(set(heads))
            out[f"{arch}/{name}"] = rec
        out[f"{arch}/specs"] = {k: list(v) for k, v in shard.param_specs(
            api.abstract_params(cfg), mesh)["layers"].items()} \\
            if "layers" in api.abstract_params(cfg) else {}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def records():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", CODE, json.dumps(dims), json.dumps(archs)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for name, (dims, archs) in MESHES.items()}
    out = {}
    for name, p in procs.items():
        try:
            stdout, stderr = p.communicate(timeout=600)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        assert p.returncode == 0, stderr[-3000:]
        out[name] = json.loads(stdout.strip().splitlines()[-1])
    return out


CELLS = [(m, a, k) for m, (_, archs) in MESHES.items() for a in archs
         for k in KINDS]


@pytest.mark.parametrize("mesh,arch,kind", CELLS)
def test_run_cell_records_ok(records, mesh, arch, kind):
    rec = records[mesh][f"{arch}/{kind}"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_devices"] == (4 if mesh == "2x2" else 16)
    if kind in ("train", "prefill"):
        assert rec["step_flops"] > 0
    if arch == "xlstm-1.3b" and kind in ("train", "prefill"):
        # 4 heads: 2 a rank at model 2; whole on every rank at 16
        assert rec["scan_heads"] == [2 if mesh == "2x2" else 4]
    if arch == "zamba2-1.2b" and kind in ("train", "prefill"):
        assert rec["scan_heads"] == [2 if mesh == "2x2" else 4]


def test_experts_replicate_where_the_model_axis_does_not_divide(records):
    """Mixtral's 4 smoke experts: at model 16 no expert weight shards its
    expert dim (the reference's rule); the router's expert dim neither."""
    specs = records["1x16"]["mixtral-8x7b/specs"]
    for name in ("w1", "w2", "w3", "router"):
        spec = specs[name]
        expert_dim = 2 if name == "router" else 1
        assert len(spec) <= expert_dim or spec[expert_dim] is None, (name,
                                                                     spec)
