"""The port stands alone: it imports neither jax nor the reference package,
its entry points default to CUDA and refuse to run without it, and
chip_smoke.py fails where there is no card."""
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                       re.MULTILINE)


def _env(**extra):
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)


def test_cpu_main_path_never_loads_jax_or_reference(tmp_path):
    """The main path on the CPU: compile through the plan cache, save and
    reload the object file, reopen it with ``Session.from_artifact``, run,
    explain, and compile through the staged pipeline.  The lazy imports
    inside the copied modules run here too, so one left pointing at the
    reference would load it."""
    code = """
import sys
import numpy as np
from functools import partial
import repro_torch
from repro_torch import asm, stages
from repro_torch.cnn import build, init_params
from repro_torch.core import executor, lower, pathsearch, quantize
from repro_torch.hw import ZU2
from repro_torch.runtime import Session
g = build("googlenet", img=32, num_classes=10)
p = init_params(g)
x = np.random.default_rng(0).standard_normal(g.shape("data")).astype("float32")
qm = quantize.calibrate(g, p, x, partial(executor.run_float, device="cpu"))
s = pathsearch.search(g, ZU2)
prog = lower.lower_strategy(g, s, qm)
xq = quantize.quantize_to(x, qm.f_a["data"])
sess = Session(g, s, ZU2, qm, device="cpu")
out = sess.run(xq)
asm.save_artifact(sess.artifact, sys.argv[1])
reopened = Session.from_artifact(asm.load_artifact(sys.argv[1]),
                                 device="cpu")
again = reopened.run(xq)
text = reopened.explain(render=True)
co = stages.compile_model(g, qm, ZU2, strategy=s).session(device="cpu")
same = all(bool((again[k] == out[k]).all()) and
           bool((co.run(xq)[k] == out[k]).all()) for k in out)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("BAD", bad, prog.meta["kinds"])
print("REOPENED", sess.cache_hit, reopened.cache_hit, same, bool(text))
"""
    res = subprocess.run([sys.executable, "-c", code,
                          str(tmp_path / "m.npz")], capture_output=True,
                         text=True, env=_env(), timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("BAD [] {'chain'"), res.stdout
    assert res.stdout.splitlines()[1] == "REOPENED False True True True"


def test_cpu_tune_path_never_loads_jax_or_reference():
    """The tuner on the CPU: an injected (simulator) calibration, a
    calibrated search, a measured calibration and tile search through the
    harness, a session compiled under the profile with its tile records,
    and its pipeline report, with no jax in the process."""
    code = """
import sys
import numpy as np
from functools import partial
from repro_torch import tune
from repro_torch.cnn import build, init_params
from repro_torch.core import executor, pathsearch, quantize
from repro_torch.core.cost import SimulatorEvaluator
from repro_torch.hw import H100, ZU2
from repro_torch.kernels.conv_fused import ops
from repro_torch.runtime import Session
g = build("googlenet", img=32, num_classes=10)
x = np.random.default_rng(0).standard_normal(g.shape("data")).astype("float32")
qm = quantize.calibrate(g, init_params(g), x,
                        partial(executor.run_float, device="cpu"))
sim = SimulatorEvaluator(g, ZU2)
inj = tune.calibrate(g, qm, ZU2, measure_fn=sim, features="analytic")
h = tune.MeasurementHarness(g, qm, ZU2, device="cpu", repeats=2)
cal = tune.calibrate(g, qm, ZU2, harness=h, max_samples=8,
                     min_measurable_s=0.0)
s = pathsearch.search(g, ZU2, evaluator=tune.CalibratedEvaluator(
    g, ZU2, cal.profile))
rep = tune.search_tile_shapes(
    g, qm, H100, s, harness=tune.MeasurementHarness(g, qm, H100,
                                                    device="cpu", repeats=1),
    top_k=1, min_measurable_s=0.0)
ops.reset_counts()
sess = Session(g, s, ZU2, qm, device="cpu", profile=cal.profile)
sess.run(quantize.quantize_to(x, qm.f_a["data"]))
pr = sess.pipeline_report(4, ddr_slots=None)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("BAD", bad, inj.report["n_samples"] > 0,
      ops.TILE_RECORDS["applied"] == rep.n_tuned, pr.ddr_slots_source)
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "BAD [] True True profile", res.stdout


def test_cpu_serving_plane_never_loads_jax_or_reference(tmp_path):
    """The serving plane on the CPU: two tenants compiled into a model zoo
    and reopened from it, a ``MultiServer`` with a drift profiler and its
    scrape endpoint, then a two-replica ``Fleet`` under a chaos kill, with
    no jax in the process."""
    code = """
import sys, urllib.request
import numpy as np
import torch
from functools import partial
from repro_torch import stages
from repro_torch.cnn import build, init_params
from repro_torch.core import executor, quantize
from repro_torch.core.cost import SimulatorEvaluator
from repro_torch.hw import ZU2
from repro_torch import tune
from repro_torch.obs.export import find_samples, parse_openmetrics
from repro_torch.runtime import ChaosInjector, Fleet, MultiServer
from repro_torch.zoo import ModelZoo
zoo = ModelZoo(sys.argv[1])
compiled, xs = {}, {}
for name in ("googlenet", "resnet50"):
    g = build(name, img=32, num_classes=10)
    x = np.random.default_rng(0).standard_normal(g.shape("data"))
    qm = quantize.calibrate(g, init_params(g), x.astype("float32"),
                            partial(executor.run_float, device="cpu"))
    stages.compile_model(g, qm, ZU2, zoo=zoo, name=name)
    compiled[name] = stages.compile_model(
        g, qm, ZU2, zoo=zoo, cache=stages.StageCache())
    xs[name] = quantize.quantize_to(x, qm.f_a["data"])[0]
sim = SimulatorEvaluator(g, ZU2)
with MultiServer() as ms:
    for name in compiled:
        ms.add_model(name, compiled[name], warmup=False,
                     session_kw={"device": "cpu"})
    prof = tune.calibrate(g, qm, ZU2, measure_fn=lambda grp: sim(grp),
                          features="analytic").profile
    dp = ms.attach_drift("resnet50", profile=prof, every=1, repeats=1)
    outs = [ms.submit(name, xs[name]).result(60) for name in compiled]
    http = ms.serve_metrics()
    fams = parse_openmetrics(urllib.request.urlopen(
        http.url("/metrics")).read().decode())
fleet = Fleet(compiled["googlenet"].artifact, n_replicas=2,
              devices=[torch.device("cpu")], check_interval_s=0.01)
chaos = ChaosInjector().attach(fleet)
chaos.kill("r1")
got = [fleet.submit(xs["googlenet"]).result(60) for _ in range(4)]
chaos.heal_all()
fleet.close()
same = all(bool((o["prob"] == outs[0]["prob"]).all()) for o in got)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("BAD", bad, len(zoo), dp.n_sampled,
      bool(find_samples(fams, "serve_requests", model="resnet50")), same)
"""
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path / "zoo")],
                         capture_output=True, text=True, env=_env(),
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "BAD [] 2 1 True True", res.stdout


def test_cpu_lm_path_never_loads_jax_or_reference():
    code = """
import dataclasses, sys
import numpy as np
import torch
from repro_torch import configs
from repro_torch.kernels.flash_attention import ops
from repro_torch.launch import serve
from repro_torch.models import api
cfg = dataclasses.replace(configs.get("granite-8b").smoke(), attn_impl="flash")
params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab, (2, 16)))
logits = serve.make_prefill_step(cfg)(params, {"tokens": toks})
res = serve.serve_loop(cfg, params, toks.numpy(), 4, device="cpu")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("BAD", bad, tuple(logits.shape), res["tokens"].shape,
      ops.PLAIN_CALLS["flash_attention"])
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "BAD [] (2, 16, 512) (2, 4) 4", res.stdout


def test_cpu_recurrent_lm_paths_never_load_jax_or_reference():
    """xLSTM and Zamba2 at smoke size: prefill through the scan wrapper's
    plain version, then the serve loop, with no jax in the process."""
    code = """
import sys
import numpy as np
import torch
from repro_torch import configs
from repro_torch.kernels.ssm_scan import ops
from repro_torch.launch import serve
from repro_torch.models import api
out = []
for arch in ("xlstm-1.3b", "zamba2-1.2b"):
    cfg = configs.get(arch).smoke()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab,
                                                             (2, 16)))
    ops.reset_counts()
    logits = serve.make_prefill_step(cfg)(params, {"tokens": toks})
    res = serve.serve_loop(cfg, params, toks.numpy(), 4, device="cpu")
    out.append((tuple(logits.shape), res["tokens"].shape,
                ops.PLAIN_CALLS["ssm_scan"]))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("BAD", bad, out)
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ("BAD [] [((2, 16, 512), (2, 4), 2), "
                                  "((2, 16, 512), (2, 4), 8)]"), res.stdout


def test_cpu_training_path_never_loads_jax_or_reference(tmp_path):
    """Seamless served, then Zamba2 trained at smoke size (the scan's
    gradient through its plain version), checkpointed and resumed, with
    no jax in the process."""
    code = """
import sys
from repro_torch.launch import serve, train
from repro_torch.optim import compress
served = serve.main(["--arch", "seamless-m4t-large-v2", "--smoke",
                     "--device", "cpu", "--batch", "2", "--prompt-len", "4",
                     "--gen-len", "2"])
args = ["--arch", "zamba2-1.2b", "--smoke", "--device", "cpu", "--batch", "2",
        "--seq", "32", "--checkpoint-dir", sys.argv[1]]
first = train.main(args + ["--steps", "2"])
again = train.main(args + ["--steps", "3"])
deq, err = compress.quantize_ef(first["state"]["params"],
                                compress.init_error(first["state"]["params"]))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("BAD", bad, served["tokens"].shape, len(first["losses"]),
      again["start"], int(again["state"]["opt"]["step"]))
"""
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, env=_env(),
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "BAD [] (2, 2) 2 2 3", \
        res.stdout


def test_train_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path):
    import torch

    from repro_torch import configs
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import serve, train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get("zamba2-1.2b").smoke()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "zamba2-1.2b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.init_state(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SyntheticLM(vocab=8, batch=1, seq=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "seamless-m4t-large-v2", "--smoke"])
    store = CheckpointStore(str(tmp_path))
    store.save({"w": torch.zeros(2)}, step=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        store.restore(1, {"w": torch.empty(2, device="meta")})


def test_port_has_every_reference_module():
    """Every module of the JAX package has a file at the same path in the
    port, apart from the Pallas kernels and their oracles, whose work the
    port's ``ops.py`` and ``csrc/`` do."""
    ref = ROOT / "src" / "repro"
    kernels = {"kernels/conv_fused/conv_fused.py",
               "kernels/flash_attention/flash_attention.py",
               "kernels/flash_attention/ref.py",
               "kernels/ssm_scan/ssm_scan.py", "kernels/ssm_scan/ref.py"}
    missing = {str(f.relative_to(ref)) for f in ref.rglob("*.py")
               if not (PORT / f.relative_to(ref)).exists()}
    assert missing == kernels


def test_no_source_imports_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "examples" /
                                          "serve_cnn_torch.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_model_layers_import_no_launcher():
    """``nn/`` and ``models/`` sit below ``launch/``: they read the mesh
    in effect and the placement vocabulary from ``distributed.mesh_state``
    and import nothing of the launchers, so no import cycle can form."""
    launch = re.compile(r"^\s*(from|import)\s+repro_torch\.launch(\.|\s)",
                        re.MULTILINE)
    files = sorted((PORT / "nn").glob("*.py")) + sorted(
        (PORT / "models").glob("*.py")) + [
        PORT / "distributed" / "mesh_state.py"]
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if launch.search(f.read_text())]
    assert offenders == []
    mesh_state = (PORT / "distributed" / "mesh_state.py").read_text()
    assert not re.search(r"^\s*(from|import)\s+repro_torch", mesh_state,
                         re.MULTILINE)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    import torch

    from repro_torch.core import executor
    from repro_torch.hw import ZU2
    from repro_torch.runtime import Session
    from torch_common import port_model, strategy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, qm, _ = port_model("toy", 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Session(g, strategy("repro_torch", g), ZU2, qm)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        executor.Int8Executor(g, qm, backend="fused")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        executor.run_float(g, {}, None)


def test_serving_plane_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """``Fleet()`` with no devices and ``MultiServer.add_model`` of an
    artifact with no device open their sessions on CUDA, and raise where it
    is absent."""
    import torch

    from repro_torch import asm
    from repro_torch.hw import ZU2
    from repro_torch.runtime import Fleet, MultiServer
    from torch_common import port_model, strategy

    g, qm, _ = port_model("toy", 16)
    art = asm.compile_strategy(g, strategy("repro_torch", g), ZU2, qm=qm)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Fleet(art)
    with MultiServer() as ms:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ms.add_model("toy", art, warmup=False)
        assert ms.models() == []


def test_lm_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core import carry
    from repro_torch.launch import serve
    from repro_torch.models import api

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get("granite-8b").smoke()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", "granite-8b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        carry.lm_params_from_reference({"embed": np.zeros((2, 3), np.float32)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        carry.lm_cache_from_reference({"k": np.zeros((1, 2), np.float32)})


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-1.2b"])
def test_recurrent_lm_entry_points_default_to_cuda(monkeypatch, arch):
    import torch

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import api

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get(arch).smoke()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", arch, "--smoke"])


def test_chip_smoke_fails_without_a_card(tmp_path):
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300,
                         env=_env(CUDA_VISIBLE_DEVICES=""), cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=300,
                         env=env, cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
