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


def test_cpu_main_path_never_loads_jax_or_reference():
    code = """
import sys
import numpy as np
from functools import partial
import repro_torch
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
out = Session(g, s, ZU2, qm, device="cpu").run(
    quantize.quantize_to(x, qm.f_a["data"]))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("BAD", bad, prog.meta["kinds"])
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("BAD [] {'chain'"), res.stdout


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


def test_no_source_imports_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if FORBIDDEN.search(f.read_text())]
    assert offenders == []


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
