"""repro_torch.stages (Wrapped -> Lowered -> Planned -> Compiled) as
tests/test_stages.py holds the reference: the staged walk equals the
one-call compile, warm recompiles hit every stage cache, planner knobs
re-plan without re-searching, stage keys are stable across processes and
equal the reference's, and profiles and ``Lowered.retune`` reach the
tuner."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import partition as ref_partition
from repro.hw import ZU2 as REF_ZU2
from repro.stages import compile_model as ref_compile_model
from repro.stages import wrap as ref_wrap
from repro_torch import asm
from repro_torch.core import partition
from repro_torch.hw import ZU2
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime import Session
from repro_torch.stages import (STAGE_CACHE, Compiled, StageCache,
                                artifact_stage_keys, compile_model, wrap)
from torch_common import port_model, reference_model, strategy

ROOT = pathlib.Path(__file__).resolve().parents[1]
STAGES = ("wrapped", "lowered", "planned", "compiled")


@pytest.fixture(scope="module")
def toy():
    g, qm, _ = port_model("toy", 16)
    return g, qm


def _counts(reg, what):
    return {s: (reg.get(f"stages.{s}.{what}").value
                if reg.get(f"stages.{s}.{what}") else 0.0) for s in STAGES}


def _cache():
    reg = MetricsRegistry()
    return StageCache(registry=reg), reg


def test_pipeline_matches_compile_strategy(toy):
    g, qm = toy
    art = asm.compile_strategy(g, strategy("repro_torch", g), ZU2, qm=qm)
    co = compile_model(g, qm, ZU2, cache=_cache()[0])
    assert co.artifact.graph_sig == art.graph_sig
    assert asm.strategy_signature(co.artifact) == asm.strategy_signature(art)
    assert co.artifact.instrs == art.instrs
    assert co.artifact.sim_total_cycles == art.sim_total_cycles
    assert co.stage_keys == artifact_stage_keys(art) == \
        artifact_stage_keys(co.artifact)


def test_warm_recompile_hits_all_four_stage_caches(toy):
    g, qm = toy
    sc, reg = _cache()
    co1 = compile_model(g, qm, ZU2, cache=sc)
    assert _counts(reg, "misses") == dict.fromkeys(STAGES, 1.0)
    co2 = compile_model(g, qm, ZU2, cache=sc)
    assert co2 is co1
    assert _counts(reg, "hits") == dict.fromkeys(STAGES, 1.0)
    assert _counts(reg, "misses") == dict.fromkeys(STAGES, 1.0)
    assert sc.stats() == dict.fromkeys(STAGES, 1)


def test_pin_input_replans_without_researching(toy):
    g, qm = toy
    sc, reg = _cache()
    lo = wrap(g, qm, ZU2, cache=sc).lower()
    p0, p1 = lo.plan(), lo.plan(pin_input=True)
    assert p0.key != p1.key
    assert p1.compile().artifact.pin_input
    assert not p0.compile().artifact.pin_input
    assert reg.get("stages.lowered.misses").value == 1.0
    assert reg.get("stages.planned.misses").value == 2.0


def test_ddr_budget_replans_and_enforces_capacity(toy):
    g, qm = toy
    lo = wrap(g, qm, ZU2, cache=_cache()[0]).lower()
    p0 = lo.plan()
    p1 = lo.plan(ddr_budget_bytes=p0.peak_ddr_bytes * 2)
    assert p1.key != p0.key and p1.peak_ddr_bytes == p0.peak_ddr_bytes
    with pytest.raises(Exception, match="(?i)ddr|capacity|exceed"):
        lo.plan(ddr_budget_bytes=max(1, p0.peak_ddr_bytes // 2))


@pytest.mark.parametrize("model,img,policy", [("toy", 16, None),
                                              ("toy", 16, "paper"),
                                              ("googlenet", 32, None)])
def test_stage_keys_equal_reference(model, img, policy):
    """The same inputs reach the reference's content addresses (search
    under a host/accelerator partition included), and the same plan."""
    g_ref, _, _, qm_ref, _ = reference_model(model, img)
    g, qm, _ = port_model(model, img)
    dv = partition.device_of(g, policy) if policy else None
    dv_ref = ref_partition.device_of(g_ref, policy) if policy else None
    co = compile_model(g, qm, ZU2, device_of=dv, cache=None)
    ref = ref_compile_model(g_ref, qm_ref, REF_ZU2, device_of=dv_ref,
                            cache=None)
    assert co.stage_keys == ref.stage_keys
    assert co.artifact.mem_summary == ref.artifact.mem_summary
    assert co.artifact.exec_items == ref.artifact.exec_items
    lo = wrap(g, qm, ZU2, cache=None).lower(strategy=strategy(
        "repro_torch", g), cache=None)
    lo_ref = ref_wrap(g_ref, qm_ref, REF_ZU2, cache=None).lower(
        strategy=strategy("repro", g_ref), cache=None)
    assert (lo.key, lo.wrapped.key) == (lo_ref.key, lo_ref.wrapped.key)


def test_stage_keys_stable_across_processes(toy):
    g, qm = toy
    co = wrap(g, qm, ZU2, cache=None).lower(cache=None).plan(
        cache=None).compile(cache=None)
    code = (
        "import json\n"
        "from repro_torch.hw import ZU2\n"
        "from repro_torch.stages import wrap\n"
        "from torch_common import port_model\n"
        "g, qm, _ = port_model('toy', 16)\n"
        "co = wrap(g, qm, ZU2, cache=None).lower(cache=None)"
        ".plan(cache=None).compile(cache=None)\n"
        "print(json.dumps(co.stage_keys))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT / 'tests'}",
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT),
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == co.stage_keys


def test_saved_artifact_reopens_with_identical_stage_keys(toy, tmp_path):
    g, qm = toy
    co = compile_model(g, qm, ZU2, cache=_cache()[0])
    path = str(tmp_path / "m.npz")
    co.save(path)
    re = Compiled.from_artifact(asm.load_artifact(path))
    assert re.key == co.key and re.stage_keys == co.stage_keys
    x = np.random.default_rng(1).integers(-128, 127, g.shape("data"),
                                          np.int8)
    cache = asm.PlanCache()
    got = re.session(device="cpu", cache=cache).run(x)
    want = co.session(device="cpu", cache=cache).run(x)
    assert cache.misses == 0
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_compile_strategy_is_a_thin_stage_wrapper(toy):
    g, qm = toy
    s = strategy("repro_torch", g)
    before = len(STAGE_CACHE)
    a1 = asm.compile_strategy(g, s, ZU2, qm=qm)
    a2 = asm.compile_strategy(g, s, ZU2, qm=qm)
    assert len(STAGE_CACHE) == before          # no pollution of the global
    assert a1 is not a2 and a1.instrs == a2.instrs


def _kernel_profile():
    """A kernel-domain profile dominated by per-block overhead: fewer,
    larger tiles predict faster than the card's chooser."""
    from repro_torch.tune import DeviceProfile
    from repro_torch.tune.profile import COEF_NAMES
    coef = [0.0] * len(COEF_NAMES)
    coef[COEF_NAMES.index("cells")] = 1e-4
    return DeviceProfile(name="cells", device="zu2", backend="fused",
                         jax_version="t", features="kernel", combine="sum",
                         coef=tuple(coef), deviation=0.0, n_samples=3)


def test_tuner_paths_raise_until_ported(toy, tmp_path, monkeypatch):
    """Once raising, now ported: ``compile_model`` and ``lower`` under a
    profile (object or name in a ``ProfileCache``) search under the
    calibrated evaluator and record its hash; ``Lowered.retune`` re-runs
    only the tile search (one new lowering, no new wrap, same groups); an
    unknown profile name is a KeyError."""
    from repro_torch.tune import ProfileCache
    g, qm = toy
    p = _kernel_profile()
    ProfileCache(str(tmp_path)).put(p)
    monkeypatch.setenv("DNNVM_PROFILE_CACHE", str(tmp_path))
    sc, reg = _cache()
    co = compile_model(g, qm, ZU2, profile="cells", cache=sc)
    assert co.artifact.profile_hash == p.hash()
    assert co.artifact.meta["profile_name"] == "cells"
    lo = wrap(g, qm, ZU2, cache=sc).lower(profile=p)
    assert lo.profile == p and lo.strategy.meta["evaluator"] == \
        "CalibratedEvaluator"
    before = _counts(reg, "misses")
    tuned = lo.retune()
    after = _counts(reg, "misses")
    assert after["wrapped"] == before["wrapped"]
    assert after["lowered"] == before["lowered"] + 1
    assert tuned is not lo and tuned.profile_hash == p.hash()
    assert [list(x) for x in tuned.strategy.groups] == \
        [list(x) for x in lo.strategy.groups]
    assert tuned.strategy.meta["tile_source"] == "profile"
    assert "tile_provenance" not in lo.strategy.meta   # input not mutated
    x = np.random.default_rng(4).integers(-128, 127, g.shape("data"), np.int8)
    want = Session(g, lo.strategy, ZU2, qm, device="cpu",
                   cache=asm.PlanCache()).run(x)
    got = tuned.plan().compile().session(device="cpu", profile=p,
                                         cache=asm.PlanCache()).run(x)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(KeyError, match="no profile named"):
        compile_model(g, qm, ZU2, profile="absent", cache=None)


def test_compiled_session_equals_strategy_session(toy):
    g, qm = toy
    s = strategy("repro_torch", g)
    x = np.random.default_rng(2).integers(-128, 127, g.shape("data"), np.int8)
    cache = asm.PlanCache()
    got = compile_model(g, qm, ZU2, strategy=s, cache=_cache()[0]).session(
        device="cpu", cache=cache)
    assert got.backend == "fused" and got.cache_hit
    want = Session(g, s, ZU2, qm, device="cpu", cache=cache)
    assert want.cache_hit and want.artifact is got.artifact
    a, b = got.run(x), want.run(x)
    for k in b:
        assert torch.equal(a[k], b[k]), k
