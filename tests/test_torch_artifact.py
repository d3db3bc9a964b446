"""repro_torch.asm (the DNNVM object file and the plan cache), the
plan-cached Session and validate.artifact_round_trip on the CPU, against
the reference: the same header JSON for the same inputs, artifacts that
load across the two packages and run bit-equal to the reference's
executor, the loader's errors, the cache's accounting."""
import json
import warnings
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.asm as ref_asm
from repro.core import executor as ref_executor
from repro.explain import report_of as ref_report_of
from repro.hw import ZU2 as REF_ZU2
from repro.runtime import Session as RefSession
from repro_torch import asm
from repro_torch.core import executor, validate
from repro_torch.explain import report_of
from repro_torch.hw import ZU2
from repro_torch.obs.events import EVENTS
from repro_torch.runtime import Session
from repro_torch.core import pathsearch
from repro_torch.stages import compile_model
from repro_torch.tune import ProfileCache
from torch_common import build_graph, port_model, reference_model, strategy

MODELS = [("toy", 16), ("googlenet", 32)]


def _meta(path) -> dict:
    with np.load(path) as z:
        return json.loads(str(z["meta_json"]))


def _both(model, img):
    """(reference artifact, port artifact, port graph, port qm, xq)."""
    g_ref, _, _, qm_ref, xq = reference_model(model, img)
    g, qm, _ = port_model(model, img)
    art_ref = ref_asm.compile_strategy(g_ref, strategy("repro", g_ref),
                                       REF_ZU2, qm=qm_ref)
    art = asm.compile_strategy(g, strategy("repro_torch", g), ZU2, qm=qm)
    return art_ref, art, g, qm, xq


def _equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        o = got[k].cpu().numpy() if torch.is_tensor(got[k]) else \
            np.asarray(got[k])
        assert o.dtype == w.dtype and o.shape == w.shape, k
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(o, w, err_msg=k)
        else:                  # the host softmax, as in test_torch_executor
            np.testing.assert_allclose(o, w, rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("model,img", MODELS)
def test_header_and_signatures_match_reference(model, img, tmp_path):
    """Same graph, strategy, ZU2 and quantization: the same object-file
    header (program, memory plan, report, signatures) and the same
    instruction arrays."""
    art_ref, art, g, qm, _ = _both(model, img)
    ref_asm.save_artifact(art_ref, str(tmp_path / "ref.npz"))
    asm.save_artifact(art, str(tmp_path / "port.npz"))
    assert _meta(tmp_path / "port.npz") == _meta(tmp_path / "ref.npz")
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in ("instr_fields", "deps_flat", "deps_off"):
            np.testing.assert_array_equal(a[k], b[k])
    s, s_ref = strategy("repro_torch", g), strategy("repro", g)
    assert asm.strategy_signature(s) == ref_asm.strategy_signature(s_ref)
    assert asm.quant_signature(qm) == ref_asm.quant_signature(
        reference_model(model, img)[3])
    assert asm.PlanCache().key(g, s, ZU2, qm) == ref_asm.PlanCache().key(
        build_graph("repro", model, img), s_ref, REF_ZU2,
        reference_model(model, img)[3])


@pytest.mark.parametrize("model,img", MODELS)
def test_reference_artifact_runs_in_port(model, img, tmp_path):
    """Saved by repro, loaded by repro_torch: the stored program is
    dispatched as is and equals the reference executor on the artifact."""
    art_ref, _, _, _, xq = _both(model, img)
    path = str(tmp_path / "ref.npz")
    ref_asm.save_artifact(art_ref, path)
    loaded = asm.load_artifact(path)
    assert loaded.program.meta["quantized"]
    ex = loaded.executor(device="cpu")
    assert ex.program is loaded.program
    want = ref_executor.Int8Executor(art_ref.rebuild_graph(),
                                     art_ref.quantized_model(),
                                     strategy=art_ref, backend="ref")(xq)
    _equal(ex(xq), want)
    _equal(loaded.executor(backend="ref", device="cpu")(xq), want)


@pytest.mark.parametrize("model,img", MODELS)
def test_port_artifact_runs_in_reference(model, img, tmp_path):
    """Saved by repro_torch, loaded by repro: the reference dispatches the
    stored program (Pallas in interpret mode) and its ref oracle agrees
    with the port's fused run on the CPU."""
    _, art, g, qm, xq = _both(model, img)
    path = str(tmp_path / "port.npz")
    asm.save_artifact(art, path)
    loaded = ref_asm.load_artifact(path)
    ex = loaded.executor(backend="pallas")
    assert ex.program is loaded.program
    want = executor.Int8Executor(g, qm, strategy=art, backend="fused",
                                 device="cpu")(xq)
    _equal(want, {k: np.asarray(v) for k, v in ex(jnp.asarray(xq)).items()})
    _equal(want, loaded.executor(backend="ref")(xq))


def test_loader_raises_artifact_error(tmp_path):
    _, art, *_ = _both("toy", 16)
    good = tmp_path / "good.npz"
    asm.save_artifact(art, str(good))
    raw = good.read_bytes()
    (tmp_path / "trunc.npz").write_bytes(raw[:len(raw) // 2])
    (tmp_path / "junk.npz").write_bytes(b"not an npz at all")
    with np.load(good) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(str(arrays["meta_json"]))
    for name, meta_json in (("garbled", "{not json"),
                            ("noheader", json.dumps([1, 2])),
                            ("version", json.dumps(dict(meta,
                                                        format_version=2)))):
        np.savez(tmp_path / f"{name}.npz",
                 **dict(arrays, meta_json=np.asarray(meta_json)))
    no_w = dict(arrays)
    no_w.pop(next(k for k in arrays if k.startswith("w::")))
    np.savez(tmp_path / "noweight.npz", **no_w)
    for name in ("trunc", "junk", "garbled", "noheader", "version",
                 "noweight"):
        with pytest.raises(asm.ArtifactError):
            asm.load_artifact(str(tmp_path / f"{name}.npz"))
    with pytest.raises(FileNotFoundError):
        asm.load_artifact(str(tmp_path / "missing.npz"))
    assert issubclass(asm.ArtifactError, ValueError)
    assert zipfile.is_zipfile(good)


def test_plan_cache_counts_hits_misses_and_evictions():
    g, qm, _ = port_model("toy", 16)
    cache = asm.PlanCache(maxsize=2)
    s = strategy("repro_torch", g)
    a1, hit1 = cache.get_or_compile(g, s, ZU2, qm=qm)
    a2, hit2 = cache.get_or_compile(g, s, ZU2, qm=qm)
    assert not hit1 and hit2 and a1 is a2
    naive = strategy("repro_torch", g, "naive")
    _, hit3 = cache.get_or_compile(g, naive, ZU2, qm=qm)
    assert not hit3 and len(cache) == 2
    seen = []
    EVENTS.subscribe(seen.append)
    try:
        _, hit4 = cache.get_or_compile(g, s, ZU2, qm=qm, pin_input=True)
    finally:
        EVENTS.unsubscribe(seen.append)
    assert not hit4 and len(cache) == 2 and cache.evictions == 1
    assert [(e.kind, e.fields["n"]) for e in seen] == [("cache.evict", 1)]
    # the least recently used plan (s) went; the naive plan stayed
    assert cache.get_or_compile(g, naive, ZU2, qm=qm)[1]
    assert (cache.hits, cache.misses) == (2, 3)
    assert not cache.get_or_compile(g, s, ZU2, qm=qm)[1]
    assert cache.evictions == 2
    cache.max_entries = 1
    assert len(cache) == 1 and cache.evictions == 3
    with pytest.raises(ValueError):
        cache.max_entries = 0


def test_session_compiles_through_the_plan_cache(tmp_path, monkeypatch):
    g, qm, xq = port_model("toy", 16)
    cache = asm.PlanCache()
    s = strategy("repro_torch", g)
    sess = Session(g, s, ZU2, qm, device="cpu", cache=cache)
    again = Session(g, s, ZU2, qm, device="cpu", cache=cache)
    assert not sess.cache_hit and again.cache_hit
    assert again.artifact is sess.artifact
    assert sess.executor.program is sess.artifact.program is sess.program
    st = again.stats()
    assert (st["cache_hit"], st["cache_hits"], st["cache_misses"]) == \
        (True, 1, 1)
    assert st["sim_cycles_per_image"] == sess.artifact.sim_total_cycles > 0
    assert st["pin_input"] is False and st["fused_coverage"] == 1.0
    assert Session(g, s, ZU2, qm, device="cpu", cache=cache,
                   pin_input=True).stats()["pin_input"] is True
    Session(g, s, ZU2, qm, device="cpu", cache=cache, cache_max_entries=1)
    assert len(cache) == 1
    # a profile named in the on-disk cache: compiled under it, keyed apart
    p = _profile()
    ProfileCache(str(tmp_path)).put(p)
    monkeypatch.setenv("DNNVM_PROFILE_CACHE", str(tmp_path))
    tuned = Session(g, s, ZU2, qm, device="cpu", cache=cache,
                    profile=p.name)
    assert not tuned.cache_hit and tuned.profile == p
    assert tuned.artifact.profile_hash == p.hash()
    assert tuned.stats()["session_profile_hash"] == p.hash()
    with pytest.raises(KeyError, match="no profile named"):
        Session(g, s, ZU2, qm, device="cpu", cache=cache, profile="h100")


@pytest.mark.parametrize("model,img", MODELS)
def test_from_artifact_seeds_the_cache_and_serves(model, img, tmp_path):
    g, qm, xq = port_model(model, img)
    cache = asm.PlanCache()
    sess = Session(g, strategy("repro_torch", g), ZU2, qm, device="cpu",
                   cache=cache)
    path = str(tmp_path / "m.npz")
    asm.save_artifact(sess.artifact, path)
    loaded = asm.load_artifact(path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        reopened = Session.from_artifact(loaded, device="cpu", cache=cache)
    assert reopened.cache_hit and cache.misses == 1
    assert reopened.artifact is loaded
    assert reopened.executor.program is loaded.program
    want = sess.run(xq)
    got = reopened.run(xq)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    via = loaded.session(device="cpu", cache=cache)
    assert via.cache_hit and via.backend == "fused" and cache.misses == 1


def _profile():
    from repro_torch.tune import DeviceProfile
    from repro_torch.tune.profile import COEF_NAMES
    return DeviceProfile(name="unit", device="zu2", backend="fused",
                         jax_version="t", features="analytic",
                         combine="sum",
                         coef=tuple(1e-9 * (i + 1)
                                    for i in range(len(COEF_NAMES))),
                         deviation=0.0, n_samples=3)


def test_from_artifact_profile_mismatch_warns(tmp_path):
    """As the reference (tests/test_tune.py): a profile-planned artifact
    reopened without its profile warns and still serves, from the cache;
    under the matching profile, or analytic under none, it does not."""
    g, qm, _ = port_model("toy", 16)
    p = _profile()
    from repro_torch.tune import CalibratedEvaluator
    s = pathsearch.search(g, ZU2, evaluator=CalibratedEvaluator(g, ZU2, p))
    path = str(tmp_path / "tuned.npz")
    asm.save_artifact(asm.compile_strategy(g, s, ZU2, qm=qm, profile=p), path)
    loaded = asm.load_artifact(path)
    assert loaded.profile_hash == p.hash()
    with pytest.warns(UserWarning, match="planned under device profile"):
        sess = Session.from_artifact(loaded, device="cpu",
                                     cache=asm.PlanCache())
    assert sess.cache_hit and sess.stats()["profile_hash"] == p.hash()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = Session.from_artifact(loaded, device="cpu",
                                      cache=asm.PlanCache(), profile=p)
    assert again.cache_hit and again.profile == p
    asm.save_artifact(asm.compile_strategy(g, strategy("repro_torch", g),
                                           ZU2, qm=qm), path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Session.from_artifact(asm.load_artifact(path), device="cpu",
                              cache=asm.PlanCache())


def test_from_artifact_warns_on_a_profile_planned_artifact():
    _, art, *_ = _both("toy", 16)
    art.meta["profile_hash"] = "abc123"
    with pytest.warns(UserWarning, match="device profile abc123"):
        Session.from_artifact(art, device="cpu", cache=asm.PlanCache())


@pytest.mark.parametrize("model,img", MODELS)
def test_tile_summary_and_explain_match_reference(model, img):
    g_ref, _, _, qm_ref, _ = reference_model(model, img)
    g, qm, _ = port_model(model, img)
    ref = RefSession(g_ref, strategy("repro", g_ref), REF_ZU2, qm_ref,
                     cache=ref_asm.PlanCache())
    sess = Session(g, strategy("repro_torch", g), ZU2, qm, device="cpu",
                   cache=asm.PlanCache())
    assert sess.tile_summary() == ref.tile_summary()
    assert sess.explain() == ref.explain()
    assert report_of(sess.artifact) == ref_report_of(ref.artifact)
    text = sess.explain(render=True)
    assert text == ref.explain(render=True) and g.name in text


@pytest.mark.parametrize("model,img", MODELS + [("resnet50", 32)])
def test_artifact_round_trip_exact_on_cpu(model, img, tmp_path):
    g, qm, xq = port_model(model, img)
    rep = validate.artifact_round_trip(
        g, qm, xq, strategy("repro_torch", g), ZU2,
        str(tmp_path / f"{model}.npz"), device="cpu")
    assert rep.bit_exact and rep.max_abs_diff == 0 and rep.n_outputs >= 1


def test_artifact_entry_points_default_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, qm, xq = port_model("toy", 16)
    s = strategy("repro_torch", g)
    art = asm.compile_strategy(g, s, ZU2, qm=qm)
    co = compile_model(g, qm, ZU2, strategy=s)
    for fn in (art.executor, art.session, co.session,
               lambda: Session.from_artifact(art, cache=asm.PlanCache()),
               lambda: validate.artifact_round_trip(
                   g, qm, xq, s, ZU2, str(tmp_path / "m.npz"))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()
