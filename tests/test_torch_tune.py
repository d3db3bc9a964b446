"""repro_torch.tune (profiles, the measurement harness, calibration, the
calibrated evaluator and the tile search) against the reference package on
the same numpy inputs, and the port's own kernel-domain features and tile
records on the CPU: the NNLS fit and an injected (simulator) calibration
give the reference's coefficients, the calibrated search picks the
reference's groups, profiles cross between the packages with equal hashes;
the chain features match the kernel's packed descriptors, every tile
candidate fits a block's shared memory, the tile search records its winner,
a tuned session stays bit-exact, and a record the card cannot run raises."""
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from repro import tune as ref_tune
from repro.core import executor as ref_executor
from repro.core import pathsearch as ref_pathsearch
from repro.core.cost import SimulatorEvaluator as RefSimulatorEvaluator
from repro.hw import ZU2 as REF_ZU2
from repro_torch import asm, tune
from repro_torch.core import executor, lower, pathsearch
from repro_torch.core.cost import OnBoardEvaluator, SimulatorEvaluator
from repro_torch.hw import H100, ZU2, get_device
from repro_torch.kernels.conv_fused import ops
from repro_torch.runtime import Session
from repro_torch.tune import evaluator as ev_mod
from repro_torch.tune import tiles
from repro_torch.tune.measure import Measurement
from repro_torch.tune.profile import COEF_NAMES, _gpu_name, _toolchain_version
from torch_common import (HAND_CHAINS, build_graph, port_model,
                          reference_model, strategy)

MODELS = [("toy", 16), ("googlenet", 32)]


def _injected(pkg_tune, g, sim_cls, dev):
    sim = sim_cls(g, dev)
    return pkg_tune.calibrate(g, None, dev, measure_fn=lambda grp: sim(grp),
                              features="analytic")


@pytest.fixture(scope="module", params=MODELS, ids=lambda m: m[0])
def injected(request):
    """Each package calibrated against its own cycle simulator, on the
    same graph: (port graph, port result, reference graph, its result)."""
    model, img = request.param
    g_ref = reference_model(model, img)[0]
    g, _, _ = port_model(model, img)
    return (g, _injected(tune, g, SimulatorEvaluator, ZU2), g_ref,
            _injected(ref_tune, g_ref, RefSimulatorEvaluator, REF_ZU2))


def _profile(pkg_tune, **kw):
    base = dict(name="unit", device="zu2", backend="fused",
                jax_version="v-test", features="kernel", combine="sum",
                coef=tuple(float(i + 1) * 1e-9
                           for i in range(len(COEF_NAMES))),
                deviation=0.07, n_samples=12)
    base.update(kw)
    return pkg_tune.DeviceProfile(**base)


# ------------------------------------------------------- against reference
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_profile_equals_reference(seed):
    rng = np.random.default_rng(seed)
    n = 24
    F = rng.uniform(0, 1e6, (n, len(COEF_NAMES)))
    F[:, -1] = 1.0
    F[:, rng.integers(0, len(COEF_NAMES) - 1)] = 0.0   # one unsupported
    n_fill = rng.integers(1, 9, n)
    y = F @ rng.uniform(1e-12, 1e-9, len(COEF_NAMES)) * rng.uniform(
        0.9, 1.1, n)
    got = tune.fit_profile(F, n_fill, y)
    want = ref_tune.fit_profile(F, n_fill, y)
    np.testing.assert_allclose(got["coef"], want["coef"], rtol=1e-12,
                               atol=0)
    assert got["combine"] == want["combine"]
    assert got["fitted"] == want["fitted"]
    assert got["n_trimmed"] == want["n_trimmed"]
    assert got["deviation"] == pytest.approx(want["deviation"], rel=1e-12)


def test_injected_calibration_equals_reference(injected):
    _, got, _, want = injected
    np.testing.assert_allclose(got.profile.coef, want.profile.coef,
                               rtol=1e-9, atol=0)
    assert got.profile.combine == want.profile.combine
    assert got.report["deviation"] == pytest.approx(
        want.report["deviation"], rel=1e-9)
    assert got.report["n_samples"] == want.report["n_samples"]
    assert got.report["skipped"] == want.report["skipped"]
    assert got.profile.hash() == want.profile.hash()
    assert got.report["stacked"]["n_samples"] == 0
    assert got.model.fit_mape == pytest.approx(want.model.fit_mape,
                                               rel=1e-9)


def test_calibrated_search_equals_reference(injected):
    g, got, g_ref, want = injected
    s = pathsearch.search(g, ZU2, evaluator=tune.CalibratedEvaluator(
        g, ZU2, got.profile))
    r = ref_pathsearch.search(g_ref, REF_ZU2,
                              evaluator=ref_tune.CalibratedEvaluator(
                                  g_ref, REF_ZU2, want.profile))
    assert [list(x) for x in s.groups] == [list(x) for x in r.groups]
    assert [list(x) for x in s.horizontal] == [list(x) for x in r.horizontal]
    assert s.cost == pytest.approx(r.cost, rel=1e-9)
    assert s.meta["profile_hash"] == r.meta["profile_hash"]
    assert s.meta["evaluator"] == "CalibratedEvaluator"


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_profile_json_loads_in_both_packages(writer, tmp_path):
    path = str(tmp_path / "p.json")
    mine, theirs = _profile(tune), _profile(ref_tune)
    assert mine.hash() == theirs.hash()
    if writer == "port":
        tune.save_profile(mine, path)
        loaded = ref_tune.load_profile(path)
    else:
        ref_tune.save_profile(theirs, path)
        loaded = tune.load_profile(path)
    assert loaded.hash() == mine.hash()
    assert dataclasses.asdict(loaded) == dataclasses.asdict(mine)
    with open(path) as f:
        assert json.load(f)["hash"] == mine.hash()


# ---------------------------------------------------------- profile store
def test_profile_cache_keys_on_toolchain_and_gpu(tmp_path):
    cache = tune.ProfileCache(str(tmp_path))
    k = cache.key("h100", "fused")
    assert k == cache.key("h100", "fused", _toolchain_version(), _gpu_name())
    assert torch.__version__.split("+")[0] in k and "/" not in k
    assert k != cache.key("h100", "fused", gpu="NVIDIA H100 80GB HBM3")
    assert k != cache.key("h100", "ref")
    p = _profile(tune, jax_version=_toolchain_version(),
                 meta={"gpu": _gpu_name()})
    cache.put(p)
    assert cache.get("zu2", "fused") == p
    assert cache.get("zu2", "fused", gpu="other") is None
    assert cache.get_by_name("unit") == p
    assert tune.resolve_profile("unit", cache=cache) == p
    with pytest.raises(KeyError, match="no profile named"):
        tune.resolve_profile("absent", cache=cache)


def test_h100_model_from_the_kernel():
    assert get_device("h100") is H100
    assert (H100.ic_p, H100.oc_p, H100.h_p) == (32, 8 * ops.conv_nt(32), 16)
    assert H100.onchip_bytes <= ops.SMEM_MAX
    for f in ("buf_in_bytes", "buf_weights_bytes", "buf_out_bytes"):
        assert getattr(H100, f) <= getattr(ZU2, f)
    assert H100.peak_ops_per_s == 1.979e15
    assert H100.dram_bw_bytes_per_s == 3.35e12


# -------------------------------------------------------- kernel features
class _Shapes:
    """``shape`` of the tensors one hand-made chain launch reads."""

    def __init__(self, shapes):
        self.shapes = shapes

    def shape(self, name):
        return self.shapes[name]


def _hand_launch(i, tile):
    chain, (h, w, c), wshape, sshape, oc = HAND_CHAINS[i]
    shapes = {"x": (2, h, w, c)}
    for st in chain:
        if st[0] == "conv":
            shapes[st[1]] = (2, st[12], st[13], oc)
    last = chain[-1]
    oh, ow = ((last[12], last[13]) if last[0] == "conv" else
              (last[9], last[10]) if last[0] == "pool" else
              (last[5], last[6]))
    launch = lower.FusedLaunch(
        kind="chain", nodes=tuple(st[1] for st in chain), in_name="x",
        out_name=chain[-1][1], stages=chain,
        sides=("s",) if sshape else (), out_hw=(oh, ow), tile=tile)
    return _Shapes(shapes), launch


@pytest.mark.parametrize("tile", [(3, 2, 1), (1, 1, 2), (5, 4, 1)])
@pytest.mark.parametrize("i", range(len(HAND_CHAINS)))
def test_kernel_chain_vec_counts_from_the_descriptor(i, tile):
    """The kernel-domain vector, worked out from the fields of the packed
    descriptor the kernel is launched with (``chain_plan``); ``tile`` gives
    (th, tw, OC / toc)."""
    oc = HAND_CHAINS[i][4]
    tile = (tile[0], tile[1], oc // tile[2])
    g, launch = _hand_launch(i, tile)
    oh, ow, oc, c_in, oc_list = ev_mod.chain_geometry_of(g, launch)
    t, why = ops.card_tile(launch.stages, oh, ow, oc, c_in, oc_list, tile)
    assert why is None
    d, _ = ops.chain_plan(launch.stages, oh, ow, oc, c_in, oc_list, t)
    th, tw, toc, n_h, n_w, n_k = (int(v) for v in d[17:23])
    blocks = 2 * n_h * n_w * n_k
    rd = int(d[8] * d[9] * d[10])
    wr = th * tw * toc
    conv = pool = misc = steps = n_pool = n_elt = 0
    for j, st in enumerate(launch.stages):
        s = d[ops.HDR + ops.STG * j:ops.HDR + ops.STG * (j + 1)]
        rows, cols, cin, cout = (int(v) for v in s[12:16])
        if st[0] == "conv":
            kp, nt = int(s[16]), ops.conv_nt(cout)
            panel = -(-cout // (8 * nt)) * 8 * nt * kp
            staged = not (int(d[31]) >> j) & 1
            rd += panel * (1 if staged else -(-rows * cols // 16))
            conv += rows * cols * cin * st[2] * st[3] * cout
            steps += (-(-rows * cols // 16) * -(-cout // (8 * nt))
                      * (kp // 32) * nt)
        elif st[0] == "pool":
            pool += rows * cols * cout * st[3] * st[4]
            n_pool += 1
        else:
            rd += rows * cols * cout
            misc += rows * cols * cout
            n_elt += 1
    want = np.array([rd, wr, conv, pool, misc, steps, n_pool, n_elt, 1, 0],
                    float) * blocks
    want[-1] = 1.0
    np.testing.assert_array_equal(ev_mod._chain_vec(g, launch), want)


def test_kernel_horizontal_vec_follows_the_card_plan():
    g, _, _ = port_model("googlenet", 32)
    prog = lower.lower_strategy(g, strategy("repro_torch", g))
    hs = [it for it in prog.launches() if it.kind == "horizontal"]
    assert hs
    for it in hs:
        f = ev_mod._horizontal_vec(g, it)
        oc = sum(m[1] for m in it.members)
        m = it.out_hw[0] * it.out_hw[1]
        plan = ops.horizontal_plan(m, oc, g.shape(it.in_name)[3])
        assert f[COEF_NAMES.index("cells")] == np.prod(plan["grid"])
        assert f[COEF_NAMES.index("conv")] == m * g.shape(it.in_name)[3] * oc
        # a tile record does not move a horizontal launch
        tiled = dataclasses.replace(it, tile=(1, 1, 8))
        np.testing.assert_array_equal(ev_mod._horizontal_vec(g, tiled), f)
        assert tiles.default_shape(g, it) is None
        assert tiles.shape_candidates(g, H100, it) == []


def test_shape_candidates_fit_the_card_at_224():
    """Every candidate under H100 fits a block's shared memory and divides
    OC; GoogLeNet-224's launches all get some, and any candidate the card
    cannot run is reported with its reason."""
    g = build_graph("repro_torch", "googlenet", 224)
    prog = lower.lower_strategy(g, strategy("repro_torch", g))
    n_chain = 0
    for it in prog.launches():
        if it.kind != "chain":
            continue
        n_chain += 1
        oh, ow, oc, c_in, oc_list = ev_mod.chain_geometry_of(g, it)
        cands, dropped = tiles._candidates(g, H100, it, 16)
        assert cands, it.nodes
        for th, tw, toc in cands:
            assert oc % toc == 0 and th <= oh and tw <= ow
            _, smem = ops.chain_plan(it.stages, oh, ow, oc, c_in, oc_list,
                                     (th, tw, toc))
            assert smem <= ops.SMEM_MAX
        assert all(d["reason"] for d in dropped)
    assert n_chain == 42


# -------------------------------------------------------------- tile search
class _FakeHarness:
    """Measures every tile variant: the card's default (no record) at
    1 s, a candidate at 1 s over its tile's volume, plus 0.5 s."""
    min_measurable_s = 0.0

    def __init__(self):
        self.seen = []

    def measure_item_set(self, items, passes=None):
        self.seen += items
        return [Measurement(nodes=it.nodes, kind=it.kind,
                            seconds=(1.0 if not it.tile else
                                     0.5 + 1.0 / float(np.prod(it.tile))),
                            spread=0.0, n_samples=1, n_rejected=0)
                for it in items]


def _tuned(model="googlenet", img=32):
    g, qm, xq = port_model(model, img)
    s = strategy("repro_torch", g)
    h = _FakeHarness()
    rep = tune.search_tile_shapes(g, qm, H100, s, harness=h, top_k=2)
    return g, qm, xq, s, rep, h


def test_search_tile_shapes_records_the_measured_winner():
    g, qm, _, s, rep, h = _tuned()
    assert rep.source == "measured" and s.meta["tile_source"] == "measured"
    assert rep.n_units == len(lower.lower_strategy(g, s, qm).launches())
    chains = [u for u in rep.provenance if u["kind"] == "chain"]
    horiz = [u for u in rep.provenance if u["kind"] == "horizontal"]
    assert horiz and all(u["chosen"] is None and u["source"] == "card_plan"
                         and u["card_plan"]["grid"] for u in horiz)
    assert not any(it.kind == "horizontal" for it in h.seen)
    n_tuned = 0
    for u in chains:
        default = next(c for c in u["candidates"] if c["default"])
        assert default["shape"] == u["default"]
        others = [c for c in u["candidates"] if not c["default"]]
        if not others:
            assert u["chosen"] is None
            continue
        win = min(others, key=lambda c: c["measured"])
        assert u["chosen"] == win["shape"] != u["default"]
        assert s.meta["tile_shapes"][u["key"]] == win["shape"]
        n_tuned += 1
    assert rep.n_tuned == n_tuned == len(s.meta["tile_shapes"]) > 0
    assert s.meta["tile_provenance"] is rep.provenance


def test_profile_tile_search_and_predicted_shapes():
    """Without a harness the profile-predicted best is recorded; under a
    per-block-dominated profile, fewer blocks always predict faster."""
    g, qm, _ = port_model("googlenet", 32)
    coef = [0.0] * len(COEF_NAMES)
    coef[COEF_NAMES.index("cells")] = 1e-4
    coef[COEF_NAMES.index("rd")] = 1e-12
    p = _profile(tune, coef=tuple(coef), device="h100")
    s = strategy("repro_torch", g)
    rep = tune.search_tile_shapes(g, qm, H100, s, profile=p)
    assert rep.source == "profile" and rep.n_tuned > 0
    for u in rep.provenance:
        if u["chosen"] is not None:
            pred = {tuple(c["shape"]): c["predicted"]
                    for c in u["candidates"]}
            assert pred[tuple(u["chosen"])] < pred[tuple(u["default"])]
    s2 = pathsearch.search(g, ZU2, evaluator=tune.CalibratedEvaluator(
        g, ZU2, p))
    assert s2.meta["tile_source"] == "profile" and s2.meta["tile_shapes"]


@pytest.mark.parametrize("model,img", MODELS)
def test_tuned_cpu_session_equals_reference_executor(model, img):
    """int8 outputs bit for bit; GoogLeNet's host softmax at 1e-6, as in
    tests/test_torch_executor.py."""
    g, qm, xq, s, rep, _ = _tuned(model, img)
    g_ref, _, _, qm_ref, _ = reference_model(model, img)
    want = ref_executor.Int8Executor(g_ref, qm_ref, strategy=None,
                                     backend="ref")(xq)
    ops.reset_counts()
    sess = Session(g, s, ZU2, qm, device="cpu", cache=asm.PlanCache())
    assert sess.artifact.tile_shapes == rep.tile_shapes
    got = sess.run(xq)
    assert ops.TILE_RECORDS["applied"] == rep.n_tuned > 0
    assert ops.LAUNCHES == {"fused_chain": 0, "fused_horizontal": 0}
    for k in want:
        w, o = np.asarray(want[k]), got[k].numpy()
        assert o.dtype == w.dtype and o.shape == w.shape
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(o, w)
        else:
            np.testing.assert_allclose(o, w, rtol=0, atol=1e-6)
    assert [t["tile"] for t in sess.tile_summary() if t["tile"]] == [
        rep.tile_shapes[t["nodes"].replace("+", "|")]
        for t in sess.tile_summary() if t["tile"]]


def test_untuned_session_applies_no_tile_record():
    g, qm, xq = port_model("googlenet", 32)
    ops.reset_counts()
    Session(g, strategy("repro_torch", g), ZU2, qm, device="cpu",
            cache=asm.PlanCache()).run(xq)
    assert ops.TILE_RECORDS["applied"] == 0


def test_tile_record_the_card_cannot_run_raises():
    g, qm, xq = port_model("toy", 16)
    s = strategy("repro_torch", g)
    prog = lower.lower_strategy(g, s, qm)
    chain = next(it for it in prog.launches() if it.kind == "chain"
                 and any(st[0] == "conv" for st in it.stages))
    s.meta["tile_shapes"] = {lower.tile_key(chain.nodes): [4, 4, 7]}
    ex = executor.Int8Executor(g, qm, strategy=s, backend="fused",
                               device="cpu")
    with pytest.raises(ValueError, match="re-run the tile search"):
        ex(xq)
    g224 = build_graph("repro_torch", "googlenet", 224)
    conv1 = lower.lower_strategy(g224, strategy("repro_torch", g224)
                                 ).launches()[0]
    big = dataclasses.replace(conv1, tile=(112, 112, 64))
    ocs = [g224.shape(st[1])[3] for st in big.stages if st[0] == "conv"]
    with pytest.raises(ValueError, match="shared memory"):
        ops.launch_tile(big, g224.shape(big.in_name), ocs)


# --------------------------------------------------------- harness on CPU
def test_harness_measures_units_on_the_cpu():
    g, qm, _ = port_model("toy", 16)
    h = tune.MeasurementHarness(g, qm, ZU2, device="cpu", repeats=3)
    assert h.min_measurable_s == 5e-4
    m = h.measure_group(["c1"])
    assert m.seconds > 0 and m.kind == "chain" and len(m.samples) == 3
    assert h.measure_group(["c1"]) is m
    ms = h.measure_set([["c1"], ["c2a", "c2b"]], passes=2)
    assert all(x.seconds > 0 for x in ms) and len(ms[1].samples) == 2
    ref = tune.MeasurementHarness(g, qm, ZU2, device="cpu", repeats=2,
                                  backend="ref")
    m_s, m_n = ref.measure_strategy_set(
        [strategy("repro_torch", g), strategy("repro_torch", g, "naive")],
        passes=2)
    assert m_s.kind == "e2e" and m_n.seconds > 0 and len(m_s.samples) == 2
    sec, spread, n_ok, n_rej, samples = tune.time_callable(
        lambda a: a + 1, [torch.zeros(4)], repeats=4)
    assert sec > 0 and n_ok + n_rej == len(samples) == 4


def test_group_callable_and_on_board_evaluator_on_the_cpu():
    g, qm, _ = port_model("toy", 16)
    fn, ins = executor.build_group_callable(g, ["c1", "c2a"], qm,
                                            device="cpu")
    assert [tuple(t.shape) for t in ins] == [g.shape("data")]
    assert ins[0].dtype == torch.int8 and int(ins[0].min()) < -100
    ex = executor.Int8Executor(g, qm, backend="ref", device="cpu")
    env = {"data": ins[0]}
    for nm in ("c1", "c2a"):
        env[nm] = executor._int8_node(g, g.nodes[nm], env, qm, ex._wts)
    assert torch.equal(fn(*ins), env["c2a"])
    params = reference_model("toy", 16)[1]
    assert OnBoardEvaluator(g, params, device="cpu")(["c1"]) > 0


def test_calibrate_measures_stacked_launches_on_the_cpu():
    g, qm, _ = port_model("googlenet", 32)
    res = tune.calibrate(g, qm, ZU2, device="cpu", repeats=2, max_samples=10,
                         min_measurable_s=0.0)
    assert res.report["stacked"]["n_samples"] >= 1
    assert res.profile.backend == "fused"
    assert res.profile.jax_version == _toolchain_version()
    assert res.profile.meta["gpu"] == _gpu_name() == "cpu"
    assert any(m.kind == "horizontal" for m in res.measurements)
    assert np.isfinite(res.report["deviation"])


def test_lower_with_profile_stamps_predicted_tiles():
    g, qm, _ = port_model("googlenet", 32)
    coef = [0.0] * len(COEF_NAMES)
    coef[COEF_NAMES.index("cells")] = 1e-4
    p = _profile(tune, coef=tuple(coef))
    from repro_torch.stages import wrap
    lo = wrap(g, qm, ZU2, cache=None).lower(profile=p, cache=None)
    assert lo.strategy.meta["evaluator"] == "CalibratedEvaluator"
    assert lo.profile_hash == p.hash()
    tiled = [it for it in lo.program.launches() if it.tile]
    assert tiled and all(it.kind == "chain" for it in tiled)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = Session(g, lo.strategy, ZU2, qm, device="cpu", profile=p,
                      cache=asm.PlanCache())
    assert out.artifact.profile_hash == p.hash()
