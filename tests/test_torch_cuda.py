"""The port's CUDA kernels and the fused executor on the card, against the
plain versions (int8 bit equality for the conv kernels, the stated
tolerances for flash attention and the linear scan), with the port alone
(no jax).
Marked ``cuda``: they skip where CUDA is absent; on a GPU machine run
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core import executor, lower, quantize
from repro_torch.kernels.conv_fused import ops
from torch_common import (EXTREME_SHIFTS, GOOGLENET_HORIZONTAL, HAND_CHAINS,
                          RAGGED_HORIZONTAL, build_graph, extreme_chain_args,
                          extreme_horizontal_args, hand_chain_args,
                          horizontal_args, strategy)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; CUDA is not available here")
    return torch.device("cuda")


@pytest.mark.parametrize("i", range(len(HAND_CHAINS)))
def test_chain_kernel_matches_plain_on_hand_chains(dev, i):
    chain, x, w, b, sides, oh, ow, oc = hand_chain_args(
        i, np.random.default_rng(i))
    args = (torch.as_tensor(x, device=dev),
            [torch.as_tensor(t, device=dev) for t in w],
            [torch.as_tensor(t, device=dev) for t in b],
            [torch.as_tensor(t, device=dev) for t in sides])
    want = ops.fused_chain_plain(*args, chain=chain, oh=oh, ow=ow, oc=oc)
    for tile in (None, (1, 1, oc), (3, 2, oc)):
        got = ops.fused_chain(*args, chain=chain, oh=oh, ow=ow, oc=oc,
                              tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(got, want), tile


# (model, img, planning target) of the model tests on the card: GoogLeNet
# and ResNet50 under ZU2, and the paper's other CNNs under both targets
# (VGG16 at 32 under ZU9 lowers a 9-stage chain whose windows the card cuts;
# YOLO-lite at 128 under ZU9 is one 10-stage chain)
CARD_MODELS = [("googlenet", 64, "ZU2"), ("resnet50", 32, "ZU2")] + [
    (model, img, target) for model, img in (("vgg16", 32), ("resnet152", 32),
                                            ("yolo_lite", 128))
    for target in ("ZU2", "ZU9")]


@pytest.mark.parametrize("model,img,target", CARD_MODELS)
def test_chain_kernel_matches_plain_on_model_launches(dev, model, img,
                                                      target):
    """Every chain launch of the model, weights packed once as the executor
    packs them, bit-equal to the plain version: at batch 2 at the
    planner's tile and at forced ones (ragged, one pixel, half the
    channels), and at batch 5 at the planner's tile (several images a
    block where it picks them), at its spatial tile with two and four
    images a block and at a one-pixel tile with two (a ragged last group of
    one), where they fit.  ResNet50 at 32 includes
    chains whose weight panels are too large for shared memory beside the
    rest (they stream through the weight ring)."""
    from torch_common import port_model
    g, qm, _ = port_model(model, img)
    prog = lower.lower_strategy(g, strategy("repro_torch", g, target=target),
                                qm)
    rng = np.random.default_rng(3)
    n_ring = n_ragged = n_multi = 0
    for launch in prog.launches():
        if launch.kind != "chain":
            continue
        prep = ops.prepare_launch(launch, qm, dev)
        w = prep["weights"]
        for n in (2, 5):
            x = torch.as_tensor(rng.integers(-128, 128, (n,) + tuple(
                g.shape(launch.in_name)[1:])).astype(np.int8), device=dev)
            if launch.fc_reshape:
                x = x.reshape(n, 1, 1, -1)
            sides = [torch.as_tensor(rng.integers(-128, 128, (n,) + tuple(
                g.shape(sd)[1:])).astype(np.int8), device=dev)
                for sd in launch.sides]
            oc = int(w[-1].shape[-1]) if w else int(x.shape[-1])
            kw = dict(chain=launch.stages, oh=launch.out_hw[0],
                      ow=launch.out_hw[1], oc=oc)
            want = ops.fused_chain_plain(x, w, prep["biases"], sides, **kw)
            oc_list = ops.launch_geometry(launch, g.shape(launch.in_name),
                                          [t.shape[-1] for t in w])[4]
            c_in = int(x.shape[-1])
            geom = ((tuple(x.shape), x.stride()),
                    tuple(tuple(t.shape) for t in w),
                    tuple(tuple(t.shape) for t in prep["biases"]),
                    tuple((tuple(sd.shape), sd.stride()) for sd in sides))
            desc = ops._chain_call(launch.stages, kw["oh"], kw["ow"], oc,
                                   None, *geom)[0]
            if n == 2:
                tiles = (None, (3, 5, oc), (1, 1, oc),
                         (2, 2, oc // 2 if oc % 2 == 0 else oc))
                n_ring += int(desc[31] != 0)
            else:
                card = tuple(int(v) for v in desc[17:20])
                tiles = (None, card + (2,), card + (4,), (1, 1, oc, 2))
            for tile in tiles:
                ops.reset_counts()
                why = tile and ops.card_tile(launch.stages, kw["oh"],
                                             kw["ow"], oc, c_in, oc_list,
                                             tile)[1]
                if why:      # a forced tile the card cannot run raises
                    with pytest.raises(ValueError, match="shared memory"):
                        ops.fused_chain(x, w, prep["biases"], sides, **kw,
                                        tile=tile, packed=prep["packed"])
                    assert not any(ops.LAUNCHES.values())
                    continue
                got = ops.fused_chain(x, w, prep["biases"], sides, **kw,
                                      tile=tile, packed=prep["packed"])
                torch.cuda.synchronize()
                assert ops.LAUNCHES["fused_chain"] == 1
                assert torch.equal(got, want), (launch.nodes, n, tile)
                ni = int(ops._chain_call(
                    launch.stages, kw["oh"], kw["ow"], oc,
                    None if tile is None else tuple(tile), *geom)[0][34])
                n_multi += int(ni > 1)
                n_ragged += int(ni > 1 and n % ni != 0)
    assert n_ragged > 0 or n_multi == 0
    if model in ("googlenet", "resnet50"):
        assert (n_ring > 0) == (model == "resnet50")


@pytest.mark.parametrize("shape", GOOGLENET_HORIZONTAL + RAGGED_HORIZONTAL)
def test_horizontal_kernel_matches_plain(dev, shape):
    """Bit equality with the plain version at batch 1 (GoogLeNet's own
    launches; split-K where the grid is small) and 2, with the weights
    packed once by the caller and packed by the wrapper."""
    rng = np.random.default_rng(sum(shape))
    for n in (1, 2):
        x, w, b, sh, rl, stride, pad = horizontal_args(shape, n, rng)
        args = [torch.as_tensor(t, device=dev) for t in (x, w, b, sh, rl)]
        want = ops.fused_horizontal_plain(*args, stride=stride, pad=pad)
        packed = ops.pack_horizontal(*args[1:])
        for pk in (packed, None):
            ops.reset_counts()
            got = ops.fused_horizontal(*args, stride=stride, pad=pad,
                                       packed=pk)
            torch.cuda.synchronize()
            assert ops.LAUNCHES["fused_horizontal"] == 1
            assert not ops.PLAIN_CALLS["fused_horizontal"]
            assert torch.equal(got, want), (n, pk is None)


@pytest.mark.parametrize("model,img,target", [("toy", 16, "ZU2")]
                         + CARD_MODELS)
def test_fused_executor_matches_ref_on_card(dev, model, img, target):
    from repro_torch.cnn import init_params
    g = build_graph("repro_torch", model, img)
    x = np.random.default_rng(0).standard_normal(
        g.shape("data")).astype(np.float32)
    qm = quantize.calibrate(g, init_params(g), x, lambda g_, p_, x_:
                            executor.run_float(g_, p_, x_, device=dev))
    xq = quantize.quantize_to(x, qm.f_a["data"])
    s = strategy("repro_torch", g, target=target)
    ops.reset_counts()
    got = executor.Int8Executor(g, qm, strategy=s, backend="fused",
                                device=dev)(xq)
    want = executor.Int8Executor(g, qm, strategy=None, backend="ref",
                                 device=dev)(xq)
    prog = lower.lower_strategy(g, s, qm)
    assert ops.LAUNCHES["fused_chain"] + ops.LAUNCHES["fused_horizontal"] \
        == prog.meta["n_launches"]
    assert not any(ops.PLAIN_CALLS.values())
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_time_callable_times_with_cuda_events(dev, monkeypatch):
    """On a CUDA input each sample is CUDA-event device time over queued
    calls: two events a sample, and an elementwise add over 4 MB takes at
    least its bytes over the card's memory rate, well under a millisecond."""
    from repro_torch.tune import measure
    made = []
    event = torch.cuda.Event

    def counted(*a, **kw):
        made.append(event(*a, **kw))
        return made[-1]

    monkeypatch.setattr(torch.cuda, "Event", counted)
    x = torch.zeros(1 << 20, device=dev)
    sec, spread, n_ok, n_rej, samples = measure.time_callable(
        lambda t: t.add_(1), [x], repeats=3)
    assert len(made) == 6 and len(samples) == 3
    assert 8 * (1 << 20) / 3.35e12 <= sec < 1e-3


def test_tuned_session_bit_exact_on_card(dev):
    """GoogLeNet-32 tile-searched on the card (each chain forced to its
    fastest non-default candidate), then served: every record applied,
    the kernels only, and bit-exact against the ref executor."""
    from repro_torch import asm, tune
    from repro_torch.core import validate
    from repro_torch.hw import H100, ZU2
    from repro_torch.runtime import Session
    from torch_common import port_model
    g, qm, xq = port_model("googlenet", 32)
    s = strategy("repro_torch", g)
    h = tune.MeasurementHarness(g, qm, H100, device=dev, repeats=2)
    rep = tune.search_tile_shapes(g, qm, H100, s, harness=h, top_k=2)
    forced = {}
    for u in rep.provenance:
        others = [c for c in u["candidates"] if not c["default"]]
        if others:
            forced[u["key"]] = min(others, key=lambda c: c["measured"])[
                "shape"]
    assert forced
    s.meta["tile_shapes"] = forced
    ops.reset_counts()
    sess = Session(g, s, ZU2, qm, device=dev, cache=asm.PlanCache())
    sess.run(xq)
    torch.cuda.synchronize()
    assert ops.TILE_RECORDS["applied"] == len(forced)
    assert not any(ops.PLAIN_CALLS.values())
    assert validate.bit_exact(g, qm, xq, s, device=dev)


def test_drift_measures_on_card_against_its_own_calibration(dev):
    """GoogLeNet-32 calibrated on the card, then a drift profiler with the
    default measurement (CUDA-event device time, the executor's prepared
    weights): every unit measured on the card, and a profile with doubled
    coefficients (halved rates) drifts where the card's own does not."""
    import dataclasses

    from repro_torch import asm, tune
    from repro_torch.hw import ZU2
    from repro_torch.obs import DriftProfiler, MetricsRegistry
    from repro_torch.runtime import Session
    from torch_common import port_model
    g, qm, xq = port_model("googlenet", 32)
    prof = tune.calibrate(g, qm, ZU2, harness=tune.MeasurementHarness(
        g, qm, ZU2, device=dev)).profile
    sess = Session(g, strategy("repro_torch", g), ZU2, qm, device=dev,
                   cache=asm.PlanCache())
    halved = dataclasses.replace(prof, coef=tuple(2 * c for c in prof.coef))
    reports = {}
    for name, p in (("own", prof), ("halved", halved)):
        dp = DriftProfiler.from_session(sess, profile=p, every=2,
                                        registry=MetricsRegistry())
        assert dp.device == sess.device
        dp.prepare()
        sess.attach_drift(dp)
        ops.reset_counts()
        for _ in range(2):
            sess.run(xq)
        torch.cuda.synchronize()
        sess.attach_drift(None)
        assert not any(ops.PLAIN_CALLS.values())
        assert ops.LAUNCHES["fused_chain"] > 2 * len(
            [it for it in sess.program.launches() if it.kind == "chain"])
        reports[name] = dp.report()
    own, bad = reports["own"], reports["halved"]
    assert own.n_sampled == 1 and own.units
    assert all(0 < u.measured < 1e-2 for u in own.units)
    assert not own.drifted, own.aggregate
    assert bad.drifted and bad.aggregate > bad.band


def test_two_replica_fleet_on_one_card_bit_exact(dev):
    """Two replicas wrapped onto one card under a chaos kill: every answer
    equal to the session's, the only failed attempts the injected ones,
    the kernels only."""
    from repro_torch import asm
    from repro_torch.hw import ZU2
    from repro_torch.runtime import ChaosInjector, Fleet, Session
    from torch_common import port_model
    g, qm, _ = port_model("googlenet", 32)
    art = asm.compile_strategy(g, strategy("repro_torch", g), ZU2, qm=qm)
    sess = Session.from_artifact(art, device=dev, cache=asm.PlanCache())
    rng = np.random.default_rng(5)
    xs = [rng.integers(-128, 128, g.shape("data")[1:]).astype(np.int8)
          for _ in range(16)]
    wants = [sess.run(x) for x in xs]
    fleet = Fleet(art, n_replicas=2, devices=[torch.device("cuda", 0)],
                  check_interval_s=0.01, probe_interval_s=0.05)
    chaos = ChaosInjector().attach(fleet)
    try:
        assert [r.session.device for r in fleet.replicas().values()] == \
            [torch.device("cuda", 0)] * 2
        ops.reset_counts()
        chaos.kill("r1", after_launches=2)
        futs = [fleet.submit(x) for x in xs]
        for fut, want in zip(futs, wants):
            got = fut.result(timeout=120)
            for k in want:
                assert torch.equal(got[k], want[k])
        assert not any(ops.PLAIN_CALLS.values())
        errors = [r for r in fleet.flight.records() if r.status == "error"]
        assert all(r.error.startswith("ChaosError") for r in errors)
        chaos.heal("r1")
        assert fleet.wait_active("r1", timeout_s=30)
    finally:
        chaos.heal_all()
        fleet.close()


@pytest.mark.parametrize("shift", EXTREME_SHIFTS)
def test_conv_kernels_match_plain_at_int32_extremes(dev, shift):
    """round_shift where the reference's int32 arithmetic wraps: biases
    within 2^20 of +-2^31 and shifts past 31, in the chain kernel's conv
    and elt stages and in the horizontal kernel (shifts 1, 31, 32, 33 and
    40 on its siblings)."""
    chain, x, w, b, sides, oh, ow, oc = extreme_chain_args(
        shift, np.random.default_rng(shift))
    args = (torch.as_tensor(x, device=dev),
            [torch.as_tensor(t, device=dev) for t in w],
            [torch.as_tensor(t, device=dev) for t in b],
            [torch.as_tensor(t, device=dev) for t in sides])
    want = ops.fused_chain_plain(*args, chain=chain, oh=oh, ow=ow, oc=oc)
    for tile in (None, (1, 1, oc), (3, 2, oc)):
        got = ops.fused_chain(*args, chain=chain, oh=oh, ow=ow, oc=oc,
                              tile=tile)
        torch.cuda.synchronize()
        assert torch.equal(got, want), tile
    for n in (1, 2):
        xh, wh, bh, sh, rl, stride, pad = extreme_horizontal_args(
            np.random.default_rng(shift + n), n)
        a = [torch.as_tensor(t, device=dev) for t in (xh, wh, bh, sh, rl)]
        got = ops.fused_horizontal(*a, stride=stride, pad=pad)
        torch.cuda.synchronize()
        assert torch.equal(got, ops.fused_horizontal_plain(
            *a, stride=stride, pad=pad)), n


@pytest.mark.parametrize("model,img", [("toy", 16), ("googlenet", 32)])
def test_artifact_round_trip_on_card(dev, model, img, tmp_path):
    """Compile, save, load and run the loaded artifact's stored program
    through the kernels: bit-equal to the in-memory artifact and to the
    unfused oracle, all on the card, and a reopened Session serves it with
    no recompile."""
    from repro_torch import asm
    from repro_torch.cnn import init_params
    from repro_torch.core import validate
    from repro_torch.hw import ZU2
    from repro_torch.runtime import Session
    g = build_graph("repro_torch", model, img)
    x = np.random.default_rng(0).standard_normal(
        g.shape("data")).astype(np.float32)
    qm = quantize.calibrate(g, init_params(g), x, lambda g_, p_, x_:
                            executor.run_float(g_, p_, x_, device=dev))
    xq = quantize.quantize_to(x, qm.f_a["data"])
    s = strategy("repro_torch", g)
    ops.reset_counts()
    rep = validate.artifact_round_trip(g, qm, xq, s, ZU2,
                                       str(tmp_path / "m.npz"), device=dev)
    assert rep.bit_exact, rep.max_abs_diff
    assert ops.LAUNCHES["fused_chain"] > 0 and not any(
        ops.PLAIN_CALLS.values())
    cache = asm.PlanCache()
    sess = Session(g, s, ZU2, qm, device=dev, cache=cache)
    asm.save_artifact(sess.artifact, str(tmp_path / "s.npz"))
    re = Session.from_artifact(asm.load_artifact(str(tmp_path / "s.npz")),
                               device=dev, cache=cache)
    assert re.cache_hit and cache.misses == 1
    assert re.executor.program is re.artifact.program
    want, got = sess.run(xq), re.run(xq)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("b,sq,sk,h,kv,d,off,causal", [
    (2, 100, 100, 6, 2, 64, 0, True),        # ragged tiles, GQA 3:1
    (1, 256, 256, 15, 5, 64, 0, True),       # SmolLM-360M's grouping
    (2, 200, 333, 15, 5, 64, 0, True),       # same, Sq and Sk ragged
    (2, 128, 384, 32, 8, 128, 256, True),    # Granite's, q_offset tail
    (1, 64, 200, 4, 4, 32, 0, False),        # full attention
    (1, 48, 48, 2, 1, 16, 0, True),
])
def test_flash_kernel_matches_plain(dev, b, sq, sk, h, kv, d, off, causal):
    """fp32 (TF32 off) against the plain version at 2e-5.  bf16 and fp16
    against the kernel's arithmetic in fp32 (``attention_fp32``: q scaled in
    the input dtype, fp32 scores, weights and products) at two unit
    roundoffs of the output dtype relative to each row's largest value: the
    kernel may differ from it only by the rounding of its output and the
    residue of its split P."""
    from repro_torch.kernels.flash_attention import ops as flash

    gen = torch.Generator(device=dev).manual_seed(sq + h)
    torch.backends.cuda.matmul.allow_tf32 = False
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
                   for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
        flash.reset_counts()
        got = flash.flash_attention(q, k, v, q_offset=off, causal=causal)
        torch.cuda.synchronize()
        assert flash.LAUNCHES["flash_attention"] == 1
        assert not flash.PLAIN_CALLS["flash_attention"]
        if dtype == torch.float32:
            want = flash.attention_ref(q, k, v, q_offset=off, causal=causal)
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        else:
            want = flash.attention_fp32(q, k, v, q_offset=off, causal=causal)
            assert flash.row_rel_err(got, want) <= flash.OUT_REL_TOL[dtype]


@pytest.mark.parametrize("b,s,h,dk,dv,bcast", [
    (2, 200, 3, 64, 96, False),       # ragged sub-chunk, V not a slab multiple
    (2, 256, 2, 40, 24, False),       # K != V, K not a tile multiple
    (1, 256, 32, 64, 128, True),      # Zamba2's heads, q/k with stride 0
    (1, 128, 1, 1024, 64, False),     # xLSTM's head dim, narrow V
    (1, 32, 2, 8, 8, False),
    (2, 100, 3, 20, 13, False),       # K, V not multiples of 8: loads by
                                      # element on the bf16 route
    (1, 130, 2, 512, 40, False),      # the bf16 route's K <= 512 variant
])
def test_ssm_scan_kernel_matches_plain(dev, b, s, h, dk, dv, bcast):
    """Each dtype's route at every column slab width it takes: fp32 against
    ``chunked_linear_scan`` at 2e-4 of each output row's largest value (the
    JAX package's Pallas-vs-chunked tolerance), bf16 (the tensor-core
    route) and fp16 against ``scan_fp32`` at ``OUT_REL_TOL``, and bf16
    element by element: at most ``ROUND_SHARE_TOL`` of its elements differ
    from ``scan_fp32`` rounded to bf16."""
    from repro_torch.kernels.ssm_scan import ops as scan
    from repro_torch.nn import recurrent as rec

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(s + dk)
    hq = 1 if bcast else h
    q, k = ((torch.randn((b, s, hq, dk), generator=gen, device=dev)
             / dk ** 0.5).expand(b, s, h, dk) for _ in range(2))
    v = torch.randn((b, s, h, dv), generator=gen, device=dev)
    la = torch.nn.functional.logsigmoid(
        torch.randn((b, s, h), generator=gen, device=dev))
    want32 = rec.chunked_linear_scan(q, k, v, la, chunk=rec.chunk_for(s))[0]
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        qt, kt, vt = (t.to(dtype) for t in (q, k, v))
        want = want32 if dtype == torch.float32 else scan.scan_fp32(
            qt, kt, vt, la)
        tol = scan.OUT_REL_TOL.get(dtype, 2e-4)
        widths = scan.slabs(dtype, dk)
        assert widths
        for width in widths:
            scan.reset_counts()
            got = scan.launch(qt, kt, vt, la, width)
            torch.cuda.synchronize()
            assert scan.LAUNCHES["ssm_scan"] == 1
            assert got.dtype == dtype and torch.isfinite(got).all()
            assert scan.row_rel_err(got, want) <= tol, (dtype, width)
            if dtype == torch.bfloat16:
                assert scan.round_mismatch(got, want) <= \
                    scan.ROUND_SHARE_TOL, width
        scan.reset_counts()
        scan.ssm_scan(qt, kt, vt, la, chunk=rec.chunk_for(s))
        assert scan.LAUNCHES["ssm_scan"] == 1
        assert not scan.PLAIN_CALLS["ssm_scan"]


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-1.2b"])
def test_recurrent_prefill_on_card_matches_cpu(dev, arch):
    """fp32 smoke models: the card's prefill (one kernel launch per
    recurrent layer) against the CPU's (the plain scan) on the same
    weights, and the card's decode against its prefill."""
    from repro_torch import configs
    from repro_torch.kernels.ssm_scan import ops as scan
    from repro_torch.launch import serve
    from repro_torch.models import api

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get(arch).smoke()
    params = api.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    on_card = {k: ({kk: t.to(dev) for kk, t in v.items()}
                   if isinstance(v, dict) else v.to(dev))
               for k, v in params.items()}
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 200)))
    prefill = serve.make_prefill_step(cfg)
    want = prefill(params, {"tokens": toks})
    scan.reset_counts()
    got = prefill(on_card, {"tokens": toks.to(dev)})
    torch.cuda.synchronize()
    n_scans = (cfg.n_layers - cfg.n_layers // cfg.slstm_every
               if cfg.family == "ssm" else cfg.n_layers)
    assert scan.LAUNCHES["ssm_scan"] == n_scans
    assert not scan.PLAIN_CALLS["ssm_scan"]
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    cache = api.init_cache(cfg, 2, 32, dev)
    outs = []
    for t in range(32):
        lg, cache = api.decode_step(cfg, on_card, cache, toks[:, t].to(dev), t)
        outs.append(lg)
    torch.testing.assert_close(torch.stack(outs, 1).cpu(), want[:, :32],
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("b,s,h,dk,dv,bcast", [
    (2, 256, 4, 64, 64, False), (2, 128, 8, 16, 32, True),
    (1, 200, 2, 24, 40, False)])
def test_ssm_scan_gradients_on_card_match_plain_autograd(dev, b, s, h, dk,
                                                         dv, bcast):
    """fp32: the wrapper's gradients (``ScanFunction``: the backward's
    kernels) against autograd through the plain scan, at 1e-3 of each
    gradient's largest value (each gradient is a scan held at 2e-4; d
    log_a sums differences whose diagonal terms cancel), TF32 off; one
    forward and one backward launch counted, no plain call."""
    from repro_torch.kernels.ssm_scan import ops as scan
    from repro_torch.nn.recurrent import chunk_for, chunked_linear_scan

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    hq = 1 if bcast else h
    q0, k0 = (torch.randn((b, s, hq, dk), generator=gen, device=dev)
              .div_(dk ** 0.5).requires_grad_(True) for _ in range(2))
    v = torch.randn((b, s, h, dv), generator=gen, device=dev,
                    requires_grad=True)
    la = torch.nn.functional.logsigmoid(torch.randn(
        (b, s, h), generator=gen, device=dev)).requires_grad_(True)
    dy = torch.randn((b, s, h, dv), generator=gen, device=dev)
    q, k = q0.expand(b, s, h, dk), k0.expand(b, s, h, dk)
    want = torch.autograd.grad(chunked_linear_scan(
        q, k, v, la, chunk=chunk_for(s))[0], (q0, k0, v, la), dy)
    scan.reset_counts()
    got = torch.autograd.grad(scan.ssm_scan(q, k, v, la, chunk=chunk_for(s)),
                              (q0, k0, v, la), dy)
    torch.cuda.synchronize()
    assert scan.LAUNCHES == {"ssm_scan": 1, "ssm_scan_backward": 1}
    assert scan.PLAIN_CALLS["ssm_scan"] == 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        err = float((g - w).abs().max() / w.abs().max())
        assert err <= 1e-3, err


# chip_smoke.py's BW_CASES: (B, S, H, K, V, q and k one head over H)
BW_CASES = [(2, 2048, 4, 1024, 1024, False), (2, 2048, 32, 64, 128, True),
            (4, 200, 4, 64, 96, False), (2, 256, 2, 40, 24, False),
            (4, 2048, 2, 1024, 1024, False), (4, 2048, 16, 64, 128, True)]


@pytest.mark.parametrize("b,s,h,dk,dv,bcast", BW_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_backward_kernels_match_plain_backward(dev, b, s, h, dk, dv, bcast,
                                               dtype):
    """``kernel_backward`` against ``plain_backward`` on the same inputs
    (the same passes in fp32 arithmetic): fp32 within 2e-4 of each row's
    largest value (d log_a: of its largest value); bf16 and fp16 within
    two units of the output dtype's roundoff (2^-7, 2^-10), as both round
    the same fp32 values once.  One backward launch, TF32 off."""
    from repro_torch.kernels.ssm_scan import ops as scan

    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(1)
    hq = 1 if bcast else h
    q, k = (torch.randn((b, s, hq, dk), generator=gen, device=dev)
            .div_(dk ** 0.5).to(dt).expand(b, s, h, dk) for _ in range(2))
    v, dy = (torch.randn((b, s, h, dv), generator=gen, device=dev).to(dt)
             for _ in range(2))
    la = torch.nn.functional.logsigmoid(torch.randn(
        (b, s, h), generator=gen, device=dev))
    want = scan.plain_backward(q, k, v, la, dy)
    scan.reset_counts()
    got = scan.kernel_backward(q, k, v, la, dy)
    torch.cuda.synchronize()
    assert scan.LAUNCHES == {"ssm_scan": 0, "ssm_scan_backward": 1}
    tol = scan.OUT_REL_TOL.get(dt, 2e-4)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        err = scan.row_rel_err(g, w) if g.dim() == 4 else float(
            (g - w).abs().max() / w.abs().max())
        assert err <= (2e-4 if g.dim() == 3 else tol), err


def test_kernels_without_backward_refuse_autograd_on_card(dev):
    from repro_torch.kernels.flash_attention import ops as flash

    q = torch.randn((1, 64, 2, 64), device=dev, requires_grad=True)
    k = torch.randn((1, 64, 2, 64), device=dev)
    with pytest.raises(RuntimeError, match="flash_attention has no backward"):
        flash.flash_attention(q, k, k)
    x = torch.zeros((1, 4, 4, 8), device=dev, requires_grad=True)
    vec = torch.zeros(8, dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="fused_horizontal has no "
                       "backward"):
        ops.fused_horizontal(x, x, vec, vec, vec, stride=(1, 1), pad=(0, 0))
    with pytest.raises(RuntimeError, match="fused_chain has no backward"):
        ops.fused_chain(x, [x], [vec], [], chain=(), oh=4, ow=4, oc=8)
    with torch.no_grad():
        assert flash.flash_attention(q, k, k).shape == q.shape


def test_device_spans_and_completions_on_card(dev, monkeypatch):
    """The tracer's device clock on the card: one span per program item,
    in order, inside the host's bracket of the call; and a server whose
    records end at their batch's completion, after submit and before the
    answers reach the host."""
    import time

    from repro_torch.cnn import init_params
    from repro_torch.hw import ZU2
    from repro_torch.obs.trace import TRACER
    from repro_torch.runtime import Server, Session
    g = build_graph("repro_torch", "toy", 16)
    x = np.random.default_rng(0).standard_normal(
        g.shape("data")).astype(np.float32)
    qm = quantize.calibrate(g, init_params(g), x, lambda g_, p_, x_:
                            executor.run_float(g_, p_, x_, device=dev))
    xq = quantize.quantize_to(x, qm.f_a["data"])
    sess = Session(g, strategy("repro_torch", g), ZU2, qm, device=dev)
    sess.run(xq)
    torch.cuda.synchronize()
    TRACER.clear()
    TRACER.enable()
    try:
        before = time.monotonic()
        sess.run(xq)
        torch.cuda.synchronize()
        after = time.monotonic()
        spans = [r for r in TRACER.records() if r.track == "device"]
    finally:
        TRACER.disable()
        TRACER.clear()
    assert len(spans) == len(sess.program.items)
    slack = 1e-4                        # the anchor's reading of the host
    assert before - slack <= spans[0].start
    assert spans[-1].end <= after + slack
    for a, b in zip(spans, spans[1:]):
        assert a.start <= a.end <= b.start + 1e-6

    recs = []
    with Server(sess, max_batch=4, max_latency_s=0.01,
                observers=[recs.append]) as server:
        futs = [server.submit(xq[0]) for _ in range(4)]
        (name,) = sess.outputs
        out = torch.cat([f.result(timeout=60)[name] for f in futs]).cpu()
        t_host = time.monotonic()
    assert out.shape[0] == 4 and len(recs) == 4
    for r in recs:
        assert r["submit_s"] <= r["done_s"] <= t_host
        assert r["latency_s"] == r["done_s"] - r["submit_s"]

    # the idle card's clock takes its anchor again once it is old, and a
    # mark under the new anchor maps inside the host's bracket of it
    from repro_torch.obs import trace
    clock = TRACER.device_clock(sess.device)
    torch.cuda.synchronize()
    first = clock._anchor
    monkeypatch.setattr(trace, "REANCHOR_IDLE_S", 0.0)
    clock.refresh()
    assert clock._anchor is not first
    before = time.monotonic()
    m = TRACER.mark(sess.device)
    m.wait()
    after = time.monotonic()
    assert before - slack <= m.seconds() <= after + slack
