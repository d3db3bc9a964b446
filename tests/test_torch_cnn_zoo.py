"""The paper's five CNNs under both FPGA plans (ZU2 and ZU9), the port
against the JAX package on the CPU.

Planning at 224: the port's ``pathsearch.search`` groups and
``lower_strategy`` items equal the reference's for VGG16, ResNet50,
ResNet152, GoogLeNet and YOLO-lite under each target, and every chain
launch they lower to fits the CUDA chain kernel (a ``chain_plan``
descriptor and a ``choose_chain_tile`` tile within a block's shared memory,
at batch 1 and 8; YOLO-lite under ZU9 lowers one 10-stage chain).  At the
small sizes the fused executor runs here, the port's calibration and its
fused int8 outputs are bit-equal to the reference's ref executor (and to
its Pallas kernels in interpret mode where the reference's own tests run
them), and the chains whose windows the card cuts (VGG16's 9-stage chains
on 16x16 maps under ZU9) walk the kernel's descriptors to the plain
version's output.
"""
from __future__ import annotations

import dataclasses
import functools
from functools import partial

import numpy as np
import pytest
import torch

from repro.core import executor as ref_executor
from repro.core import lower as ref_lower
from repro_torch.core import executor, lower, quantize
from repro_torch.core.carry import params_from_reference
from repro_torch.kernels.conv_fused import ops
from torch_common import (build_graph, emulate_chain_kernel, i8,
                          reference_model, strategy)

MODELS = ["vgg16", "resnet50", "resnet152", "googlenet", "yolo_lite"]
TARGETS = ["ZU2", "ZU9"]
# (model, img) the fused executor runs here: VGG16 (its ZU9 plan lowers a
# 9-stage chain) and ResNet152 at 32, YOLO-lite at 64 and at 128 (its ZU9
# plan is the 10-stage chain it lowers at 224).  YOLO-lite at 32 is not
# plannable in either package (``tiling.solve_shape`` divides by zero).
SMALL = [("vgg16", 32), ("resnet152", 32), ("yolo_lite", 64),
         ("yolo_lite", 128)]
# where the reference's own tests run its Pallas kernels (interpret mode)
# on these models: tests/test_executor_validate.py, under ZU2
PALLAS = {("vgg16", 32, "ZU2"), ("yolo_lite", 64, "ZU2")}


def _graph(pkg: str, model: str, img: int):
    if img == 224:
        cnn = __import__(f"{pkg}.cnn", fromlist=["build"])
        return cnn.build(model)
    return build_graph(pkg, model, img)


@functools.lru_cache(maxsize=None)
def _plans(model: str, img: int, target: str):
    """(reference graph, strategy, program; port graph, strategy,
    program), unquantized."""
    g_ref = _graph("repro", model, img)
    s_ref = strategy("repro", g_ref, target=target)
    g = _graph("repro_torch", model, img)
    s = strategy("repro_torch", g, target=target)
    return (g_ref, s_ref, ref_lower.lower_strategy(g_ref, s_ref), g, s,
            lower.lower_strategy(g, s, None))


def _item(it) -> tuple:
    return type(it).__name__, dataclasses.asdict(it)


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("model", MODELS)
def test_plans_at_224_match_reference(model, target):
    """Groups, horizontal groups and cost of the search, and every lowered
    item (a launch's kind, nodes, stages, sides, fc_reshape, out_hw and
    tile; a fallback's reason), equal the reference's."""
    _, s_ref, p_ref, _, s, prog = _plans(model, 224, target)
    assert s.groups == s_ref.groups
    assert s.horizontal == s_ref.horizontal
    assert s.cost == pytest.approx(s_ref.cost, rel=1e-12)
    assert [_item(it) for it in prog.items] == \
        [_item(it) for it in p_ref.items]
    assert prog.meta["n_launches"] == p_ref.meta["n_launches"]
    assert prog.meta["n_fallbacks"] == p_ref.meta["n_fallbacks"]


def _chain_fit(g, prog, batches) -> dict:
    """Chain stages -> count over ``prog``'s chain launches, after checking
    that each gets a card tile and descriptor within shared memory at every
    batch in ``batches``."""
    lengths: dict = {}
    for launch in prog.launches():
        if launch.kind != "chain":
            continue
        conv_ocs = [g.shape(st[1])[3] for st in launch.stages
                    if st[0] == "conv"]
        oh, ow, oc, c_in, oc_list = ops.launch_geometry(
            launch, g.shape(launch.in_name), conv_ocs)
        for n in batches:
            tile = ops.choose_chain_tile(launch.stages, oh, ow, oc, c_in, n,
                                         oc_list)
            desc, smem = ops.chain_plan(launch.stages, oh, ow, oc, c_in,
                                        oc_list, tile)
            assert len(desc) == ops.HDR + ops.STG * len(launch.stages)
            assert 0 < smem <= ops.SMEM_MAX, (launch.nodes, n, tile)
        m = len(launch.stages)
        lengths[m] = lengths.get(m, 0) + 1
    return lengths


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("model", MODELS)
def test_chain_kernel_takes_every_chain_at_224(model, target):
    """Every chain launch of the 224 plan fits the chain kernel at batch 1
    and 8 (the server's largest batch), whatever its length: YOLO-lite under
    ZU9 is one 10-stage chain, VGG16 under ZU9 lowers an 8-stage one."""
    _, _, _, g, _, prog = _plans(model, 224, target)
    lengths = _chain_fit(g, prog, (1, 8))
    assert max(lengths) <= ops.MAX_STAGES
    if (model, target) == ("yolo_lite", "ZU9"):
        assert lengths == {10: 1}
    if (model, target) == ("vgg16", "ZU9"):
        assert lengths.get(8) == 1


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("model,img", SMALL)
def test_chain_kernel_takes_every_chain_at_test_sizes(model, img, target):
    """The same at the sizes the fused executor runs at here and on the
    card's tests: VGG16 at 32 under ZU9 lowers a 9-stage chain on a 16x16
    map whose one-pixel tile reaches 44 rows back, which fits only because
    the card cuts each window to the range its stage reads."""
    _, _, _, g, _, prog = _plans(model, img, target)
    lengths = _chain_fit(g, prog, (1, 2))
    if (model, img, target) == ("vgg16", 32, "ZU9"):
        assert lengths.get(9) == 1
    if (model, img, target) == ("yolo_lite", 128, "ZU9"):
        assert lengths == {10: 1}


# the plans the card runs at 224: GoogLeNet and ResNet50 under ZU2, VGG16,
# ResNet152 and YOLO-lite under both targets
CARD_PLANS = [("googlenet", "ZU2"), ("resnet50", "ZU2")] + [
    (model, target) for model in ("vgg16", "resnet152", "yolo_lite")
    for target in TARGETS]


@pytest.mark.parametrize("model,target", CARD_PLANS)
def test_chain_tiles_fit_at_serving_batches(model, target):
    """At batch 1, 8 and 64 the card's tile for every chain launch of the
    224 plan — (th, tw, toc, ni), a block taking ni images — fits a block's
    shared memory with the kernel's parameters within 4 KB; at batch 1 a
    block takes one image, and never more than the batch."""
    assert ops.CHAIN_PARAM_BYTES <= 4096
    _, _, _, g, _, prog = _plans(model, 224, target)
    for launch in prog.launches():
        if launch.kind != "chain":
            continue
        conv_ocs = [g.shape(st[1])[3] for st in launch.stages
                    if st[0] == "conv"]
        oh, ow, oc, c_in, oc_list = ops.launch_geometry(
            launch, g.shape(launch.in_name), conv_ocs)
        for n in (1, 8, 64):
            tile = ops.choose_chain_tile(launch.stages, oh, ow, oc, c_in, n,
                                         oc_list)
            assert len(tile) == 4 and 1 <= tile[3] <= n
            assert n > 1 or tile[3] == 1, (launch.nodes, tile)
            desc, smem = ops.chain_plan(launch.stages, oh, ow, oc, c_in,
                                        oc_list, tile)
            assert 0 < smem <= ops.SMEM_MAX, (launch.nodes, n, tile)
            assert len(desc) == ops.HDR + ops.STG * len(launch.stages)
            assert len(launch.stages) <= ops.MAX_STAGES


def test_too_long_a_chain_raises_with_the_cap():
    """A chain past ``MAX_STAGES`` raises in ``chain_plan`` with its length
    and the cap, and never reaches the kernel."""
    m = ops.MAX_STAGES + 1
    chain = tuple(("pool", f"p{i}", "max", 1, 1, 1, 1, 0, 0, 4, 4, 1)
                  for i in range(m))
    with pytest.raises(ValueError, match=f"chain of {m} stages; the kernel "
                       f"takes at most {ops.MAX_STAGES}"):
        ops.chain_plan(chain, 4, 4, 8, 8, (0,) * m, (4, 4, 8))


def _cut(desc, m: int) -> bool:
    """Whether a descriptor cuts any window (an origin set)."""
    return bool((desc[32:34] >= 0).any() or any(
        (desc[ops.HDR + ops.STG * i:][32:34] >= 0).any() for i in range(m)))


def test_cut_windows_walk_to_the_plain_output():
    """VGG16 at 32 under ZU9: each chain launch whose windows the card cuts
    (the 9-stage chain on a 16x16 map, its origins set in the descriptor),
    its descriptor walked as the CUDA kernel walks it
    (``emulate_chain_kernel``), equals the plain version at the card's own
    tile and at a one-pixel tile."""
    _, _, _, g, _, prog = _plans("vgg16", 32, "ZU9")
    rng = np.random.default_rng(11)
    n_cut = 0
    for launch in prog.launches():
        if launch.kind != "chain":
            continue
        conv_ocs = [g.shape(st[1])[3] for st in launch.stages
                    if st[0] == "conv"]
        x = i8(rng, (1,) + tuple(g.shape(launch.in_name)[1:]))
        oh, ow, oc, c_in, oc_list = ops.launch_geometry(launch, x.shape,
                                                        conv_ocs)
        card = ops.choose_chain_tile(launch.stages, oh, ow, oc, c_in, 1,
                                     oc_list)
        tiles = [t for t in {card, (1, 1, card[2])} if _cut(ops.chain_plan(
            launch.stages, oh, ow, oc, c_in, oc_list, t)[0],
            len(launch.stages))]
        if not tiles:
            continue
        if launch.fc_reshape:
            x = x.reshape(1, 1, 1, -1)
        w, b, cin = [], [], c_in
        for st, co in zip([st for st in launch.stages if st[0] == "conv"],
                          conv_ocs):
            w.append(i8(rng, (st[2], st[3], cin, co)))
            b.append(rng.integers(-3000, 3000, co).astype(np.int32))
            cin = co
        sides = [i8(rng, (1,) + tuple(g.shape(s)[1:])) for s in launch.sides]
        want = ops.fused_chain_plain(
            torch.as_tensor(x), [torch.as_tensor(t) for t in w],
            [torch.as_tensor(t) for t in b],
            [torch.as_tensor(t) for t in sides], chain=launch.stages, oh=oh,
            ow=ow, oc=oc).numpy()
        for tile in tiles:
            n_cut += 1
            got = emulate_chain_kernel(x, w, b, sides, launch.stages, oh,
                                       ow, oc, tile)
            np.testing.assert_array_equal(got, want, err_msg=str(
                (launch.nodes, tile)))
    assert n_cut >= 2          # the 9-stage chain at both tiles


# ------------------------------------------------- bit-exact on the CPU
@functools.lru_cache(maxsize=None)
def _port_calibrated(model: str, img: int):
    """The port's own calibration of the reference's float params on the
    reference's calibration input."""
    _, params, x, _, _ = reference_model(model, img)
    g = build_graph("repro_torch", model, img)
    return g, quantize.calibrate(g, params_from_reference(params), x,
                                 partial(executor.run_float, device="cpu"))


@functools.lru_cache(maxsize=None)
def _reference_out(model: str, img: int) -> dict:
    g_ref, _, _, qm_ref, xq = reference_model(model, img)
    return ref_executor.Int8Executor(g_ref, qm_ref, strategy=None,
                                     backend="ref")(xq)


@pytest.mark.parametrize("target", TARGETS)
@pytest.mark.parametrize("model,img", SMALL)
def test_fused_outputs_bit_equal_to_reference(model, img, target):
    """Same numpy weights and input: the port's calibration (fractions,
    int8 weights and int32 biases) equals the reference's, and the port's
    fused executor under the target's plan gives the reference ref
    executor's outputs to the bit (and its Pallas executor's, in interpret
    mode, where the reference's tests run it)."""
    g_ref, _, _, qm_ref, xq = reference_model(model, img)
    g, qm = _port_calibrated(model, img)
    assert qm.f_a == qm_ref.f_a and qm.f_w == qm_ref.f_w
    for k in qm_ref.weights:
        np.testing.assert_array_equal(qm.weights[k], qm_ref.weights[k])
        np.testing.assert_array_equal(qm.biases[k], qm_ref.biases[k])
    ops.reset_counts()
    got = executor.Int8Executor(g, qm, strategy=strategy(
        "repro_torch", g, target=target), backend="fused", device="cpu")(xq)
    prog = lower.lower_strategy(g, strategy("repro_torch", g, target=target),
                                qm)
    assert ops.PLAIN_CALLS["fused_chain"] + ops.PLAIN_CALLS[
        "fused_horizontal"] == prog.meta["n_launches"]
    wants = [_reference_out(model, img)]
    if (model, img, target) in PALLAS:
        wants.append(ref_executor.Int8Executor(
            g_ref, qm_ref, strategy=strategy("repro", g_ref, target=target),
            backend="pallas")(xq))
    for want in wants:
        assert set(got) == set(want)
        for k in want:
            w_ = np.asarray(want[k])
            g_ = got[k].numpy()
            assert g_.dtype == w_.dtype, k
            if np.issubdtype(w_.dtype, np.integer):
                np.testing.assert_array_equal(g_, w_, err_msg=k)
            else:
                np.testing.assert_allclose(g_, w_, rtol=0, atol=1e-6,
                                           err_msg=k)


# ------------------------------------------------- the serving example
def _example():
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parents[1] / "examples"
            / "serve_cnn_torch.py")
    spec = importlib.util.spec_from_file_location("serve_cnn_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_example_runs_on_the_cpu():
    """``examples/serve_cnn_torch.py`` on VGG16 at 32 under ZU9 with
    ``--device cpu``: every request answered, each answer equal to the
    session's own ``run`` of it, one plain call per planned launch an
    image."""
    res = _example().main(["--model", "vgg16", "--img", "32", "--requests",
                           "5", "--max-batch", "2", "--target", "ZU9",
                           "--device", "cpu"])
    sess = res["session"]
    assert len(res["outputs"]) == 5 and sess.device.type == "cpu"
    assert sum(res["per_image"].values()) == sess.program.meta["n_launches"]
    rng = np.random.default_rng(0)
    rng.standard_normal(sess.graph.shape("data"))     # the calibration draw
    for out in res["outputs"]:
        x = quantize.quantize_to(rng.standard_normal(
            (1,) + tuple(sess.graph.shape("data")[1:])).astype(np.float32),
            sess.qm.f_a["data"])
        want = sess.run(x)
        for k in want:
            assert torch.equal(out[k], want[k]), k


def test_serve_example_defaults_to_cuda(monkeypatch):
    """Without ``--device`` the example runs on the card, and raises where
    CUDA is absent."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _example().main(["--model", "vgg16", "--img", "32"])
