"""The conv_fused CUDA kernels and the fused executor on the card, against
the plain versions (int8 bit equality), with the port alone (no jax).
Marked ``cuda``: they skip where CUDA is absent; on a GPU machine run
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch

from repro_torch.core import executor, lower, quantize
from repro_torch.kernels.conv_fused import ops
from torch_common import (HAND_CHAINS, build_graph, hand_chain_args,
                          strategy)

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


@pytest.mark.parametrize("model,img", [("toy", 16), ("googlenet", 64),
                                       ("resnet50", 32)])
def test_fused_executor_matches_ref_on_card(dev, model, img):
    from repro_torch.cnn import init_params
    g = build_graph("repro_torch", model, img)
    x = np.random.default_rng(0).standard_normal(
        g.shape("data")).astype(np.float32)
    qm = quantize.calibrate(g, init_params(g), x, lambda g_, p_, x_:
                            executor.run_float(g_, p_, x_, device=dev))
    xq = quantize.quantize_to(x, qm.f_a["data"])
    s = strategy("repro_torch", g)
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
