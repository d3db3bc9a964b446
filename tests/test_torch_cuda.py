"""The port's CUDA kernels and the fused executor on the card, against the
plain versions (int8 bit equality for the conv kernels, the stated
tolerances for flash attention), with the port alone (no jax).
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


@pytest.mark.parametrize("b,sq,sk,h,kv,d,off,causal", [
    (2, 100, 100, 6, 2, 64, 0, True),        # ragged tiles, GQA 3:1
    (1, 256, 256, 15, 5, 64, 0, True),       # SmolLM-360M's grouping
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
