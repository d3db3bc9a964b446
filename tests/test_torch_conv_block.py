"""The port's ``fused_conv_block`` and ``supports`` against the JAX
package's (``kernels/conv_fused/ops.py``; the Pallas kernel in interpret
mode): the same int8 numpy inputs, outputs equal to the bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv_fused import fused_conv_block as jblock
from repro.kernels.conv_fused import supports as jsupports
from repro_torch.kernels.conv_fused import fused_conv_block, ops, supports

# (h, w, ic, oc, k, stride, pad, relu, shift, pool, eltwise)
CASES = [
    (8, 8, 4, 8, 3, 1, 1, True, 6, None, None),
    (9, 9, 3, 5, 3, 1, 0, True, 7, None, None),          # ragged
    (12, 12, 8, 16, 3, 2, 1, True, 7, None, None),       # stride 2
    (16, 16, 16, 4, 1, 1, 0, False, 5, None, None),      # 1x1
    (10, 10, 4, 8, 3, 1, 1, True, 7, (2, 2), None),      # + max-pool
    (14, 14, 8, 16, 3, 1, 1, True, 7, (3, 1), None),
    (8, 8, 4, 8, 3, 1, 1, False, 6, None, False),        # + eltwise
    (8, 8, 4, 8, 3, 1, 1, False, 6, None, True),         # + eltwise, ReLU
]


@pytest.mark.parametrize("case", CASES)
def test_fused_conv_block_bit_equal_reference(case):
    h, w, ic, oc, k, s, p, relu, shift, pool, elt = case
    rng = np.random.default_rng(h * w + oc)
    x = rng.integers(-128, 128, (1, h, w, ic)).astype(np.int8)
    wt = rng.integers(-128, 128, (k, k, ic, oc)).astype(np.int8)
    b = rng.integers(-2000, 2000, oc).astype(np.int32)
    jelt = telt = None
    if elt is not None:
        oh = (h + 2 * p - k) // s + 1
        side = rng.integers(-128, 128, (1, oh, oh, oc)).astype(np.int8)
        jelt = (jnp.asarray(side), 1, 2, elt)
        telt = (torch.from_numpy(side), 1, 2, elt)
    want = jblock(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                  stride=(s, s), pad=(p, p), shift=shift, relu=relu,
                  pool=pool, eltwise=jelt, interpret=True)
    ops.reset_counts()
    got = fused_conv_block(torch.from_numpy(x), torch.from_numpy(wt),
                           torch.from_numpy(b), stride=(s, s), pad=(p, p),
                           shift=shift, relu=relu, pool=pool, eltwise=telt)
    assert ops.PLAIN_CALLS["fused_chain"] == 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kw", [
    {"kernel": (3, 3), "stride": (1, 1), "depthwise": True},
    {"kernel": (3, 3), "stride": (1, 1), "dilation": (2, 2)},
    {"kernel": (3, 3), "stride": (1, 2)},
    {"kernel": (3, 3), "stride": (1, 1), "pool": (3, 2), "conv_oh": 8,
     "conv_ow": 8}])
def test_supports_equals_reference(kw):
    assert supports(**kw) == jsupports(**kw)
