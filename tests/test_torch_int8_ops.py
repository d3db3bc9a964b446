"""repro_torch.core.int8_ops against repro.core.int8_ops: bit-equal on
full-range int8 inputs made with numpy from a seed, on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import int8_ops as ref_ops
from repro_torch.core import int8_ops as ops


def _i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


def _eq(got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shift", [-3, -1, 0, 1, 2, 7, 12])
def test_round_shift_requantize_rescale(shift):
    rng = np.random.default_rng(shift + 10)
    acc = rng.integers(-(1 << 20), 1 << 20, (4, 33)).astype(np.int32)
    acc[0, :6] = [0, 1, -1, 2, -2, 3]                 # rounding ties
    _eq(ops.round_shift(torch.as_tensor(acc), shift),
        ref_ops.round_shift(jnp.asarray(acc), shift))
    for relu in (False, True):
        _eq(ops.requantize(torch.as_tensor(acc), shift, relu),
            ref_ops.requantize(jnp.asarray(acc), shift, relu))
    q = _i8(rng, (5, 7))
    _eq(ops.rescale(torch.as_tensor(q), 3, 3 - shift),
        ref_ops.rescale(jnp.asarray(q), 3, 3 - shift))


def test_round_shift_per_channel_vector():
    rng = np.random.default_rng(1)
    acc = rng.integers(-(1 << 18), 1 << 18, (3, 4, 8)).astype(np.int32)
    s = np.array([-2, -1, 0, 1, 3, 5, 9, 1], np.int32)
    want = np.stack([np.asarray(ref_ops.round_shift(jnp.asarray(acc[..., c]),
                                                    int(s[c])))
                     for c in range(8)], -1)
    _eq(ops.round_shift(torch.as_tensor(acc), torch.as_tensor(s)), want)


CONV_CASES = [
    # (h, w, ic, oc, k, stride, pad, dilation, shift, relu)
    (9, 9, 3, 5, 3, (1, 1), (1, 1), (1, 1), 7, True),
    (12, 10, 8, 16, 5, (2, 1), (2, 2), (1, 1), 8, False),
    (11, 11, 4, 6, 3, (1, 1), (2, 2), (2, 2), 6, True),     # dilation
    (8, 8, 16, 4, 1, (1, 1), (0, 0), (1, 1), -2, False),    # negative shift
    (7, 9, 2, 3, 3, (2, 2), (1, 0), (1, 1), 4, True),
]


@pytest.mark.parametrize("h,w,ic,oc,k,stride,pad,dil,shift,relu", CONV_CASES)
def test_conv2d(h, w, ic, oc, k, stride, pad, dil, shift, relu):
    rng = np.random.default_rng(h * w + oc)
    x, wt = _i8(rng, (2, h, w, ic)), _i8(rng, (k, k, ic, oc))
    b = rng.integers(-4000, 4000, oc).astype(np.int32)
    kw = dict(stride=stride, pad=pad, dilation=dil, shift=shift, relu=relu)
    _eq(ops.conv2d(torch.as_tensor(x), torch.as_tensor(wt),
                   torch.as_tensor(b), **kw),
        ref_ops.conv2d(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), **kw))


@pytest.mark.parametrize("stride,shift", [((1, 1), 5), ((2, 2), -1)])
def test_depthwise_conv2d(stride, shift):
    rng = np.random.default_rng(3)
    x, wt = _i8(rng, (1, 10, 10, 6)), _i8(rng, (3, 3, 1, 6))
    b = rng.integers(-500, 500, 6).astype(np.int32)
    kw = dict(stride=stride, pad=(1, 1), shift=shift, relu=True)
    _eq(ops.depthwise_conv2d(torch.as_tensor(x), torch.as_tensor(wt),
                             torch.as_tensor(b), **kw),
        ref_ops.depthwise_conv2d(jnp.asarray(x), jnp.asarray(wt),
                                 jnp.asarray(b), **kw))


def test_fc():
    rng = np.random.default_rng(4)
    x, wt = _i8(rng, (3, 2, 2, 5)), _i8(rng, (20, 7))
    b = rng.integers(-500, 500, 7).astype(np.int32)
    for shift, relu in ((6, True), (-1, False)):
        _eq(ops.fc(torch.as_tensor(x), torch.as_tensor(wt),
                   torch.as_tensor(b), shift=shift, relu=relu),
            ref_ops.fc(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                       shift=shift, relu=relu))


POOL_CASES = [
    # (h, w, kernel, stride, pad, ceil_mode)
    (8, 8, (2, 2), (2, 2), (0, 0), True),
    (112, 112, (3, 3), (2, 2), (0, 0), True),     # GoogLeNet pool1 extents
    (13, 11, (3, 3), (2, 2), (1, 1), True),
    (9, 7, (3, 2), (2, 3), (0, 1), True),
    (9, 9, (3, 3), (2, 2), (0, 0), False),
    (14, 14, (3, 3), (1, 1), (1, 1), True),
]


@pytest.mark.parametrize("h,w,kernel,stride,pad,ceil_mode", POOL_CASES)
@pytest.mark.parametrize("kind", ["maxpool", "avgpool"])
def test_pools(kind, h, w, kernel, stride, pad, ceil_mode):
    rng = np.random.default_rng(h + 7 * w)
    x = _i8(rng, (1, h, w, 3))
    kw = dict(kernel=kernel, stride=stride, pad=pad, ceil_mode=ceil_mode)
    _eq(getattr(ops, kind)(torch.as_tensor(x), **kw),
        getattr(ref_ops, kind)(jnp.asarray(x), **kw))
    assert ops.ceil_extension(h, w, kernel, stride, pad) == \
        ref_ops.ceil_extension(h, w, kernel, stride, pad)


def test_global_avgpool_eltwise_concat_upsample_reorg():
    rng = np.random.default_rng(5)
    x, y = _i8(rng, (2, 6, 6, 4)), _i8(rng, (2, 6, 6, 4))
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    _eq(ops.global_avgpool(tx), ref_ops.global_avgpool(jx))
    for fs, f_out, relu in (((5, 3), 3, True), ((2, 6), 1, False),
                            ((1, 1), 4, False)):       # last: left shifts
        _eq(ops.eltwise_add([tx, ty], fs, f_out, relu),
            ref_ops.eltwise_add([jx, jy], fs, f_out, relu))
        _eq(ops.concat([tx, ty], fs, f_out), ref_ops.concat([jx, jy], fs, f_out))
    _eq(ops.upsample(tx, 2), ref_ops.upsample(jx, 2))
    _eq(ops.reorg(tx, 2), ref_ops.reorg(jx, 2))
    _eq(ops.sat8(torch.as_tensor(np.arange(-300, 300, 7, dtype=np.int32))),
        ref_ops.sat8(jnp.arange(-300, 300, 7, dtype=jnp.int32)))
