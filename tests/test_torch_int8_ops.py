"""repro_torch.core.int8_ops against repro.core.int8_ops: bit-equal on
full-range int8 inputs made with numpy from a seed, on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import int8_ops as ref_ops
from repro.kernels.conv_fused.ref import fused_conv_ref
from repro_torch.core import int8_ops as ops
from repro_torch.kernels.conv_fused import ops as conv_ops
from torch_common import (EXTREME_SHIFTS, extreme_bias, extreme_chain_args,
                          extreme_horizontal_args)


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


# ------------------------------------------------------ int32 extremes
EXTREMES = np.array([2**31 - 1, -2**31, 2**31 - 2, -2**31 + 1, 2**30,
                     -2**30, 1, -1, 5, -5, 0], np.int32)
WIDE_SHIFTS = [-40, -32, -31, -8, -1, 0, 1, 12, 30, 31, 32, 33, 40, 60]


@pytest.mark.parametrize("shift", WIDE_SHIFTS)
def test_round_shift_requantize_at_int32_extremes(shift):
    """Scalar shifts, where the reference's int32 arithmetic wraps: |-2^31|,
    |x| + 2^(s-1), shifts by 32 or more."""
    acc = np.concatenate([EXTREMES, np.random.default_rng(shift + 99)
                          .integers(-2**31, 2**31, 64).astype(np.int32)])
    _eq(ops.round_shift(torch.as_tensor(acc), shift),
        ref_ops.round_shift(jnp.asarray(acc), shift))
    for relu in (False, True):
        _eq(ops.requantize(torch.as_tensor(acc), shift, relu),
            ref_ops.requantize(jnp.asarray(acc), shift, relu))


def test_round_shift_per_channel_at_int32_extremes():
    """A per-channel shift vector over -60..60 against every extreme."""
    s = np.arange(-60, 61, dtype=np.int32)
    acc = np.concatenate([np.repeat(EXTREMES[:, None], s.size, 1),
                          np.random.default_rng(7).integers(
                              -2**31, 2**31, (32, s.size))]).astype(np.int32)
    _eq(ops.round_shift(torch.as_tensor(acc), torch.as_tensor(s)),
        ref_ops.round_shift(jnp.asarray(acc), jnp.asarray(s)))


@pytest.mark.parametrize("f_from", [3 + 40, 3 + 33, 3 - 31, 3 - 40])
def test_rescale_eltwise_concat_at_wide_shifts(f_from):
    rng = np.random.default_rng(f_from + 50)
    x, y = _i8(rng, (2, 4, 4, 3)), _i8(rng, (2, 4, 4, 3))
    tx, ty = torch.as_tensor(x), torch.as_tensor(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    _eq(ops.rescale(tx, f_from, 3), ref_ops.rescale(jx, f_from, 3))
    for relu in (False, True):
        _eq(ops.eltwise_add([tx, ty], (f_from, f_from - 1), 3, relu),
            ref_ops.eltwise_add([jx, jy], (f_from, f_from - 1), 3, relu))
    _eq(ops.concat([tx, ty], (f_from, 3), 3),
        ref_ops.concat([jx, jy], (f_from, 3), 3))


@pytest.mark.parametrize("shift", EXTREME_SHIFTS + (60,))
def test_conv_and_fc_with_bias_near_int32_extremes(shift):
    rng = np.random.default_rng(shift)
    x, wt = _i8(rng, (2, 7, 6, 8)), _i8(rng, (3, 3, 8, 10))
    b = extreme_bias(rng, 10)
    for relu in (False, True):
        kw = dict(stride=(1, 1), pad=(1, 1), shift=shift, relu=relu)
        _eq(ops.conv2d(torch.as_tensor(x), torch.as_tensor(wt),
                       torch.as_tensor(b), **kw),
            ref_ops.conv2d(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                           **kw))
    xf, wf = _i8(rng, (3, 2, 2, 5)), _i8(rng, (20, 6))
    bf = extreme_bias(rng, 6)
    _eq(ops.fc(torch.as_tensor(xf), torch.as_tensor(wf), torch.as_tensor(bf),
               shift=shift),
        ref_ops.fc(jnp.asarray(xf), jnp.asarray(wf), jnp.asarray(bf),
                   shift=shift))


@pytest.mark.parametrize("shift", EXTREME_SHIFTS + (60,))
def test_chain_plain_at_int32_extremes_matches_reference(shift):
    """The chain kernel's plain version (conv with a bias near the int32
    extremes, then an elt stage at shifts +-shift) against the reference's
    unfused composition of the same ops."""
    chain, x, w, b, sides, oh, ow, oc = extreme_chain_args(
        shift, np.random.default_rng(shift))
    got = conv_ops.fused_chain_plain(
        torch.as_tensor(x), [torch.as_tensor(w[0])], [torch.as_tensor(b[0])],
        [torch.as_tensor(sides[0])], chain=chain, oh=oh, ow=ow, oc=oc)
    elt = chain[1]
    want = fused_conv_ref(
        jnp.asarray(x), jnp.asarray(w[0]), jnp.asarray(b[0]), stride=(1, 1),
        pad=(1, 1), shift=shift, relu=False,
        eltwise=(jnp.asarray(sides[0]), elt[2], elt[3], elt[4]))
    _eq(got, want)


def test_horizontal_plain_at_int32_extremes_matches_reference():
    """OC-stacked siblings at shifts 1, 31, 32, 33 and 40, biases near the
    int32 extremes: the plain version against each sibling's reference
    conv2d, as the reference's unfused executor runs them."""
    x, w, b, shift, relu, stride, pad = extreme_horizontal_args(
        np.random.default_rng(5))
    got = conv_ops.fused_horizontal_plain(
        *map(torch.as_tensor, (x, w, b, shift, relu)), stride=stride, pad=pad)
    k = w.shape[-1] // len(EXTREME_SHIFTS)
    want = np.concatenate([np.asarray(ref_ops.conv2d(
        jnp.asarray(x), jnp.asarray(w[..., i:i + k]), jnp.asarray(b[i:i + k]),
        stride=stride, pad=pad, shift=int(shift[i]), relu=bool(relu[i])))
        for i in range(0, w.shape[-1], k)], -1)
    _eq(got, want)
