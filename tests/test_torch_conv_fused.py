"""repro_torch.kernels.conv_fused on the CPU against the reference: the
plain versions against the Pallas kernels in interpret mode (bit-equal), and
the geometry copy against the reference's."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lower as ref_lower
from repro.kernels.conv_fused import conv_fused as ref_cf
from repro.kernels.conv_fused import ops as ref_ops
from repro_torch.core import lower
from repro_torch.kernels.conv_fused import ops
from torch_common import (HAND_CHAINS, hand_chain_args, port_model,
                          reference_model, strategy)
from torch_common import i8 as _i8


def _programs(model, img):
    g_ref, _, _, qm_ref, _ = reference_model(model, img)
    g, qm, _ = port_model(model, img)
    prog_ref = ref_lower.lower_strategy(g_ref, strategy("repro", g_ref), qm_ref)
    prog = lower.lower_strategy(g, strategy("repro_torch", g), qm)
    return g, qm, qm_ref, prog, prog_ref


def _launch_pairs(model, img, keep):
    g, qm, qm_ref, prog, prog_ref = _programs(model, img)
    assert len(prog.items) == len(prog_ref.items)
    pairs = []
    for a, b in zip(prog.items, prog_ref.items):
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        if isinstance(a, lower.FusedLaunch) and keep(a):
            pairs.append((a, b))
    return g, qm, qm_ref, pairs


def _run_both(g, qm, qm_ref, pairs, seed):
    rng = np.random.default_rng(seed)
    for launch, launch_ref in pairs:
        names = [launch.in_name] + list(launch.sides)
        env = {n: _i8(rng, (2,) + tuple(g.shape(n)[1:])) for n in names}
        want = ref_ops.run_launch(launch_ref,
                                  {k: jnp.asarray(v) for k, v in env.items()},
                                  qm_ref, interpret=True)
        got = ops.run_launch(launch,
                             {k: torch.as_tensor(v) for k, v in env.items()},
                             qm)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"{launch.nodes} -> {k}")


@pytest.mark.parametrize("model,img,kind", [
    ("toy", 16, None),                   # every launch of the toy graph
    ("googlenet", 64, "horizontal"),
    ("resnet50", 32, "elt"),
])
def test_run_launch_plain_matches_reference(model, img, kind):
    def keep(launch):
        if kind is None:
            return True
        if kind == "horizontal":
            return launch.kind == "horizontal"
        return any(st[0] == "elt" for st in launch.stages)

    g, qm, qm_ref, pairs = _launch_pairs(model, img, keep)
    if kind == "elt":     # one launch per distinct stage pattern
        by_pattern = {}
        for a, b in pairs:
            by_pattern.setdefault(tuple(st[0] for st in a.stages), (a, b))
        pairs = list(by_pattern.values())
    assert pairs
    _run_both(g, qm, qm_ref, pairs, seed=img)


@pytest.mark.parametrize("i", range(len(HAND_CHAINS)))
@pytest.mark.parametrize("tile", [(), (3, 5, 4), (1, 1, 8)])
def test_hand_chain_plain_matches_reference_tiles(i, tile):
    """The reference runs each (ragged) tile; the plain version has none."""
    chain, x, w, b, sides, oh, ow, oc = hand_chain_args(i, np.random.default_rng(i))
    want = ref_ops._run_chain(
        jnp.asarray(x), tuple(map(jnp.asarray, w)), tuple(map(jnp.asarray, b)),
        tuple(map(jnp.asarray, sides)), chain=chain, oh=oh, ow=ow, oc=oc,
        interpret=True, tile=tile)
    got = ops.fused_chain_plain(
        torch.as_tensor(x), [torch.as_tensor(t) for t in w],
        [torch.as_tensor(t) for t in b], [torch.as_tensor(t) for t in sides],
        chain=chain, oh=oh, ow=ow, oc=oc)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chain_geometry_matches_reference():
    chains = [c for c, *_ in HAND_CHAINS]
    for model, img in (("googlenet", 64), ("resnet50", 32)):
        g, qm, _ = port_model(model, img)
        prog = lower.lower_strategy(g, strategy("repro_torch", g), qm)
        chains += [lc.stages for lc in prog.launches() if lc.kind == "chain"]
    for chain in chains:
        last = chain[-1]
        oh, ow = ops._true_hw(last)
        for th, tw in ((1, None), (3, 5), (8, None), (2, 3), (oh, ow)):
            assert ops.chain_geometry(chain, th, oh, ow, tw) == \
                ref_cf.chain_geometry(chain, th, oh, ow, tw)


def test_fused_conv_ref_matches_reference():
    from repro.kernels.conv_fused.ref import fused_conv_ref as jax_ref
    from repro_torch.kernels.conv_fused.ref import fused_conv_ref
    rng = np.random.default_rng(3)
    x, w = _i8(rng, (1, 12, 12, 4)), _i8(rng, (3, 3, 4, 8))
    b = rng.integers(-2000, 2000, 8).astype(np.int32)
    side = _i8(rng, (1, 6, 6, 8))
    kw = dict(stride=(1, 1), pad=(1, 1), shift=7, relu=True, pool=(2, 2))
    got = fused_conv_ref(torch.as_tensor(x), torch.as_tensor(w),
                         torch.as_tensor(b),
                         eltwise=(torch.as_tensor(side), 1, -1, True), **kw)
    want = jax_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                   eltwise=(jnp.asarray(side), 1, -1, True), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
