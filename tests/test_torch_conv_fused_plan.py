"""The card's side of repro_torch.kernels.conv_fused, checked on the CPU:
tile plans fit a block's shared memory at 224, the packed descriptors walked
by a numpy model of the CUDA chain kernel equal the plain version, the
horizontal kernel's packed weights and tile/split plan walked the same way
equal its plain version, and the wrappers take the plain versions only for
CPU tensors."""
import numpy as np
import pytest
import torch

from repro_torch.core import int8_ops, lower
from repro_torch.kernels.conv_fused import ops
from torch_common import (CHAIN_HDR, CHAIN_STG, GOOGLENET_HORIZONTAL,
                          HAND_CHAINS, RAGGED_HORIZONTAL, emulate_chain_kernel,
                          hand_chain_args, horizontal_args, port_model,
                          strategy)
from torch_common import i8 as _i8


# ------------------------------------------------- the card's tile plans
def _chain_meta(g, launch):
    c_in = g.shape(launch.in_name)[3]
    if launch.fc_reshape:
        _, h, w, c = g.shape(launch.in_name)
        c_in = h * w * c
    oc_list = tuple(g.shape(st[1])[3] if st[0] == "conv" else 0
                    for st in launch.stages)
    oc = [o for o in oc_list if o][-1] if any(oc_list) else c_in
    return c_in, oc_list, oc


@pytest.mark.parametrize("model", ["googlenet", "resnet50"])
def test_card_tiles_fit_shared_memory_at_224(model):
    """Every 224 plan at batch 1 fits a block's shared memory (windows at
    their pixel strides, two weight panel buffers, the K-group table, laid
    out in that order on 16-byte boundaries), the planner's cost model
    counts the same bytes, every launch gives at least half of the 132 SMs
    a block, or half as many blocks as its output allows (a block takes one
    image at batch 1), and every weight panel of GoogLeNet-224 is staged in
    shared memory."""
    from repro_torch.cnn import build
    g = build(model)
    prog = lower.lower_strategy(g, strategy("repro_torch", g), None)
    for launch in prog.launches():
        if launch.kind != "chain":
            continue
        c_in, oc_list, oc = _chain_meta(g, launch)
        oh, ow = launch.out_hw
        th, tw, toc, ni = ops.choose_chain_tile(launch.stages, oh, ow, oc,
                                                c_in, 1, oc_list)
        assert 1 <= th <= oh and 1 <= tw <= ow and oc % toc == 0 and ni == 1
        desc, smem = ops.chain_plan(launch.stages, oh, ow, oc, c_in, oc_list,
                                    (th, tw, toc, ni))
        assert 0 < smem <= ops.SMEM_MAX
        assert len(desc) == ops.HDR + ops.STG * len(launch.stages)
        h = dict(zip(CHAIN_HDR, desc[:len(CHAIN_HDR)].tolist()))
        assert 0 < h["buf_b"] <= h["w_off"] <= h["w1_off"] <= h["koff"] \
            <= h["ring_off"] <= smem and all(
                h[f] % 16 == 0
                for f in ("buf_b", "w_off", "w1_off", "koff", "ring_off"))
        assert model == "resnet50" or h["ring_b"] == 0
        ch, last_conv = ops._chain_channels(launch.stages, c_in,
                                            lambda i: oc_list[i])
        geom = ops.chain_geometry(launch.stages, th, oh, ow, tw)
        assert ops._plan_cost(launch.stages, geom, ch, last_conv, c_in, toc,
                              1, oc)[0] == smem
        most = oh * ow * oc // min(t for t in (oc, oc // 2, oc // 4, oc // 8,
                                               64, 32, 16, 8)
                                   if t >= 1 and oc % t == 0)
        assert 2 * h["n_h"] * h["n_w"] * h["n_k"] >= min(ops.N_SM, most), \
            launch.nodes


def test_vgg16_weight_fetch_at_batch_64():
    """VGG16-224 under ZU2 at batch 64: the weight bytes the blocks of
    executor items 1-7 (conv3 to conv13) fetch, by the planner's count at
    the card's tiles, total at most 20 GB a batch (about 80 GB while every
    oversized panel was read once per 16-pixel tile), and the oversized
    panels stream through the ring."""
    from repro_torch.cnn import build
    g = build("vgg16")
    prog = lower.lower_strategy(g, strategy("repro_torch", g), None)
    total, rings = 0, 0
    for i, launch in enumerate(prog.items[1:8], start=1):
        assert launch.kind == "chain", i
        conv_ocs = [g.shape(st[1])[3] for st in launch.stages
                    if st[0] == "conv"]
        oh, ow, oc, c_in, oc_list = ops.launch_geometry(
            launch, (64,) + tuple(g.shape(launch.in_name)[1:]), conv_ocs)
        tile = ops.choose_chain_tile(launch.stages, oh, ow, oc, c_in, 64,
                                     oc_list)
        total += ops.chain_fetch(launch.stages, oh, ow, oc, c_in, oc_list,
                                 tile, 64)
        rings += int(ops.chain_plan(launch.stages, oh, ow, oc, c_in, oc_list,
                                    tile)[0][31] != 0)
    assert total <= 20e9 and rings == 7


@pytest.mark.parametrize("n", [1, 64])
def test_tile_record_takes_the_choosers_images(n):
    """VGG16-224 under ZU2: a launch whose tile record is the chooser's own
    (th, tw, toc) runs at the chooser's images a block at the call's batch,
    as the untuned launch does (a record fixes the shape, not ``ni``), and
    its span args agree; at batch 64 some launch takes more than one image
    a block, at batch 1 none."""
    import dataclasses
    from repro_torch.cnn import build
    g = build("vgg16")
    prog = lower.lower_strategy(g, strategy("repro_torch", g), None)
    nis = []
    for launch in prog.launches():
        if launch.kind != "chain":
            continue
        in_shape = (n,) + tuple(g.shape(launch.in_name)[1:])
        conv_ocs = [g.shape(st[1])[3] for st in launch.stages
                    if st[0] == "conv"]
        oh, ow, oc, c_in, oc_list = ops.launch_geometry(launch, in_shape,
                                                        conv_ocs)
        untuned = ops.choose_chain_tile(launch.stages, oh, ow, oc, c_in, n,
                                        oc_list)
        tuned = dataclasses.replace(launch, tile=untuned[:3])
        assert ops.launch_tile(tuned, in_shape, conv_ocs) == untuned
        assert ops.launch_plan_args(tuned, in_shape, conv_ocs) == \
            ops.launch_plan_args(launch, in_shape, conv_ocs)
        nis.append(untuned[3])
    assert (max(nis) > 1) == (n > 1)


@pytest.mark.parametrize("i", range(len(HAND_CHAINS)))
@pytest.mark.parametrize("tile", [None, (3, 5, 4), (1, 1, 8), (2, 3, 16),
                                  (3, 5, 4, 1), (3, 5, 4, 2), (2, 3, 16, 4)])
def test_descriptor_walk_matches_plain(i, tile):
    """A hand chain's descriptor walked as the kernel walks it equals the
    plain version: at batch 2 at the chooser's tile and at forced ones, and
    at batch 3 at forced tiles of one, two and four images a block (groups
    of 2 + 1 and of 3 images: the last group ragged)."""
    n = 3 if tile is not None and len(tile) > 3 else 2
    chain, x, w, b, sides, oh, ow, oc = hand_chain_args(
        i, np.random.default_rng(i), n)
    conv_at = [j for j, st in enumerate(chain) if st[0] == "conv"]
    oc_list = [0] * len(chain)
    for j, t in zip(conv_at, w):
        oc_list[j] = t.shape[-1]
    if tile is None:
        tile = ops.choose_chain_tile(chain, oh, ow, oc, x.shape[3], n,
                                     tuple(oc_list))
    else:
        toc = tile[2] if oc % tile[2] == 0 else oc
        tile = (min(tile[0], oh), min(tile[1], ow), toc, *tile[3:])
    got = emulate_chain_kernel(x, w, b, sides, chain, oh, ow, oc, tile)
    want = ops.fused_chain_plain(
        torch.as_tensor(x), [torch.as_tensor(t) for t in w],
        [torch.as_tensor(t) for t in b], [torch.as_tensor(t) for t in sides],
        chain=chain, oh=oh, ow=ow, oc=oc)
    np.testing.assert_array_equal(got, want.numpy())


def test_descriptor_walk_matches_plain_on_model_launches():
    rng = np.random.default_rng(7)
    for model, img in (("toy", 16), ("resnet50", 32)):
        g, qm, _ = port_model(model, img)
        prog = lower.lower_strategy(g, strategy("repro_torch", g), qm)
        for launch in prog.launches():
            if launch.kind != "chain":
                continue
            prep = ops.prepare_launch(launch, qm, "cpu")
            x = _i8(rng, (1,) + tuple(g.shape(launch.in_name)[1:]))
            if launch.fc_reshape:
                x = x.reshape(1, 1, 1, -1)
            sides = [_i8(rng, (1,) + tuple(g.shape(s)[1:]))
                     for s in launch.sides]
            w = [t.numpy() for t in prep["weights"]]
            b = [t.numpy() for t in prep["biases"]]
            c_in, oc_list, oc = _chain_meta(g, launch)
            oh, ow = launch.out_hw
            tile = ops.choose_chain_tile(launch.stages, oh, ow, oc, c_in, 1,
                                         oc_list)
            got = emulate_chain_kernel(x, w, b, sides, launch.stages, oh, ow,
                                        oc, tile)
            want = ops.fused_chain_plain(
                torch.as_tensor(x), prep["weights"], prep["biases"],
                [torch.as_tensor(s) for s in sides], chain=launch.stages,
                oh=oh, ow=ow, oc=oc)
            np.testing.assert_array_equal(got, want.numpy(),
                                          err_msg=str(launch.nodes))


@pytest.mark.parametrize("shape", [(7, 7, 3, 64), (3, 3, 192, 13),
                                   (1, 1, 1024, 1000), (5, 5, 6, 8)])
def test_chain_weights_pack_in_kernel_layout(shape):
    """``pack_chain_weights``: row o holds output channel o's weights in
    (kh, kw, ic) order with ic padded to 4 and K to 32 by zeros, and the 32
    rows past OC are zero, so a block's panel never reads past the end."""
    kh, kw, ic, oc = shape
    w = _i8(np.random.default_rng(sum(shape)), shape)
    p = ops.pack_chain_weights(torch.as_tensor(w)).numpy()
    icp = -(-ic // 4) * 4
    assert p.shape == (oc + 32, -(-kh * kw * icp // 32) * 32)
    assert not p[oc:].any() and not p[:, kh * kw * icp:].any()
    taps = p[:oc, :kh * kw * icp].reshape(oc, kh, kw, icp)
    assert not taps[..., ic:].any()
    np.testing.assert_array_equal(taps[..., :ic].transpose(1, 2, 3, 0), w)


def test_oversized_panels_read_from_device_memory():
    """A chain whose weight panels cannot all sit in shared memory beside
    its windows streams the largest through the weight ring (bit i of the
    header's ``ring_b``; the ring's slots and barriers close the block's
    shared memory), and the emulated kernel, the ring's passes and K slices
    included, still equals the plain version: at batch 1 at the chooser's
    tile, and at batch 3 with two images a block (a ragged last group),
    where a pass's tile spans both images' pixels."""
    chain = (("conv", "a", 3, 3, 1, 1, 1, 1, 1, 1, 7, True, 6, 6),
             ("conv", "b", 1, 1, 1, 1, 0, 0, 1, 1, 5, False, 6, 6))
    rng = np.random.default_rng(5)
    w = [_i8(rng, (3, 3, 512, 256)), _i8(rng, (1, 1, 256, 16))]
    b = [rng.integers(-3000, 3000, t.shape[-1]).astype(np.int32) for t in w]
    oc_list = (256, 16)
    for n, tile in ((1, None), (3, (6, 6, 16, 2))):
        x = _i8(rng, (n, 6, 6, 512))
        if tile is None:
            tile = ops.choose_chain_tile(chain, 6, 6, 16, 512, n, oc_list)
        desc, smem = ops.chain_plan(chain, 6, 6, 16, 512, oc_list, tile)
        h = dict(zip(CHAIN_HDR, desc[:len(CHAIN_HDR)].tolist()))
        assert h["ring_b"] == 1 and smem <= ops.SMEM_MAX
        assert h["ring_off"] + ops.ring_bytes(h["ring_ks"]) == smem
        # the ring's tile spans the images: 36 pixels an image
        st0 = dict(zip(CHAIN_STG, desc[ops.HDR:ops.HDR + ops.STG].tolist()))
        px = h["ni"] * st0["rows"] * st0["cols"]
        assert ops.ring_passes(256, px)[1] >= px
        got = emulate_chain_kernel(x, w, b, [], chain, 6, 6, 16, tile)
        want = ops.fused_chain_plain(
            torch.as_tensor(x), [torch.as_tensor(t) for t in w],
            [torch.as_tensor(t) for t in b], [], chain=chain, oh=6, ow=6,
            oc=16)
        np.testing.assert_array_equal(got, want.numpy())


# ------------------------------------------------------------ the wrappers
def test_wrappers_take_plain_versions_only_on_cpu():
    rng = np.random.default_rng(0)
    chain, x, w, b, sides, oh, ow, oc = hand_chain_args(0, rng)
    args = (torch.as_tensor(x), [torch.as_tensor(t) for t in w],
            [torch.as_tensor(t) for t in b], [torch.as_tensor(t) for t in sides])
    ops.reset_counts()
    ops.fused_chain(*args, chain=chain, oh=oh, ow=ow, oc=oc)
    xh = torch.as_tensor(_i8(rng, (1, 5, 5, 4)))
    wh = torch.as_tensor(_i8(rng, (1, 1, 4, 6)))
    vec = torch.zeros(6, dtype=torch.int32)
    ops.fused_horizontal(xh, wh, vec, vec + 3, vec + 1, stride=(1, 1),
                         pad=(0, 0))
    assert ops.PLAIN_CALLS == {"fused_chain": 1, "fused_horizontal": 1}
    assert ops.LAUNCHES == {"fused_chain": 0, "fused_horizontal": 0,
                            "fused_chain_ring_stages": 0}
    # the kernel launchers never fall back: a CPU tensor is refused
    with pytest.raises(ValueError, match="no kernel"):
        ops._launch_chain(*args, chain=chain, oh=oh, ow=ow, oc=oc, tile=None)
    with pytest.raises(ValueError, match="no kernel"):
        ops._launch_horizontal(xh, wh, vec, vec, vec, stride=(1, 1),
                               pad=(0, 0))
    ops.reset_counts()


def test_chain_shape_checks_refuse_mismatched_operands():
    chain, x, w, b, sides, oh, ow, oc = hand_chain_args(
        0, np.random.default_rng(1))
    shapes = (x.shape, (w[0].shape,), (b[0].shape,), [sides[0].shape])
    assert ops._chain_shapes(*shapes, chain, oc)[0] == 16
    with pytest.raises(ValueError, match="weight panel"):
        ops._chain_shapes(x.shape, ((3, 3, 4, 16),), shapes[2], shapes[3],
                          chain, oc)
    with pytest.raises(ValueError, match="side of 16 channels"):
        ops._chain_shapes(*shapes[:3], [(2, 7, 6, 8)], chain, oc)
    with pytest.raises(ValueError, match="1 weights and 0 sides"):
        ops._chain_shapes(*shapes[:3], [], chain, oc)
    with pytest.raises(ValueError, match="oc 8"):
        ops._chain_shapes(*shapes, chain, 8)


# ------------------------------------------- the horizontal kernel's layout
def _im2col(x, kh, kw, stride, pad):
    """(M, K) int64 rows of an NHWC input, K in (kh, kw, ic) order."""
    n, h, w, c = x.shape
    (sh, sw), (ph, pw) = stride, pad
    oh, ow = (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1
    xp = np.pad(x.astype(np.int64), ((0, 0), (ph, ph), (pw, pw), (0, 0)))
    cols = [xp[:, i:i + sh * (oh - 1) + 1:sh, j:j + sw * (ow - 1) + 1:sw]
            for i in range(kh) for j in range(kw)]
    return np.concatenate(cols, -1).reshape(n * oh * ow, kh * kw * c)


def _emulate_horizontal_kernel(x, packed, oc, stride, pad):
    """What ``horizontal_mma_kernel`` computes from the packed operands
    under the launcher's plan: each block (row tile, channel tile, K slice)
    adds its partial product into the tile, each output element is summed
    over its K slices exactly once, and the epilogue applies bias, shift,
    ReLU and saturation."""
    kh, kw = packed["hwio"][:2]
    wp = packed["w"].numpy().astype(np.int64)
    np_, kp = wp.shape
    a = _im2col(x, kh, kw, stride, pad)
    m, k = a.shape
    a = np.pad(a, ((0, 0), (0, kp - k)))
    plan = ops.horizontal_plan(m, oc, k)
    bm, split, steps = plan["bm"], plan["split"], plan["steps"]
    assert steps * ops.HBK == kp and steps % split == 0
    gx, gy, gz = plan["grid"]
    assert (gx, gy, gz) == (-(-m // bm), np_ // ops.HBN, split)
    acc = np.zeros((gx * bm, np_), np.int64)
    hits = np.zeros((gx * bm, np_, steps), np.int64)
    per = steps // split
    for bx in range(gx):
        for by in range(gy):
            for bz in range(gz):
                r, c = slice(bx * bm, (bx + 1) * bm), slice(
                    by * ops.HBN, (by + 1) * ops.HBN)
                ks = slice(bz * per * ops.HBK, (bz + 1) * per * ops.HBK)
                rows = np.arange(bx * bm, (bx + 1) * bm)
                a_t = np.where((rows < m)[:, None], a[np.minimum(rows, m - 1)
                                                      ][:, ks], 0)
                acc[r, c] += a_t @ wp[c, ks].T
                hits[r, c, bz * per:(bz + 1) * per] += 1
    assert (hits == 1).all()            # every (row, channel, K step) once
    acc = torch.from_numpy(acc[:m].astype(np.int32))
    y = int8_ops.round_shift(acc + packed["b"], packed["shift"])
    y = torch.where(packed["relu"] != 0, y.clamp(min=0), y)
    return int8_ops.sat8(y)[:, :oc]


@pytest.mark.parametrize("shape", GOOGLENET_HORIZONTAL + RAGGED_HORIZONTAL)
def test_horizontal_pack_and_plan_match_plain(shape):
    """The packed weights (OC-major, K contiguous, zero padding, vectors
    padded to match) walked tile by tile and K slice by K slice as the
    launcher plans the kernel equal ``fused_horizontal_plain`` bit for bit,
    at batch 1 and 2."""
    rng = np.random.default_rng(sum(shape))
    for n in (1, 2):
        x, w, b, sh, rl, stride, pad = horizontal_args(shape, n, rng)
        tw, tb, tsh, trl = (torch.from_numpy(t) for t in (w, b, sh, rl))
        packed = ops.pack_horizontal(tw, tb, tsh, trl)
        kh, kw, ic, oc = w.shape
        np_, kp = packed["w"].shape
        assert kp % ops.HBK == 0 and np_ % ops.HBN == 0
        assert not packed["w"][oc:].any()
        assert not packed["w"][:, kh * kw * ic:].any()
        want = ops.fused_horizontal_plain(torch.from_numpy(x), tw, tb, tsh,
                                          trl, stride=stride, pad=pad)
        got = _emulate_horizontal_kernel(x, packed, oc, stride, pad)
        assert torch.equal(got, want.reshape(-1, oc))


@pytest.mark.parametrize("shape", GOOGLENET_HORIZONTAL)
def test_horizontal_plan_fills_the_card(shape):
    """At batch 1 every GoogLeNet-224 launch gets at least one block per SM
    (132 on an H100), its K steps split in equal parts."""
    h, w, ic, oc = shape[:4]
    plan = ops.horizontal_plan(h * w, oc, ic)
    assert plan["steps"] % plan["split"] == 0
    assert np.prod(plan["grid"]) >= ops.N_SM
    assert plan["grid"][:2] == (-(-h * w // plan["bm"]), -(-oc // ops.HBN))
