"""Shared set-up of the port's tests: the same graphs built by both
packages, inputs made with numpy from a seed, and the reference's
calibrated quantized model carried across to the port."""
from __future__ import annotations

import functools
import importlib

import numpy as np


def make_toy_graph(pkg: str):
    """``tests.conftest.make_toy_resnet_graph`` built with ``pkg``'s own
    XGraph and front end (``"repro"`` or ``"repro_torch"``)."""
    frontend = importlib.import_module(f"{pkg}.core.frontend")
    XGraph = importlib.import_module(f"{pkg}.core.xgraph").XGraph
    g = XGraph("toy")
    g.input("data", (1, 16, 16, 8))
    g.add("conv", "c1", ("data",), oc=16, kernel=(3, 3), stride=(1, 1),
          pad="same")
    g.add("relu", "r1", ("c1",))
    g.add("conv", "c2a", ("r1",), oc=16, kernel=(3, 3), pad="same")
    g.add("relu", "r2a", ("c2a",))
    g.add("conv", "c2b", ("r2a",), oc=16, kernel=(3, 3), pad="same")
    g.add("conv", "c2s", ("r1",), oc=16, kernel=(1, 1), pad="same")
    g.add("eltwise_add", "add1", ("c2b", "c2s"))
    g.add("relu", "r3", ("add1",))
    g.add("conv", "c3", ("r3",), oc=16, kernel=(3, 3), pad="valid")
    g.add("maxpool", "p1", ("c3",), kernel=(2, 2), stride=(2, 2))
    g.add("fc", "fc1", ("p1",), oc=10)
    return frontend.lower(g)


def build_graph(pkg: str, model: str, img: int):
    """``model`` at ``img`` with 10 classes (YOLO-lite with its own 20, as
    the reference's tests build it)."""
    if model == "toy":
        return make_toy_graph(pkg)
    cnn = importlib.import_module(f"{pkg}.cnn")
    if model == "yolo_lite":
        return cnn.build(model, img=img)
    return cnn.build(model, img=img, num_classes=10)


@functools.lru_cache(maxsize=None)
def reference_model(model: str, img: int = 32, seed: int = 0):
    """The reference package's graph, float params, calibration input,
    calibrated QuantizedModel and quantized input."""
    from repro.cnn import init_params
    from repro.core import executor, quantize

    g = build_graph("repro", model, img)
    params = init_params(g, seed=seed)
    x = np.random.default_rng(seed).standard_normal(
        g.shape("data")).astype(np.float32)
    qm = quantize.calibrate(g, params, x, executor.run_float)
    xq = quantize.quantize_to(x, qm.f_a["data"])
    return g, params, x, qm, xq


@functools.lru_cache(maxsize=None)
def port_model(model: str, img: int = 32, seed: int = 0):
    """The port's graph with the reference's quantized model carried
    across."""
    from repro_torch.core.carry import qm_from_reference

    _, _, _, qm, xq = reference_model(model, img, seed)
    return build_graph("repro_torch", model, img), qm_from_reference(qm), xq


def strategy(pkg: str, g, name: str = "search", target: str = "ZU2"):
    """``pathsearch.<name>`` of ``g`` under the planning device ``target``
    (``hw.ZU2`` or ``hw.ZU9``) of ``pkg``."""
    pathsearch = importlib.import_module(f"{pkg}.core.pathsearch")
    dev = getattr(importlib.import_module(f"{pkg}.hw"), target)
    return getattr(pathsearch, name)(g, dev)


def i8(rng, shape):
    return rng.integers(-128, 128, shape).astype(np.int8)


# Chains the models do not produce: avg and ceil-mode pools, negative
# shifts, an elt side with its own shifts, dilation, global pooling.
HAND_CHAINS = [
    # (chain, input (h, w, c), conv weight shape or None, side shape, oc)
    ((("conv", "c", 3, 3, 1, 1, 1, 1, 1, 1, -2, True, 13, 11),
      ("pool", "a", "avg", 3, 3, 2, 2, 1, 1, 7, 6, 9),
      ("elt", "e", 1, -1, True, 7, 6),
      ("pool", "m", "max", 2, 2, 2, 2, 0, 0, 4, 3, 4)),
     (13, 11, 8), (3, 3, 8, 16), (7, 6, 16), 16),
    ((("conv", "c", 3, 3, 2, 1, 2, 1, 2, 1, 5, False, 7, 11),
      ("pool", "g", "gap", 7, 11, 1, 1, 0, 0, 1, 1, 77)),
     (13, 11, 8), (3, 3, 8, 12), None, 12),
    ((("pool", "m", "max", 3, 3, 2, 2, 0, 0, 6, 5, 9),
      ("pool", "a", "avg", 2, 2, 2, 2, 0, 0, 3, 3, 4)),
     (13, 11, 8), None, None, 8),
    ((("conv", "c", 7, 7, 2, 2, 3, 3, 1, 1, 9, True, 16, 16),
      ("pool", "m", "max", 3, 3, 2, 2, 0, 0, 8, 8, 9),
      ("conv", "d", 1, 1, 1, 1, 0, 0, 1, 1, 3, True, 8, 8)),
     (32, 32, 3), (7, 7, 3, 8), None, 8),
    # ten stages, YOLO-lite's shape under ZU9 (conv/pool pairs from three
    # channels) with a ragged tail: a ceil-mode max pool, a padded 3x3 one,
    # a conv without ReLU and an avg pool at stride 1
    ((("conv", "c0", 3, 3, 1, 1, 1, 1, 1, 1, 8, True, 40, 36),
      ("pool", "p0", "max", 2, 2, 2, 2, 0, 0, 20, 18, 4),
      ("conv", "c1", 3, 3, 1, 1, 1, 1, 1, 1, 10, True, 20, 18),
      ("pool", "p1", "max", 2, 2, 2, 2, 0, 0, 10, 9, 4),
      ("conv", "c2", 3, 3, 1, 1, 1, 1, 1, 1, 10, True, 10, 9),
      ("pool", "p2", "max", 2, 2, 2, 2, 0, 0, 5, 5, 4),
      ("conv", "c3", 3, 3, 1, 1, 1, 1, 1, 1, 10, True, 5, 5),
      ("pool", "p3", "max", 3, 3, 2, 2, 1, 1, 3, 3, 9),
      ("conv", "c4", 3, 3, 1, 1, 1, 1, 1, 1, 10, False, 3, 3),
      ("pool", "p4", "avg", 2, 2, 1, 1, 0, 0, 2, 2, 4)),
     (40, 36, 3), (3, 3, 3, 16), None, 16),
    # twelve stages: conv/pool pairs, ceil-mode max and avg pools, a 1x1
    # conv and an eltwise add mid-chain, a dilated conv, and a 1x1 conv
    # after a stride-1 pool as the tail
    ((("conv", "c0", 3, 3, 1, 1, 1, 1, 1, 1, 10, True, 45, 39),
      ("pool", "p0", "max", 3, 3, 2, 2, 0, 0, 22, 19, 9),
      ("conv", "c1", 3, 3, 1, 1, 1, 1, 1, 1, 10, True, 22, 19),
      ("pool", "p1", "max", 2, 2, 2, 2, 0, 0, 11, 10, 4),
      ("conv", "c2", 3, 3, 1, 1, 1, 1, 1, 1, 10, True, 11, 10),
      ("pool", "p2", "avg", 2, 2, 2, 2, 0, 0, 6, 5, 4),
      ("conv", "c3", 1, 1, 1, 1, 0, 0, 1, 1, 9, False, 6, 5),
      ("elt", "e0", 1, -1, True, 6, 5),
      ("pool", "p3", "max", 2, 2, 2, 2, 0, 0, 3, 3, 4),
      ("conv", "c4", 3, 3, 1, 1, 2, 2, 2, 2, 10, True, 3, 3),
      ("pool", "p4", "max", 2, 2, 1, 1, 0, 0, 2, 2, 4),
      ("conv", "c5", 1, 1, 1, 1, 0, 0, 1, 1, 9, True, 2, 2)),
     (45, 39, 8), (3, 3, 8, 16), (6, 5, 16), 16),
]


def hand_chain_args(i, rng, n=2):
    chain, (h, w, c), wshape, sshape, oc = HAND_CHAINS[i]
    x = i8(rng, (n, h, w, c))
    weights, biases = [], []
    cin = c
    for st in chain:
        if st[0] == "conv":
            shape = wshape if not weights else (st[2], st[3], cin, oc)
            weights.append(i8(rng, shape))
            biases.append(rng.integers(-3000, 3000, shape[-1]).astype(np.int32))
            cin = shape[-1]
    sides = [i8(rng, (n,) + sshape)] if sshape else []
    last = chain[-1]
    oh, ow = ((last[12], last[13]) if last[0] == "conv" else
              (last[9], last[10]) if last[0] == "pool" else (last[5], last[6]))
    return chain, x, weights, biases, sides, oh, ow, oc


# Fields of the chain kernel's packed descriptor (``ops.chain_plan``): its
# header, then one record per stage.
CHAIN_HDR = ("n_stages N H W C x_sn x_sh x_sw in_rows in_cols in_c in_sliced "
             "f_in fw_in q_in0 q_in1 fill0 th tw toc n_h n_w n_k OH OW OC "
             "buf_b in_ps w_off w1_off koff ring_b in_or in_oc ni "
             "ring_off ring_ks").split()
CHAIN_STG = ("type kh kw sh sw dh dw shift relu pkind cnt s_side rows cols "
             "cin cout kp sliced q0 q1 true_h true_w fout foutw fill_next "
             "out_buf side_h side_w side_sn side_sh side_sw ps or0 "
             "oc0").split()


def _rshift(v, s):
    return (np.sign(v) * ((np.abs(v) + (1 << (s - 1))) >> s) if s > 0
            else v << -s)


def _ring_acc(a, packed, c0, co, kp, ks, rot):
    """A ring stage's accumulators as the kernel forms them: passes of a
    BM x BN tile (``ops.ring_passes``; pixels inside channels), each over
    the stage's K slices of ``ks`` bytes from slice ``rot`` on, read from a
    slot that holds the pass's weight rows (a slot's rows past the stage's
    channels feed only output columns the kernel drops).  The slices cover
    K once and the passes every (pixel, channel) once; as integer sums do
    not depend on their order, the stage is one product over K in order."""
    from repro_torch.kernels.conv_fused import ops

    m = a.shape[0]
    bn, bm, mp, np_ = ops.ring_passes(co, m)
    n_sl = -(-kp // ks)
    starts = [(sl + rot) % n_sl * ks for sl in range(n_sl)]
    assert sorted(starts) == list(range(0, kp, ks))
    rows = [min(bm, m - mb * bm) for mb in range(mp)]
    cols = [min(bn, co - nb * bn) for nb in range(np_)]
    assert min(rows) > 0 and sum(rows) == m
    assert min(cols) > 0 and sum(cols) == co
    # int8 products summed in float64: exact, as every sum stays far below
    # 2^53
    return (a.astype(np.float64) @ packed[c0:c0 + co].T).astype(np.int64)


def emulate_chain_kernel(x, w, b, sides, chain, oh, ow, oc, tile):
    """What ``chain_kernel`` in csrc/conv_fused.cu computes from the packed
    descriptor and the packed weights: per block, the halo'd windows of its
    ``ni`` images (the last group ragged), one after another in each buffer
    at 16-byte boundaries, with virtual padding, stored at their pixel
    stride (the bytes past the channels hold junk the kernel never writes),
    each conv stage as the tensor cores see it — A words read at a pixel's
    offset plus the K-group offset table's entry over the pixels of all the
    block's images, B rows of the block's slice of ``pack_chain_weights``,
    staged whole or streamed through the ring pass by pass and K slice by K
    slice (``_ring_acc``) — pools and eltwise adds over the strided window,
    each window at its origin (the tile's, or a cut window's own) with
    every read clamped inside it, masking to the next stage's pad identity,
    and the final tile written where it lies inside (OH, OW).  ``tile`` is
    (th, tw, toc) or (th, tw, toc, ni)."""
    import torch

    from repro_torch.kernels.conv_fused import ops

    junk = np.random.default_rng(99)
    n_img, hh, ww, c_in = x.shape
    conv_at = [i for i, st in enumerate(chain) if st[0] == "conv"]
    oc_list = [0] * len(chain)
    for i, t in zip(conv_at, w):
        oc_list[i] = t.shape[-1]
    desc, smem = ops.chain_plan(chain, oh, ow, oc, c_in, tuple(oc_list), tile)
    assert smem <= ops.SMEM_MAX
    h = dict(zip(CHAIN_HDR, desc[:len(CHAIN_HDR)].tolist()))
    st = [dict(zip(CHAIN_STG, desc[ops.HDR + ops.STG * i:][
        :len(CHAIN_STG)].tolist())) for i in range(len(chain))]
    assert h["buf_b"] % 16 == 0 and h["w_off"] % 16 == 0 \
        and h["w1_off"] % 16 == 0 and h["ring_off"] % 16 == 0
    if h["ring_b"]:
        assert h["ring_ks"] in ops.RING_KS
        assert h["ring_off"] + ops.ring_bytes(h["ring_ks"]) == smem
        assert h["ring_off"] >= h["koff"] + max(s["kp"] for s in st)
    ni = h["ni"]
    # each buffer holds ni windows of every stage that writes it
    sizes = (h["buf_b"], h["w_off"] - h["buf_b"])
    img_bytes = [-(-h["in_rows"] * h["in_cols"] * h["in_ps"] // 16) * 16]
    for s in st[:-1]:
        img_bytes.append(-(-s["rows"] * s["cols"] * s["ps"] // 16) * 16)
    for k, nbytes in enumerate(img_bytes):
        assert ni * nbytes <= sizes[k % 2]
    # packed weights as float64 (exact for int8) once, for the products
    packed = {i: ops.pack_chain_weights(torch.as_tensor(t)).numpy().astype(
        np.float64) for i, t in zip(conv_at, w)}
    bias = dict(zip(conv_at, b))
    smap = dict(zip([i for i, s in enumerate(chain) if s[0] == "elt"], sides))
    out = np.zeros((n_img, oh, ow, oc), np.int64)
    written = np.zeros((n_img, oh, ow, oc), np.int64)

    def strided(vals, ps):
        """A (rows, cols, ch) window stored at pixel stride ps, flat."""
        r, c, chn = vals.shape
        flat = junk.integers(-128, 128, (r, c, ps)).astype(np.int64)
        flat[..., :chn] = vals
        return flat.reshape(-1)

    for n0 in range(0, n_img, ni):
        imgs = range(n0, min(n_img, n0 + ni))
        for j in range(h["n_h"]):
            for jw in range(h["n_w"]):
                for k in range(h["n_k"]):
                    org = (h["in_or"] if h["in_or"] >= 0 else j * h["f_in"],
                           h["in_oc"] if h["in_oc"] >= 0 else jw * h["fw_in"])
                    rows = org[0] + np.arange(h["in_rows"]) - h["q_in0"]
                    cols = org[1] + np.arange(h["in_cols"]) - h["q_in1"]
                    ch0 = k * h["toc"] if h["in_sliced"] else 0
                    inside = (((rows >= 0) & (rows < hh))[:, None]
                              & ((cols >= 0) & (cols < ww))[None, :])
                    flat = []
                    for n in imgs:
                        src = x[n][np.clip(rows, 0, hh - 1)][:, np.clip(
                            cols, 0, ww - 1)][..., ch0:ch0 + h["in_c"]]
                        src = np.where(inside[..., None],
                                       src.astype(np.int64), h["fill0"])
                        flat.append(strided(src, h["in_ps"]))
                    ps_in, src_rows, src_cols = (h["in_ps"], h["in_rows"],
                                                 h["in_cols"])
                    for i, s in enumerate(st):
                        c0 = k * h["toc"] if s["sliced"] else 0
                        R, C, CO = s["rows"], s["cols"], s["cout"]
                        views = [f.reshape(-1, src_cols, ps_in)
                                 for f in flat]
                        assert views[0].shape[2] >= s["cin"]
                        out_org = (s["or0"] if s["or0"] >= 0
                                   else j * s["fout"],
                                   s["oc0"] if s["oc0"] >= 0
                                   else jw * s["foutw"])
                        # the input row and column each output reads first,
                        # clamped so its taps stay inside the window
                        row0 = np.clip(np.arange(R) * s["sh"] + out_org[0]
                                     * s["sh"] - org[0], 0, src_rows
                                     - s["dh"] * (s["kh"] - 1) - 1)
                        col0 = np.clip(np.arange(C) * s["sw"] + out_org[1]
                                     * s["sw"] - org[1], 0, src_cols
                                     - s["dw"] * (s["kw"] - 1) - 1)
                        org = out_org
                        vs = []
                        if s["type"] == 0:
                            cinp = -(-s["cin"] // 4) * 4
                            kreal = s["kh"] * s["kw"] * cinp
                            koff = np.zeros(s["kp"] // 4, np.int64)
                            for e in range(kreal // 4):
                                tap, ic = divmod(4 * e, cinp)
                                ki, kj = divmod(tap, s["kw"])
                                koff[e] = ((ki * s["dh"] * src_cols
                                            + kj * s["dw"]) * ps_in + ic)
                            m = np.arange(R * C)
                            px = (row0[m // C] * src_cols
                                  + col0[m % C]) * ps_in
                            # A rows of every pixel of the block's images
                            a = np.concatenate([f[(
                                px[:, None, None] + koff[None, :, None]
                                + np.arange(4)[None, None, :])].reshape(
                                    R * C, s["kp"]) for f in flat])
                            if (h["ring_b"] >> i) & 1:
                                block = ((n0 // ni * h["n_h"] + j) * h["n_w"]
                                         + jw) * h["n_k"] + k
                                rot = block % -(-s["kp"] // h["ring_ks"])
                                acc = _ring_acc(a, packed[i], c0, CO,
                                                s["kp"], h["ring_ks"], rot)
                            else:
                                panel = packed[i][c0:c0 + CO]
                                assert panel.shape[1] == s["kp"]
                                # int8 products summed in float64: exact,
                                # as every sum stays far below 2^53
                                acc = (a.astype(np.float64)
                                       @ panel.T).astype(np.int64)
                            for g in range(len(flat)):
                                v = (acc[g * R * C:(g + 1) * R * C]
                                     + bias[i][c0:c0 + CO]).reshape(R, C, CO)
                                vs.append(_rshift(v, s["shift"]))
                        for g, n in enumerate(imgs):
                            win = views[g][..., :s["cin"]]

                            def tap(ki, kj):
                                return win[row0 + ki][:, col0 + kj]
                            if s["type"] == 1:
                                ws = [tap(ki, kj) for ki in range(s["kh"])
                                      for kj in range(s["kw"])]
                                if s["pkind"] == 0:
                                    v = np.max(ws, axis=0)
                                else:
                                    t = np.sum(ws, axis=0)
                                    v = np.sign(t) * ((np.abs(t)
                                                       + s["cnt"] // 2)
                                                      // s["cnt"])
                                vs.append(v)
                            elif s["type"] == 2:
                                side = smap[i][n].astype(np.int64)
                                sr = org[0] + np.arange(R) - s["q0"]
                                sc = org[1] + np.arange(C) - s["q1"]
                                ok = (((sr >= 0) & (sr < side.shape[0]))[
                                    :, None] & ((sc >= 0)
                                                & (sc < side.shape[1]))[
                                                    None, :])
                                sv = side[np.clip(sr, 0, side.shape[0] - 1)][
                                    :, np.clip(sc, 0, side.shape[1] - 1)][
                                    ..., c0:c0 + CO]
                                vs.append(_rshift(tap(0, 0), s["shift"])
                                          + _rshift(np.where(ok[..., None],
                                                             sv, 0),
                                                    s["s_side"]))
                        new_flat = []
                        for g, n in enumerate(imgs):
                            v = vs[g]
                            if s["relu"]:
                                v = np.maximum(v, 0)
                            v = np.clip(v, -128, 127)
                            if s["out_buf"] == 2:
                                r0, cc0 = j * h["th"], jw * h["tw"]
                                r1, c1 = min(oh, r0 + R), min(ow, cc0 + C)
                                out[n, r0:r1, cc0:c1, c0:c0 + CO] = \
                                    v[:r1 - r0, :c1 - cc0]
                                written[n, r0:r1, cc0:c1, c0:c0 + CO] += 1
                            else:
                                pr = org[0] + np.arange(R)[:, None]
                                pc = org[1] + np.arange(C)[None, :]
                                valid = ((pr >= s["q0"])
                                         & (pr < s["q0"] + s["true_h"])
                                         & (pc >= s["q1"])
                                         & (pc < s["q1"] + s["true_w"]))
                                v = np.where(valid[..., None], v,
                                             s["fill_next"])
                                assert s["ps"] % 4 == 0 and s["ps"] >= CO
                                new_flat.append(strided(v, s["ps"]))
                        flat, ps_in, src_rows, src_cols = (new_flat, s["ps"],
                                                           R, C)
    assert (written == 1).all()     # every output by exactly one block
    return out.astype(np.int8)


# Horizontal launches (h, w, ic, oc, kh, kw, stride, pad): GoogLeNet-224's
# nine inception modules (1x1, stride 1, so M = h*w at batch 1, K = ic and
# N = oc, the sum of the siblings' channels), then ragged ones: M not a
# multiple of a tile with N not a multiple of 8 and K not a multiple of 32,
# a split-K case, IC = 3, and general windows (3x3, stride 2, padded).
GOOGLENET_HORIZONTAL = [
    (28, 28, 192, 176, 1, 1, 1, 0), (28, 28, 256, 288, 1, 1, 1, 0),
    (14, 14, 480, 304, 1, 1, 1, 0), (14, 14, 512, 296, 1, 1, 1, 0),
    (14, 14, 512, 280, 1, 1, 1, 0), (14, 14, 512, 288, 1, 1, 1, 0),
    (14, 14, 528, 448, 1, 1, 1, 0), (7, 7, 832, 448, 1, 1, 1, 0),
    (7, 7, 832, 624, 1, 1, 1, 0)]
RAGGED_HORIZONTAL = [
    (5, 7, 48, 37, 1, 1, 1, 0), (7, 7, 832, 40, 1, 1, 1, 0),
    (9, 11, 3, 20, 3, 3, 2, 1), (9, 11, 32, 24, 3, 3, 2, 1),
    (13, 13, 24, 70, 3, 3, 2, 1)]


def horizontal_args(shape, n, rng):
    """Random int8 input and OC-stacked weights, int32 bias, shift and ReLU
    vectors of one horizontal launch, as numpy, with its stride and pad."""
    h, w, ic, oc, kh, kw, s, p = shape
    return (i8(rng, (n, h, w, ic)), i8(rng, (kh, kw, ic, oc)),
            rng.integers(-3000, 3000, oc).astype(np.int32),
            rng.integers(-1, 12, oc).astype(np.int32),
            rng.integers(0, 2, oc).astype(np.int32), (s, s), (p, p))


# round_shift where the reference's int32 arithmetic wraps: shifts from 1
# past 32, on accumulators near the int32 extremes (biases within 2^20 of
# -2^31 and 2^31 - 1).
EXTREME_SHIFTS = (1, 31, 32, 33, 40)


def extreme_bias(rng, n):
    off = rng.integers(0, 1 << 20, n)
    return np.where(np.arange(n) % 2 == 0, -(1 << 31) + off,
                    (1 << 31) - 1 - off).astype(np.int32)


def extreme_chain_args(shift, rng):
    """A conv (3x3, padded, bias near the int32 extremes, requantized by
    ``shift``) and an elt stage (main shift ``shift``, side shift
    ``-shift``) at batch 2: (chain, x, weights, biases, sides, oh, ow, oc)."""
    h, w, c, oc = 9, 7, 8, 12
    chain = (("conv", "c", 3, 3, 1, 1, 1, 1, 1, 1, shift, False, h, w),
             ("elt", "e", shift, -shift, shift % 2 == 0, h, w))
    return (chain, i8(rng, (2, h, w, c)), [i8(rng, (3, 3, c, oc))],
            [extreme_bias(rng, oc)], [i8(rng, (2, h, w, oc))], h, w, oc)


def extreme_horizontal_args(rng, n=2):
    """One OC-stacked 3x3 launch whose siblings (4 channels each) carry the
    shifts of ``EXTREME_SHIFTS`` and biases near the int32 extremes, ReLU
    on every other sibling: x, w, b, shift and ReLU vectors, stride, pad."""
    h, w, ic, k = 8, 6, 16, 4
    oc = k * len(EXTREME_SHIFTS)
    shift = np.repeat(np.asarray(EXTREME_SHIFTS, np.int32), k)
    relu = np.repeat(np.arange(len(EXTREME_SHIFTS)) % 2, k).astype(np.int32)
    return (i8(rng, (n, h, w, ic)), i8(rng, (3, 3, ic, oc)),
            extreme_bias(rng, oc), shift, relu, (1, 1), (1, 1))


# --------------------------------------------------- families under a mesh
ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]
# the reference's own tolerances (tests/test_multidevice.py): loss of the
# sharded step against the unsharded one, and its params
MESH_LOSS_TOL = 5e-3
MESH_PARAM_RTOL, MESH_PARAM_ATOL = 5e-3, 5e-4
# the sharded step's gradients against the unsharded step's, each leaf
# relative to its largest |g|: the first step's learning rate (3e-6, in
# warm-up) moves no param past the params' tolerance, so only the
# gradients can show a wrong sharded layout (a partial sum left unsummed,
# a shard counted twice, a gradient of the wrong sign)
MESH_GRAD_REL_TOL = 1e-4
FP32_LOGITS_TOL = 1e-4      # TP = 2 fp32 prefill against unsharded and JAX
MESH_GRAD_ACCUM = 2
# the (2, 2) late step's data ranks: each splits its own rows into
# MESH_GRAD_ACCUM microbatches, so the unsharded step it is held against
# takes MESH_GRAD_ACCUM x MESH_DATA_RANKS microbatches of the same rows
# (Mixtral's load-balancing loss is a function of each microbatch as a
# whole, not a mean over its rows)
MESH_DATA_RANKS = 2


def tree_paths(tree, prefix="") -> dict:
    """Leaves of nested dictionaries as numpy, by "/"-joined path."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tree_paths(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def mesh_ranks(case: str, in_dir):
    """Start ``tests/torch_ranks.py CASE IN_DIR OUT`` in a subprocess (its
    own process group of spawned gloo CPU ranks, 300 s at most).  Returns
    a function that waits for it and returns rank 0's result."""
    import os
    import pickle
    import subprocess
    import sys

    out = in_dir / f"{case.replace(':', '_')}.pkl"
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT / 'tests'}",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" /
                                                 "torch_ranks.py"), case,
                             str(in_dir), str(out)],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True, env=env)

    def wait() -> dict:
        try:
            _, err = proc.communicate(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert proc.returncode == 0, err[-4000:]
        with open(out, "rb") as f:
            return pickle.load(f)

    return wait


def family_batches(cfg, seed: int = 0):
    """Numpy inputs of one family: the prefill batch and a prompt
    (B = 4, 64 positions), and a training batch (8 rows of 32 positions,
    labels the next tokens)."""
    rng = np.random.default_rng(seed)
    d, v = cfg.d_model, cfg.vocab

    def toks(b, s):
        return rng.integers(0, v, (b, s)).astype(np.int32)

    def feats(b, s):
        return rng.standard_normal((b, s, d)).astype(np.float32)

    serve = {"prompt": toks(4, 8)}
    t = toks(8, 33)
    train = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    if cfg.family == "audio":
        serve.update(frames=feats(4, 48), tokens=toks(4, 16))
        train.update(frames=feats(8, 16))
    elif cfg.family == "vlm":
        serve.update(patch_embeds=feats(4, cfg.n_patches),
                     tokens=toks(4, 64 - cfg.n_patches))
        train.update(patch_embeds=feats(8, cfg.n_patches))
    else:
        serve["tokens"] = toks(4, 64)
    return serve, train


def family_mesh_run(arch: str, d) -> dict:
    """One family at smoke size (fp32): the JAX package's weights and
    prefill, the unsharded port's prefill, serve loop and train step
    (over the late step's microbatches) on the same inputs, then the port's TP = 2 prefill
    and serve loop on (1, 2) gloo CPU ranks and its (2, 2) late step on
    four (``tests/torch_ranks.py``)."""
    import jax.numpy as jnp
    import torch

    from repro import configs as jconfigs
    from repro.launch import serve as jserve
    from repro.models import api as japi
    from repro_torch.core.carry import lm_params_from_reference
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    from repro_torch.optim.adamw import AdamWConfig, init_moments
    from torch_ranks import family_cfg

    jcfg = jconfigs.get(arch).smoke()
    cfg = family_cfg(arch)
    jparams = japi.init_params(jcfg)
    np.savez(d / "params.npz", **tree_paths(jparams))
    serve, train = family_batches(jcfg)
    np.savez(d / "batch.npz", **serve)
    np.savez(d / "train.npz", **train)
    # the ranks run while this process computes the references
    ranks = {k: mesh_ranks(f"family_{k}:{arch}", d)
             for k in ("serve", "train")}
    ins = {k: v for k, v in serve.items() if k != "prompt"}
    want = np.asarray(jserve.make_prefill_step(jcfg)(
        jparams, {k: jnp.asarray(v) for k, v in ins.items()}))
    params = lm_params_from_reference(jparams, "cpu")
    with torch.no_grad():
        plain = tserve.make_prefill_step(cfg)(
            params, {k: torch.from_numpy(v) for k, v in ins.items()}).numpy()
    tokens = tserve.serve_loop(cfg, params, serve["prompt"], 8,
                               "cpu")["tokens"]
    state = {"params": params, "opt": init_moments(params, AdamWConfig())}
    new, m = ttrain.make_train_step(family_cfg(arch, flash=False),
                                    grad_accum=MESH_GRAD_ACCUM
                                    * MESH_DATA_RANKS)(
        state, {k: torch.from_numpy(v) for k, v in train.items()})
    return {"cfg": cfg, "jax": want, "plain": plain, "tokens": tokens,
            "loss": float(m["loss"]),
            "params": tree_paths(_numpy(new["params"])),
            "grads": tree_paths(_numpy(m["grads"])),
            **{k: wait() for k, wait in ranks.items()}}


def _numpy(tree: dict) -> dict:
    return {k: (_numpy(v) if isinstance(v, dict) else v.detach().numpy())
            for k, v in tree.items()}


def check_family_serve(run: dict) -> None:
    """TP = 2 prefill within ``FP32_LOGITS_TOL`` of the unsharded port and
    of the JAX package, the serve loop's tokens those of the unsharded
    loop, and no jax or reference module loaded by the ranks."""
    r = run["serve"]
    assert r["logits"].shape == run["jax"].shape
    assert np.abs(r["logits"] - run["plain"]).max() < FP32_LOGITS_TOL
    assert np.abs(r["logits"] - run["jax"]).max() < FP32_LOGITS_TOL
    np.testing.assert_array_equal(r["tokens"], run["tokens"])
    assert r["foreign_modules"] == []


def check_family_train(run: dict) -> None:
    """The (2, 2) late-sync step against the unsharded step: its loss and
    params at the reference's tolerances, each gradient leaf within
    ``MESH_GRAD_REL_TOL`` of its largest |g|."""
    r = run["train"]
    assert abs(r["loss"] - run["loss"]) < MESH_LOSS_TOL
    grads = tree_paths(r["grads"])
    assert grads.keys() == run["grads"].keys()
    for k, want in run["grads"].items():
        assert np.isfinite(grads[k]).all(), k
        tol = MESH_GRAD_REL_TOL * np.abs(want).max()
        assert np.abs(grads[k] - want).max() <= tol, (
            k, np.abs(grads[k] - want).max(), tol)
    got = tree_paths(r["params"])
    assert got.keys() == run["params"].keys()
    for k, want in run["params"].items():
        np.testing.assert_allclose(got[k], want, rtol=MESH_PARAM_RTOL,
                                   atol=MESH_PARAM_ATOL, err_msg=k)
