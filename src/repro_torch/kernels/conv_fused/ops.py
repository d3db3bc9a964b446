"""Launchers, plain versions and launch counts of the fused conv kernels.

Port of ``src/repro/kernels/conv_fused/{ops,conv_fused}.py``.  Two kernels,
written in CUDA C++ for ``sm_90a`` in ``csrc/conv_fused.cu``:

``fused_chain``      — one lowered op chain (``lower.FusedLaunch`` of kind
                       "chain") in one launch; intermediates stay in shared
                       memory.
``fused_horizontal`` — sibling convs over OC-stacked weights with
                       per-channel shift and ReLU.

Each wrapper takes its plain PyTorch version (``fused_chain_plain``,
``fused_horizontal_plain``) only for a tensor on the CPU; on a CUDA tensor it
launches its kernel or raises.  ``LAUNCHES`` counts kernel launches and
``PLAIN_CALLS`` counts the wrappers' CPU branch.

``run_launch`` executes one ``FusedLaunch`` against an activation env; the
executor builds each launch's device weights once (``prepare_launch``).  A
chain launch's tile record (from the tile search, ``tune.tiles``) is run as
recorded or raises (``card_tile``); ``TILE_RECORDS`` counts the chain
launches that ran at one.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import int8_ops
from repro_torch.kernels import build

I8_MIN = -128

LAUNCHES = {"fused_chain": 0, "fused_horizontal": 0}
PLAIN_CALLS = {"fused_chain": 0, "fused_horizontal": 0}
TILE_RECORDS = {"applied": 0}


def reset_counts() -> None:
    for d in (LAUNCHES, PLAIN_CALLS, TILE_RECORDS):
        for k in d:
            d[k] = 0


def _bind(lib) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.repro_fused_chain.argtypes = [vp, ci, vp, ci, ci, vp]
    lib.repro_fused_chain.restype = ci
    lib.repro_fused_horizontal.argtypes = [vp, vp, vp]
    lib.repro_fused_horizontal.restype = ci


def library():
    """The conv_fused CUDA library, built at first use."""
    return build.library("conv_fused", _bind)


# ------------------------------------------------------------ static geometry
def _stage_geom(st):
    """(ekh, ekw, sh, sw, ph, pw) of one stage spec."""
    if st[0] == "conv":
        _, _, kh, kw, sh, sw, ph, pw, dh, dw = st[:10]
        return (dh * (kh - 1) + 1, dw * (kw - 1) + 1, sh, sw, ph, pw)
    if st[0] == "pool":
        _, _, _, kph, kpw, sph, spw, pph, ppw = st[:9]
        return (kph, kpw, sph, spw, pph, ppw)
    return (1, 1, 1, 1, 0, 0)   # elt


def _fill_of(st) -> int:
    """Pad identity a stage wants on its *input*."""
    return I8_MIN if (st[0] == "pool" and st[2] == "max") else 0


def _true_hw(st) -> tuple[int, int]:
    if st[0] == "conv":
        return st[12], st[13]
    if st[0] == "pool":
        return st[9], st[10]
    return st[5], st[6]


def chain_geometry(chain, th: int, oh: int, ow: int, tw: int | None = None
                   ) -> dict:
    """Static tile geometry of a lowered chain (a copy of the reference's
    ``conv_fused.chain_geometry``).

    Every tensor of the chain lives in *padded coordinates*: walking back
    from the final output (offset 0), a stage with stride ``s`` and pad ``p``
    maps its output offset ``Q`` to the input offset ``Q*s + p``.  ``rows``/
    ``cols`` are each stage's output window for one (th, tw) output tile,
    ``fout``/``foutw`` the window's step between neighbouring tiles, ``q``
    each stage output's offset.  ``in_*`` describe the input window."""
    tw = ow if tw is None else tw
    m = len(chain)
    rows = [0] * m
    cols = [0] * m
    fout = [0] * m           # padded row-offset factor of stage i's output
    foutw = [0] * m          # padded col-offset factor of stage i's output
    q = [(0, 0)] * m         # padded-coordinate offset of stage i's output
    r, c, f, fw, qq = th, tw, th, tw, (0, 0)
    for i in range(m - 1, -1, -1):
        rows[i], cols[i], fout[i], foutw[i], q[i] = r, c, f, fw, qq
        ekh, ekw, sh, sw, ph, pw = _stage_geom(chain[i])
        r = (r - 1) * sh + ekh
        c = (c - 1) * sw + ekw
        f = f * sh
        fw = fw * sw
        qq = (qq[0] * sh + ph, qq[1] * sw + pw)
    n_h = -(-oh // th)
    n_w = -(-ow // tw)
    sides = []
    for i, st in enumerate(chain):
        if st[0] == "elt":
            q_in = q[i]      # elt: input coords == output coords
            sides.append({"q": q_in, "rows": rows[i], "cols": cols[i],
                          "h_req": (n_h - 1) * fout[i] + rows[i],
                          "w_req": (n_w - 1) * foutw[i] + cols[i],
                          "f": fout[i], "fw": foutw[i]})
    return {
        "in_rows": r, "in_cols": c, "f_in": f, "fw_in": fw, "q_in": qq,
        "h_req": (n_h - 1) * f + r, "w_req": (n_w - 1) * fw + c,
        "rows": rows, "cols": cols, "fout": fout, "foutw": foutw, "q": q,
        "fill0": _fill_of(chain[0]) if chain else 0,
        "sides": sides, "th": th, "tw": tw, "n_h": n_h, "n_w": n_w,
    }


# ------------------------------------------------------------ plain versions
def fused_chain_plain(x, weights, biases, sides, *, chain, oh, ow, oc):
    """The chain over whole tensors with ``int8_ops`` semantics: each stage
    spec becomes the reference op, the ceil extension of a pool comes from
    the stage's true output extent."""
    t = x
    wi = si = 0
    for st in chain:
        if st[0] == "conv":
            _, _, kh, kw, sh, sw, ph, pw, dh, dw, shift, relu = st[:12]
            t = int8_ops.conv2d(t, weights[wi], biases[wi], stride=(sh, sw),
                                pad=(ph, pw), dilation=(dh, dw), shift=shift,
                                relu=relu)
            wi += 1
        elif st[0] == "pool":
            _, _, pkind, kh, kw, sh, sw, ph, pw, p_oh, p_ow, cnt = st[:12]
            h, w = t.shape[1:3]
            pads = (ph, max(ph, (p_oh - 1) * sh + kh - h - ph),
                    pw, max(pw, (p_ow - 1) * sw + kw - w - pw))
            if pkind == "max":
                t = int8_ops.pool_windows(t, (kh, kw), (sh, sw), pads, I8_MIN,
                                          torch.maximum)
            else:
                s = int8_ops.pool_windows(t.to(torch.int32), (kh, kw),
                                          (sh, sw), pads, 0, torch.add)
                t = int8_ops.sat8(int8_ops.rounded_div(s, cnt))
        else:
            _, _, s_main, s_side, relu_out = st[:5]
            z = int8_ops.add32(int8_ops.round_shift(t, s_main),
                               int8_ops.round_shift(sides[si], s_side))
            if relu_out:
                z = z.clamp(min=0)
            t = int8_ops.sat8(z)
            si += 1
    return t


def fused_horizontal_plain(x, w, b, shift_vec, relu_vec, *, stride, pad):
    """One conv over OC-stacked weights, then per-channel shift and ReLU."""
    acc = int8_ops.conv_acc(x, w, stride=tuple(stride), pad=tuple(pad))
    y = int8_ops.round_shift(int8_ops.add32(acc, b), shift_vec)
    y = torch.where(relu_vec != 0, y.clamp(min=0), y)
    return int8_ops.sat8(y)


# ------------------------------------------------------------ chain kernel
# Shared memory a block may use (H100: 227 KB) and the SM count; the tile
# chooser reads these, the kernel is told the buffer sizes it was given.
SMEM_MAX = 232448
N_SM = 132
THREADS = 256
MAX_STAGES = 8
HDR, STG = 32, 32           # int32 fields of the header / of each stage
_TYPE = {"conv": 0, "pool": 1, "elt": 2}
_PKIND = {"max": 0, "avg": 1, "gap": 1}   # gap is an avg over the window


def _align(n: int, a: int = 16) -> int:
    return -(-n // a) * a


def _chain_channels(chain, c_in: int, oc_of):
    """(channels of each stage's output, index of the last conv)."""
    conv_idx = [i for i, st in enumerate(chain) if st[0] == "conv"]
    last_conv = conv_idx[-1] if conv_idx else -1
    ch, c = [], c_in
    for i, st in enumerate(chain):
        if st[0] == "conv":
            c = oc_of(i)
        ch.append(c)
    return ch, last_conv


def _ps(ch: int) -> int:
    """Pixel stride in bytes of a window of ``ch`` channels: rounded up to 4
    (whole words for the conv stages' A loads), plus 16 where that is a
    multiple of 32 words, which would put a fragment's 8 pixels in one
    shared-memory bank."""
    p = _align(ch, 4)
    return p + 16 if (p // 4) % 8 == 0 else p


def _kp(kh: int, kw: int, cin: int) -> int:
    """Packed K of a conv: kh * kw * (cin rounded up to 4), rounded to 32."""
    return _align(kh * kw * _align(cin, 4), 32)


def conv_nt(cout: int) -> int:
    """n8 tiles of a warp item of a conv stage (``conv_nt`` in the kernel)."""
    return 4 if cout >= 32 else (2 if cout > 8 else 1)


def _panel(cout: int, kp: int) -> int:
    """Shared bytes of a block's weight panel: its channels rounded up to a
    warp item's, rows of kp + 16 bytes (an odd number of 16-byte chunks)."""
    nt = conv_nt(cout)
    return _align(cout, 8 * nt) * (kp + 16)


def _layout(chain, geom, ch, last_conv, c_in, toc) -> dict:
    """Shared memory of one block at one tiling: the two window buffers
    (window k in A when k is even, B when odd; k = 0 is the input, pixel
    strides ``_ps``), the weight panel buffers (even convs' in the first,
    odd convs' in the second, so the next conv's panel loads while a stage
    computes) and the K-group offset table.  A panel that does not fit
    beside the rest (largest first) is read from device memory instead:
    bit i of ``global_b`` marks stage i."""
    m = len(chain)
    cout = [toc if i >= last_conv else ch[i] for i in range(m)]
    in_c = toc if last_conv < 0 else c_in
    ps = [_ps(c) for c in cout]
    win = [geom["in_rows"] * geom["in_cols"] * _ps(in_c)] + [
        geom["rows"][i] * geom["cols"][i] * ps[i] for i in range(m - 1)]
    size_a = _align(max(win[0::2]))
    size_b = _align(max(win[1::2])) if m > 1 else 0
    convs, kps, cin = [], {}, in_c
    for i, st in enumerate(chain):
        if st[0] == "conv":
            convs.append(i)
            kps[i] = _kp(st[2], st[3], cin)
        cin = cout[i]
    panels = {i: _panel(cout[i], kps[i]) for i in convs}
    staged = set(convs)

    def buffers():
        return [max([panels[i] for i in convs[par::2] if i in staged],
                    default=0) for par in (0, 1)]
    table = 4 * max([kp // 4 for kp in kps.values()], default=0)
    while staged and size_a + size_b + sum(buffers()) + table > SMEM_MAX:
        staged.remove(max(staged, key=lambda i: panels[i]))
    w0, w1 = buffers()
    return {"cout": cout, "in_c": in_c, "ps": ps, "win": win,
            "size_a": size_a, "size_b": size_b, "kps": kps,
            "panels": panels, "staged": staged,
            "global_b": sum(1 << i for i in convs if i not in staged),
            "w_off": size_a + size_b, "w1_off": size_a + size_b + w0,
            "koff": size_a + size_b + w0 + w1,
            "smem": size_a + size_b + w0 + w1 + table}


def _plan_cost(chain, geom, ch, last_conv, c_in, toc, n, oc):
    """(smem bytes, estimated time, issued work) of one tiling.

    Per block, in rough cycles: the window and staged weight bytes it
    loads, and for each conv stage its rounds of warp items (16 pixels x
    8 * ``conv_nt`` channels, eight warps at a time) times the K steps of 32
    an item takes (dearer where B comes from device memory); pools and
    eltwise adds a value per thread a round.  The estimate is a block's
    time times the waves of blocks the SMs hold at once; issued work counts
    the tensor-core instructions of all blocks."""
    lay = _layout(chain, geom, ch, last_conv, c_in, toc)
    cout = lay["cout"]
    cycles = 500 + lay["win"][0] / 64
    issued = 0
    for i, st in enumerate(chain):
        rows, cols = geom["rows"][i], geom["cols"][i]
        if st[0] == "conv":
            nt = conv_nt(cout[i])
            items = -(-rows * cols // 16) * -(-cout[i] // (8 * nt))
            steps = lay["kps"][i] // 32
            per = 6 + 2 * nt
            if i in lay["staged"]:
                cycles += lay["panels"][i] / 32
            else:
                per += 8 * nt
            cycles += 100 + -(-items // (THREADS // 32)) * steps * per
            issued += items * steps * nt
        elif st[0] == "pool":
            cycles += -(-rows * cols * cout[i] // THREADS) * st[3] * st[4] * 4
        else:
            cycles += -(-rows * cols * cout[i] // THREADS) * 8
    blocks = n * geom["n_h"] * geom["n_w"] * (oc // toc)
    occ = max(1, min(4, SMEM_MAX // (lay["smem"] + 1024)))
    est = cycles * -(-blocks // (N_SM * occ))
    return lay["smem"], est, issued * blocks


def _ladder(n: int) -> list[int]:
    out = [t for t in (32, 16, 8, 4, 2, 1) if t < n]
    return sorted(set(out + [min(n, 32)]), reverse=True)


@functools.lru_cache(maxsize=None)
def choose_chain_tile(chain, oh: int, ow: int, oc: int, c_in: int, n: int,
                      oc_list: tuple) -> tuple[int, int, int]:
    """(th, tw, toc) for the card: among the tilings whose buffers fit in a
    block's shared memory and that give every SM a block (or as many blocks
    as the output allows), the one whose estimated time (per-block work
    times waves of blocks over the SMs) is least.  The output does not
    depend on the choice: the padded-coordinate masking makes every tile
    exact."""
    ch, last_conv = _chain_channels(chain, c_in, lambda i: oc_list[i])
    tocs = [t for t in (oc, oc // 2, oc // 4, oc // 8, 64, 32, 16, 8)
            if t >= 1 and oc % t == 0]
    fill = min(N_SM, n * oh * ow * (oc // min(tocs)))
    best = None
    for th in _ladder(oh):
        for tw in _ladder(ow):
            geom = chain_geometry(chain, th, oh, ow, tw)
            for toc in sorted(set(tocs), reverse=True):
                smem, est, total = _plan_cost(chain, geom, ch, last_conv,
                                              c_in, toc, n, oc)
                if smem > SMEM_MAX:
                    continue
                blocks = n * geom["n_h"] * geom["n_w"] * (oc // toc)
                key = (blocks < fill, est, total, -th * tw)
                if best is None or key < best[0]:
                    best = (key, (th, tw, toc))
    if best is None:
        raise ValueError(f"chain {[st[1] for st in chain]} does not fit in "
                         f"{SMEM_MAX} bytes of shared memory even at 1x1")
    return best[1]


def card_tile(chain, oh: int, ow: int, oc: int, c_in: int, oc_list: tuple,
              tile) -> tuple[tuple, str | None]:
    """The (th, tw, toc) the chain kernel runs for a forced tile — th and tw
    clamped to the output — and why the card cannot run it (None when it
    can): the OC grid axis cannot run ragged, and a block's buffers must
    fit in its shared memory."""
    th, tw, toc = (max(1, min(int(tile[0]), oh)),
                   max(1, min(int(tile[1]), ow)), int(tile[2]))
    if toc < 1 or oc % toc:
        return (th, tw, toc), f"toc {toc} does not divide {oc}"
    _, smem = chain_plan(chain, oh, ow, oc, c_in, oc_list, (th, tw, toc))
    if smem > SMEM_MAX:
        return (th, tw, toc), (f"needs {smem} bytes of shared memory, a "
                               f"block has {SMEM_MAX}")
    return (th, tw, toc), None


@functools.lru_cache(maxsize=None)
def chain_plan(chain, oh: int, ow: int, oc: int, c_in: int, oc_list: tuple,
               tile: tuple) -> tuple[np.ndarray, int]:
    """Packed int32 descriptor (header + one record per stage) of a chain at
    one tiling, and its shared-memory bytes.  Per-call fields (batch, input
    and side strides) are left 0 and filled by the wrapper."""
    th, tw, toc = tile
    m = len(chain)
    if m > MAX_STAGES:
        raise ValueError(f"chain of {m} stages; the kernel takes "
                         f"{MAX_STAGES}")
    geom = chain_geometry(chain, th, oh, ow, tw)
    ch, last_conv = _chain_channels(chain, c_in, lambda i: oc_list[i])
    lay = _layout(chain, geom, ch, last_conv, c_in, toc)
    cout, in_c = lay["cout"], lay["in_c"]
    d = np.zeros(HDR + STG * m, np.int32)
    d[0] = m
    d[4] = c_in
    d[8:11] = (geom["in_rows"], geom["in_cols"], in_c)
    d[11] = int(last_conv < 0)
    d[12:17] = (geom["f_in"], geom["fw_in"], geom["q_in"][0],
                geom["q_in"][1], geom["fill0"])
    d[17:23] = (th, tw, toc, geom["n_h"], geom["n_w"], oc // toc)
    d[23:26] = (oh, ow, oc)
    d[26:32] = (lay["size_a"], _ps(in_c), lay["w_off"], lay["w1_off"],
                lay["koff"], lay["global_b"])
    cin = in_c
    for i, st in enumerate(chain):
        s = d[HDR + STG * i:HDR + STG * (i + 1)]
        s[0] = _TYPE[st[0]]
        ekh, ekw, sh, sw, _, _ = _stage_geom(st)
        if st[0] == "conv":
            s[1:7] = (st[2], st[3], sh, sw, st[8], st[9])
            s[7], s[8] = st[10], int(st[11])
            s[16] = lay["kps"][i]
        elif st[0] == "pool":
            s[1:7] = (ekh, ekw, sh, sw, 1, 1)
            s[9], s[10] = _PKIND[st[2]], st[11]
        else:
            s[1:7] = (1, 1, 1, 1, 1, 1)
            s[7], s[11], s[8] = st[2], st[3], int(st[4])
        s[12:16] = (geom["rows"][i], geom["cols"][i], cin, cout[i])
        s[17] = int(i >= last_conv)
        s[18:20] = geom["q"][i]
        s[20:22] = _true_hw(st)
        s[22:24] = (geom["fout"][i], geom["foutw"][i])
        s[24] = _fill_of(chain[i + 1]) if i + 1 < m else 0
        s[25] = 2 if i == m - 1 else (1 if i % 2 == 0 else 0)
        s[31] = lay["ps"][i] if i < m - 1 else 0
        cin = cout[i]
    d.setflags(write=False)
    return d, lay["smem"]


def pack_chain_weights(w) -> torch.Tensor:
    """A chain conv's HWIO weights ``w`` (KH, KW, IC, OC) in the kernel's
    layout: (OC + 32, Kp) int8, OC-major with K = (kh, kw, ic) contiguous,
    ic padded to a multiple of 4 and K to ``_kp`` with zeros, and 32 zero
    rows past OC so that a block's panel (its OC tile rounded up to a warp
    item's channels) never reads past the end."""
    kh, kw, ic, oc = w.shape
    icp = _align(ic, 4)
    k = kh * kw * icp
    wp = torch.zeros((kh, kw, icp, oc), dtype=torch.int8, device=w.device)
    wp[:, :, :ic] = w
    out = torch.zeros((oc + 32, _kp(kh, kw, ic)), dtype=torch.int8,
                      device=w.device)
    out[:oc, :k] = wp.reshape(k, oc).t()
    return out


def _check(t: torch.Tensor, dtype, name: str, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, expected {dtype}")


def _chain_shapes(x_shape, w_shapes, b_shapes, side_shapes, chain,
                  oc) -> tuple:
    """Each stage's weight OC (0 for pools and elts), after checking that
    the weights, biases and sides have the shapes the chain reads."""
    n, _, _, c_in = x_shape
    conv_pos = [i for i, st in enumerate(chain) if st[0] == "conv"]
    elt_pos = [i for i, st in enumerate(chain) if st[0] == "elt"]
    if len(w_shapes) != len(conv_pos) or len(side_shapes) != len(elt_pos):
        raise ValueError(f"fused_chain: {len(w_shapes)} weights and "
                         f"{len(side_shapes)} sides for {len(conv_pos)} conv "
                         f"and {len(elt_pos)} elt stages")
    oc_list = [0] * len(chain)
    for i, ws in zip(conv_pos, w_shapes):
        oc_list[i] = ws[-1]
    oc_list = tuple(oc_list)
    ch, _ = _chain_channels(chain, c_in, lambda i: oc_list[i])
    for i, ws, bs in zip(conv_pos, w_shapes, b_shapes):
        cin = ch[i - 1] if i else c_in
        if ws[:3] != (chain[i][2], chain[i][3], cin) or bs != (oc_list[i],):
            raise ValueError(f"fused_chain: stage {i} takes a "
                             f"{chain[i][2:4]}x{cin} weight panel, got {ws} "
                             f"and bias {bs}")
    for i, ss in zip(elt_pos, side_shapes):
        if len(ss) != 4 or ss[0] != n or ss[3] != ch[i]:
            raise ValueError(f"fused_chain: stage {i} takes a side of "
                             f"{ch[i]} channels, got {ss}")
    if oc != ch[-1]:
        raise ValueError(f"fused_chain: oc {oc}, chain ends with {ch[-1]}")
    return oc_list


@functools.lru_cache(maxsize=None)
def _chain_call(chain, oh, ow, oc, tile, x_geom, w_shapes, b_shapes,
                side_geoms) -> tuple[np.ndarray, int, int]:
    """(descriptor, shared-memory bytes, blocks) of one call signature:
    the operands' shapes checked, the tile chosen (or a forced one clamped),
    and the call's batch and strides written into the descriptor."""
    x_shape, x_strides = x_geom
    n, _, _, c_in = x_shape
    oc_list = _chain_shapes(x_shape, w_shapes, b_shapes,
                            [g[0] for g in side_geoms], chain, oc)
    if tile is None:
        tile = choose_chain_tile(chain, oh, ow, oc, c_in, n, oc_list)
    else:
        tile, why = card_tile(chain, oh, ow, oc, c_in, oc_list, tile)
        if why:
            raise ValueError(f"fused_chain: tile {tile}: {why}")
    desc, smem = chain_plan(chain, oh, ow, oc, c_in, oc_list, tile)
    desc = desc.copy()
    desc[1:4] = x_shape[:3]
    desc[5:8] = x_strides[:3]
    elt_pos = [i for i, st in enumerate(chain) if st[0] == "elt"]
    for i, (s_shape, s_strides) in zip(elt_pos, side_geoms):
        rec = HDR + STG * i
        desc[rec + 26:rec + 28] = s_shape[1:3]
        desc[rec + 28:rec + 31] = s_strides[:3]
    desc.setflags(write=False)
    return desc, smem, n * int(desc[20]) * int(desc[21]) * int(desc[22])


def _launch_chain(x, weights, biases, sides, *, chain, oh, ow, oc, tile,
                  packed=None):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fused_chain: no kernel for device {dev}")
    _check(x, torch.int8, "x", dev)
    if x.dim() != 4 or x.stride(3) != 1:
        raise ValueError("fused_chain: x must be NHWC with unit channel "
                         "stride")
    for w, b in zip(weights, biases):
        _check(w, torch.int8, "weight", dev)
        _check(b, torch.int32, "bias", dev)
        if not b.is_contiguous():
            raise ValueError("fused_chain: biases must be contiguous")
    for sd in sides:
        _check(sd, torch.int8, "side", dev)
        if sd.stride(-1) != 1:
            raise ValueError("fused_chain: sides must have unit channel "
                             "stride")
    if packed is None:
        packed = tuple(pack_chain_weights(w) for w in weights)
    elif len(packed) != len(weights) or any(
            p.shape != (w.shape[3] + 32, _kp(*w.shape[:3])) or p.device != dev
            or not p.is_contiguous() or p.data_ptr() % 16
            for p, w in zip(packed, weights)):
        raise ValueError("fused_chain: packed weights do not match the "
                         "chain's weights (pack_chain_weights)")
    desc, smem, n_blocks = _chain_call(
        chain, oh, ow, oc, None if tile is None else tuple(tile),
        (tuple(x.shape), x.stride()), tuple(tuple(w.shape) for w in weights),
        tuple(tuple(b.shape) for b in biases),
        tuple((tuple(sd.shape), sd.stride()) for sd in sides))
    out = torch.empty((x.shape[0], oh, ow, oc), dtype=torch.int8, device=dev)
    ptrs = np.zeros(2 + 3 * MAX_STAGES, np.int64)
    ptrs[0], ptrs[1] = x.data_ptr(), out.data_ptr()
    conv_pos = [i for i, st in enumerate(chain) if st[0] == "conv"]
    for i, w, b in zip(conv_pos, packed, biases):
        ptrs[2 + 3 * i], ptrs[3 + 3 * i] = w.data_ptr(), b.data_ptr()
    elt_pos = [i for i, st in enumerate(chain) if st[0] == "elt"]
    for i, sd in zip(elt_pos, sides):
        ptrs[4 + 3 * i] = sd.data_ptr()
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.repro_fused_chain(
        desc.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(len(desc)),
        ptrs.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(n_blocks),
        ctypes.c_int(smem), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_chain launch failed: "
                           f"{build.error(lib, rc)}")
    LAUNCHES["fused_chain"] += 1
    return out


def fused_chain(x, weights, biases, sides, *, chain, oh, ow, oc,
                tile=None, packed=None):
    """Run a lowered chain.  x (N,H,W,C) int8 unpadded; one (KH,KW,IC,OC)
    int8 weight and (OC,) int32 bias per conv stage; one int8 side per elt
    stage.  ``tile`` (th, tw, toc) overrides the card's tile choice;
    ``packed`` is ``pack_chain_weights`` of each weight, made once by the
    caller (the kernel packs them itself without it, the plain version
    ignores it)."""
    if x.device.type == "cpu":
        PLAIN_CALLS["fused_chain"] += 1
        return fused_chain_plain(x, weights, biases, sides, chain=chain,
                                 oh=oh, ow=ow, oc=oc)
    return _launch_chain(x, weights, biases, sides, chain=chain, oh=oh,
                         ow=ow, oc=oc, tile=tile, packed=packed)


# ------------------------------------------------------- horizontal kernel
HBK = 64        # K bytes per step of the horizontal kernel
HBN = 64        # output channels per tile
H_ROWS = (64, 32)   # output pixels per tile, larger first


def pack_horizontal(w, b, shift_vec, relu_vec) -> dict:
    """The horizontal kernel's operands, laid out once: the HWIO weights
    ``w`` (KH, KW, IC, OC) as an (Np, Kp) int8 matrix, OC-major with K =
    (kh, kw, ic) contiguous, K padded to ``HBK`` and OC to ``HBN`` with
    zeros; bias, shift and ReLU vectors padded to Np."""
    kh, kw, ic, oc = w.shape
    k = kh * kw * ic
    kp, np_ = -(-k // HBK) * HBK, -(-oc // HBN) * HBN
    wp = torch.zeros((np_, kp), dtype=torch.int8, device=w.device)
    wp[:oc, :k] = w.reshape(k, oc).t()

    def pad(t):
        out = torch.zeros(np_, dtype=torch.int32, device=t.device)
        out[:oc] = t
        return out
    return {"w": wp, "b": pad(b), "shift": pad(shift_vec),
            "relu": pad(relu_vec), "hwio": tuple(w.shape)}


def horizontal_plan(m: int, n: int, k: int, n_sm: int = N_SM) -> dict:
    """Tile and split of one horizontal launch for ``n_sm`` SMs: the larger
    tile if its blocks already cover the SMs, else 32-row tiles with the
    K steps split in as few equal parts as make at least ``n_sm`` blocks
    (all of them, one step each, where none does)."""
    steps = -(-k // HBK)
    n_tiles = -(-n // HBN)
    for bm in H_ROWS:
        tiles = -(-m // bm) * n_tiles
        if tiles >= n_sm:
            return {"bm": bm, "split": 1, "steps": steps,
                    "grid": (-(-m // bm), n_tiles, 1)}
    split = next(s for s in range(1, steps + 1)
                 if steps % s == 0 and (tiles * s >= n_sm or s == steps))
    return {"bm": bm, "split": split, "steps": steps,
            "grid": (-(-m // bm), n_tiles, split)}


def _launch_horizontal(x, w, b, shift_vec, relu_vec, *, stride, pad,
                       packed=None):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"fused_horizontal: no kernel for device {dev}")
    _check(x, torch.int8, "x", dev)
    _check(w, torch.int8, "w", dev)
    for t, nm in ((b, "b"), (shift_vec, "shift_vec"), (relu_vec, "relu_vec")):
        _check(t, torch.int32, nm, dev)
        if not t.is_contiguous():
            raise ValueError(f"fused_horizontal: {nm} must be contiguous")
    if x.dim() != 4 or x.stride(3) != 1:
        raise ValueError("fused_horizontal: x must be NHWC with unit channel "
                         "stride")
    n, h, wd, ic = x.shape
    kh, kw, wic, oc = w.shape
    if wic != ic or any(t.shape != (oc,) for t in (b, shift_vec, relu_vec)):
        raise ValueError(f"fused_horizontal: weights {tuple(w.shape)} with "
                         f"x of {ic} channels, vectors of "
                         f"{[tuple(t.shape) for t in (b, shift_vec, relu_vec)]}")
    if packed is None:
        packed = pack_horizontal(w, b, shift_vec, relu_vec)
    elif packed["hwio"] != tuple(w.shape) or packed["w"].device != dev:
        raise ValueError(f"fused_horizontal: weights packed for "
                         f"{packed['hwio']}, called with {tuple(w.shape)}")
    sh, sw = stride
    ph, pw = pad
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (wd + 2 * pw - kw) // sw + 1
    m = n * oh * ow
    out = torch.empty((n, oh, ow, oc), dtype=torch.int8, device=dev)
    if out.numel() == 0:
        return out
    plan = horizontal_plan(m, oc, kh * kw * ic)
    np_, kp = packed["w"].shape
    vec = (ic % 16 == 0 and x.data_ptr() % 16 == 0
           and all(s % 16 == 0 for s in x.stride()[:3]))
    scratch = None
    if plan["split"] > 1:   # partial sums, then one counter per tile
        gx, gy, _ = plan["grid"]
        scratch = torch.zeros(m * np_ + gx * gy, dtype=torch.int32,
                              device=dev)
    dims = np.array([n, h, wd, ic, *x.stride()[:3], kh, kw, sh, sw, ph, pw,
                     oh, ow, oc, kp, np_, plan["split"], plan["bm"],
                     int(vec)], np.int32)
    ptrs = np.array([x.data_ptr(), packed["w"].data_ptr(),
                     packed["b"].data_ptr(), packed["shift"].data_ptr(),
                     packed["relu"].data_ptr(), out.data_ptr(),
                     0 if scratch is None else scratch.data_ptr()], np.int64)
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.repro_fused_horizontal(
        dims.ctypes.data_as(ctypes.c_void_p),
        ptrs.ctypes.data_as(ctypes.c_void_p), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_horizontal launch failed: "
                           f"{build.error(lib, rc)}")
    LAUNCHES["fused_horizontal"] += 1
    return out


def fused_horizontal(x, w, b, shift_vec, relu_vec, *, stride, pad,
                     packed=None):
    """Sibling convs over OC-stacked weights w (KH,KW,IC,ΣOC) int8 with bias
    b and per-channel shift/ReLU vectors (ΣOC,) int32.  ``packed`` is
    ``pack_horizontal`` of the same operands, made once by the caller; the
    kernel packs them itself without it, the plain version ignores it."""
    if x.device.type == "cpu":
        PLAIN_CALLS["fused_horizontal"] += 1
        return fused_horizontal_plain(x, w, b, shift_vec, relu_vec,
                                      stride=stride, pad=pad)
    return _launch_horizontal(x, w, b, shift_vec, relu_vec, stride=stride,
                              pad=pad, packed=packed)


# ------------------------------------------------------------ executor hook
def prepare_launch(launch, qm, device) -> dict:
    """Device tensors one launch needs, built once: per-stage weights and
    biases of a chain with their kernel layout (``pack_chain_weights``,
    under "packed"), or the OC-stacked weights, bias, shift and ReLU
    vectors of a horizontal launch with their kernel layout
    (``pack_horizontal``, under "packed")."""
    dev = torch.device(device)
    if launch.kind == "horizontal":
        w = np.concatenate([qm.weights[m] for m, *_ in launch.members], -1)
        b = np.concatenate([qm.biases[m] for m, *_ in launch.members])
        shift = np.concatenate([np.full(oc, s, np.int32)
                                for _, oc, s, _ in launch.members])
        relu = np.concatenate([np.full(oc, int(r), np.int32)
                               for _, oc, _, r in launch.members])
        out = {k: torch.as_tensor(np.ascontiguousarray(v), device=dev)
               for k, v in (("w", w.astype(np.int8)),
                            ("b", b.astype(np.int32)),
                            ("shift", shift), ("relu", relu))}
        out["packed"] = pack_horizontal(out["w"], out["b"], out["shift"],
                                        out["relu"])
        return out
    weights, biases = [], []
    for st in launch.stages:
        if st[0] == "conv":
            w = np.asarray(qm.weights[st[1]], np.int8)
            if launch.fc_reshape:
                w = w.reshape(1, 1, *w.shape)
            weights.append(torch.as_tensor(np.ascontiguousarray(w),
                                           device=dev))
            biases.append(torch.as_tensor(
                np.asarray(qm.biases[st[1]], np.int32), device=dev))
    return {"weights": tuple(weights), "biases": tuple(biases),
            "packed": tuple(pack_chain_weights(w) for w in weights)}


def launch_geometry(launch, in_shape, conv_ocs) -> tuple:
    """(oh, ow, oc, c_in, oc_list) of a chain launch on an input of
    ``in_shape`` (NHWC, before an fc's flattening); ``conv_ocs`` are the
    conv stages' output channels in order."""
    oh, ow = launch.out_hw
    c_in = (in_shape[1] * in_shape[2] * in_shape[3] if launch.fc_reshape
            else in_shape[3])
    ocs = iter(int(c) for c in conv_ocs)
    oc_list = tuple(next(ocs) if st[0] == "conv" else 0
                    for st in launch.stages)
    convs = [c for c in oc_list if c]
    return oh, ow, (convs[-1] if convs else c_in), c_in, oc_list


def launch_tile(launch, in_shape, conv_ocs) -> tuple | None:
    """The tile a chain launch runs at: its record (``launch.tile``) as the
    card runs it, or None (the card's chooser) without one.  A record the
    card cannot run raises: no quiet fall back to the chooser."""
    if not launch.tile:
        return None
    oh, ow, oc, c_in, oc_list = launch_geometry(launch, in_shape, conv_ocs)
    tile, why = card_tile(launch.stages, oh, ow, oc, c_in, oc_list,
                          launch.tile)
    if why:
        raise ValueError(
            f"launch {'+'.join(launch.nodes)}: tile record "
            f"{tuple(launch.tile)} does not run on this card ({why}); "
            f"re-run the tile search (tune.search_tile_shapes) on this card")
    return tile


def run_launch(launch, env: dict, qm=None, prepared: dict | None = None
               ) -> dict:
    """Execute one FusedLaunch; returns {tensor name: int8 tensor}.

    A chain launch with a tile record (``launch.tile``) runs at that
    (th, tw, toc) — th and tw clamped to the output — and counts in
    ``TILE_RECORDS``; a record the card cannot run raises
    (``launch_tile``).  Without one the card's chooser picks the tile.

    A horizontal launch's tile record is not applied on the card:
    ``horizontal_mma_kernel`` is an implicit GEMM whose plan (rows per
    tile, K split; ``horizontal_plan``) depends only on M, N and K, so a
    (t_h, t_w, t_oc) has no knob to set there.  The tile search records
    horizontal launches with no tile (``source: "card_plan"``)."""
    x = env[launch.in_name]
    if prepared is None:
        prepared = prepare_launch(launch, qm, x.device)
    if launch.kind == "horizontal":
        y = fused_horizontal(x, prepared["w"], prepared["b"],
                             prepared["shift"], prepared["relu"],
                             stride=tuple(launch.stride),
                             pad=tuple(launch.pad),
                             packed=prepared.get("packed"))
        outs, off = {}, 0
        for m, oc_m, _, _ in launch.members:
            outs[m] = y[..., off:off + oc_m]
            off += oc_m
        return outs
    if launch.fc_reshape:
        x = x.reshape(x.shape[0], 1, 1, -1)
    weights = prepared["weights"]
    sides = tuple(env[s] for s in launch.sides)
    oh, ow = launch.out_hw
    oc = int(weights[-1].shape[-1]) if weights else int(x.shape[-1])
    tile = None
    if launch.tile:
        tile = launch_tile(launch, tuple(env[launch.in_name].shape),
                           [w.shape[-1] for w in weights])
        TILE_RECORDS["applied"] += 1
    y = fused_chain(x, weights, prepared["biases"], sides,
                    chain=launch.stages, oh=oh, ow=ow, oc=oc, tile=tile,
                    packed=prepared.get("packed"))
    return {launch.out_name: y}
