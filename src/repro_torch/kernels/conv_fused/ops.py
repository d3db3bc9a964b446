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
launches its kernel or raises.  ``LAUNCHES`` counts kernel launches (and,
under "fused_chain_ring_stages", the conv stages the chain launches ran
through the weight ring) and ``PLAIN_CALLS`` counts the wrappers' CPU
branch.

``run_launch`` executes one ``FusedLaunch`` against an activation env; the
executor builds each launch's device weights once (``prepare_launch``).  A
chain launch's tile record (from the tile search, ``tune.tiles``) is run as
recorded or raises (``card_tile``); ``TILE_RECORDS`` counts the chain
launches that ran at one.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import int8_ops
from repro_torch.kernels import build, refuse_autograd

I8_MIN = -128

LAUNCHES = {"fused_chain": 0, "fused_horizontal": 0,
            "fused_chain_ring_stages": 0}
PLAIN_CALLS = {"fused_chain": 0, "fused_horizontal": 0}
TILE_RECORDS = {"applied": 0}


def _opened(span):
    """``span`` (a context manager), or one that does nothing."""
    return span if span is not None else contextlib.nullcontext()


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
# Stages a chain may have: the kernel takes its stage records and per-stage
# pointers by value, and 24 of them keep its parameters within the 4 KB that
# every CUDA release passes (the longest chain the five CNNs lower to under
# ZU2 or ZU9 has 10 stages: YOLO-lite under ZU9).
MAX_STAGES = 24
HDR, STG = 37, 34           # int32 fields of the header / of each stage
# bytes of the kernel's parameters (ChainParams): the header, MAX_STAGES
# stage records, then x, out and three pointers a stage
CHAIN_PARAM_BYTES = 4 * (HDR + STG * MAX_STAGES) + 8 * (2 + 3 * MAX_STAGES)
_TYPE = {"conv": 0, "pool": 1, "elt": 2}
_PKIND = {"max": 0, "avg": 1, "gap": 1}   # gap is an avg over the window
# The weight ring of the conv stages whose panels do not fit (the kernel's
# RING_*): RING_SLOTS slots of ks bytes of K (RING_KS, the first that fits
# beside the windows) of up to RING_ROWS weight rows, rows ks + 16 bytes
# apart, then a full and an empty mbarrier a slot.  A ring stage runs in
# passes of a 128 x 128 tile (pixels x channels), or 256 x 64 for 64
# channels or fewer: eight warps of 32 x 64.
RING_KS, RING_SLOTS, RING_ROWS = (128, 64), 4, 128
RING_WARP_N = 64            # channels of a warp's 32 x 64 tile
# Cost model (``_plan_cost``), in the units of its staged path (about
# 25 ns each on an H100): a ring pass's K step of 32 (RING_K_STEP, for the
# block's eight warps) plus RING_ROW_STEP for each warp row of 32 pixels
# that has pixels of the pass (a pass of few pixels leaves rows idle, and
# the MMAs it issues grow with its pixels), a pass's own cost (its first
# slots and its epilogue), and the weight bytes the card's L2 streams to
# the blocks in a unit.  Fitted to the tilings of the chain launches of
# VGG16-224 under ZU2 at batch 64 and of the VGG16-224, ResNet50-224,
# GoogLeNet-224 plans (and YOLO-lite-256's and ResNet152-224's ring
# launches) at batch 1: 198 launches, 31,125 tilings timed on the card.
RING_K_STEP = 72
RING_ROW_STEP = 20
RING_PASS = 300
FETCH_BYTES_PER_UNIT = 100_000


def ring_bytes(ks: int) -> int:
    """Shared bytes of the ring at slots of ``ks`` bytes of K."""
    return RING_SLOTS * RING_ROWS * (ks + 16) + 16 * RING_SLOTS


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


def ring_passes(cout: int, m: int) -> tuple[int, int, int, int]:
    """(BN, BM, passes along the pixels, passes along the channels) of a
    ring stage of ``cout`` channels over ``m`` output pixels (the kernel's
    ``ring_plan``)."""
    bn = RING_ROWS if cout > RING_WARP_N else RING_WARP_N
    bm = 32 * (THREADS // 32) * RING_WARP_N // bn
    return bn, bm, -(-m // bm), -(-cout // bn)


def _windows(chain, geom) -> list:
    """(rows, cols, row origin, col origin) of each window a block holds,
    window k being stage k's input (k = 0 the chain's input, else stage
    k - 1's output).  A window is the tile's halo in padded coordinates,
    placed at the tile's own origin (origin -1: j * f rows and jw * fw
    columns in).  Where that halo is larger than the whole range that stage
    k's true outputs read (a small tile's receptive field beyond a small
    map), the window is cut to that range, the same for every tile, and its
    origin is the range's start: the rows it leaves out feed only outputs
    that the tile's final output does not depend on."""
    out = []
    for k, st in enumerate(chain):
        natural = ((geom["in_rows"], geom["in_cols"]) if k == 0 else
                   (geom["rows"][k - 1], geom["cols"][k - 1]))
        ekh, ekw, sh, sw, _, _ = _stage_geom(st)
        dims = []
        for n, q, t, s, e in zip(natural, geom["q"][k], _true_hw(st),
                                 (sh, sw), (ekh, ekw)):
            need = (t - 1) * s + e
            dims.append((need, q * s) if n > need else (n, -1))
        out.append((dims[0][0], dims[1][0], dims[0][1], dims[1][1]))
    return out


def _layout(chain, geom, ch, last_conv, c_in, toc, ni: int = 1) -> dict:
    """Shared memory of one block at one tiling of ``ni`` images: the two
    window buffers (window k in A when k is even, B when odd; k = 0 is the
    input, pixel strides ``_ps``, extents ``_windows``; each image's window
    on a 16-byte boundary after the one before), the weight panel buffers
    (even convs' in the first, odd convs' in the second, so the next conv's
    panel loads while a stage computes), the K-group offset table and, where
    some panel streams, the ring.  A panel that does not fit beside the rest
    (largest first) streams through the ring instead: bit i of ``ring_b``
    marks stage i, and the ring's slots take ``ring_ks`` bytes of K (the
    widest of ``RING_KS`` that fits).  ``rows`` and ``cols`` are each
    stage's output window as the block computes it; ``win`` each window's
    bytes for one image."""
    m = len(chain)
    cout = [toc if i >= last_conv else ch[i] for i in range(m)]
    in_c = toc if last_conv < 0 else c_in
    ps = [_ps(c) for c in cout]
    wins = _windows(chain, geom)
    rows = [w[0] for w in wins[1:]] + [geom["rows"][-1]]
    cols = [w[1] for w in wins[1:]] + [geom["cols"][-1]]
    win = [_align(wins[0][0] * wins[0][1] * _ps(in_c))] + [
        _align(rows[i] * cols[i] * ps[i]) for i in range(m - 1)]
    size_a = ni * max(win[0::2])
    size_b = ni * max(win[1::2]) if m > 1 else 0
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

    def ring(ks):
        return ring_bytes(ks) if len(staged) < len(convs) else 0

    def total(ks):
        return size_a + size_b + sum(buffers()) + table + ring(ks)
    table = 4 * max([kp // 4 for kp in kps.values()], default=0)
    for ks in RING_KS:              # wider slots where they fit
        staged = set(convs)
        while staged and total(ks) > SMEM_MAX:
            staged.remove(max(staged, key=lambda i: panels[i]))
        if total(ks) <= SMEM_MAX:
            break
    w0, w1 = buffers()
    koff = size_a + size_b + w0 + w1
    return {"cout": cout, "in_c": in_c, "ps": ps, "win": win,
            "windows": wins, "rows": rows, "cols": cols, "ni": ni,
            "size_a": size_a, "size_b": size_b, "kps": kps,
            "panels": panels, "staged": staged,
            "ring_b": sum(1 << i for i in convs if i not in staged),
            "w_off": size_a + size_b, "w1_off": size_a + size_b + w0,
            "koff": koff, "ring_off": koff + table,
            "ring_ks": ks if len(staged) < len(convs) else 0,
            "smem": total(ks)}


def _block_fetch(chain, lay, count: int) -> int:
    """Weight bytes one block of ``count`` images fetches from device
    memory: each staged panel's rows once (``stage_panel``), each ring
    stage's rows once for every pass of its tile along the pixels."""
    total = 0
    for i, st in enumerate(chain):
        if st[0] != "conv":
            continue
        cout, kp = lay["cout"][i], lay["kps"][i]
        if i in lay["staged"]:
            total += _align(cout, 8 * conv_nt(cout)) * kp
        else:
            px = count * lay["rows"][i] * lay["cols"][i]
            total += ring_passes(cout, px)[2] * cout * kp
    return total


def _fetch(chain, lay, n: int, tiles: int) -> int:
    """Weight bytes a launch of batch ``n`` fetches over its blocks:
    ``tiles`` blocks (spatial tiles x OC tiles) for each group of ``ni``
    images, the last group ragged."""
    ni = lay["ni"]
    full, rest = divmod(n, ni)
    out = full * _block_fetch(chain, lay, ni)
    if rest:
        out += _block_fetch(chain, lay, rest)
    return out * tiles


def _plan_cost(chain, geom, ch, last_conv, c_in, toc, n, oc, ni: int = 1):
    """(smem bytes, estimated time, issued work, fetched weight bytes) of
    one tiling of blocks of ``ni`` images.

    Per block, in rough cycles: the window and staged weight bytes it
    loads; for each staged conv stage its rounds of warp items (16 pixels
    x 8 * ``conv_nt`` channels, eight warps at a time) times the K steps of
    32 an item takes; for each ring stage its passes (``ring_passes``)
    times its K steps, and its K steps times the warp rows that hold
    pixels; pools and eltwise adds a value per thread a round.
    The blocks' work is a block's time times the waves of blocks the SMs
    hold at once; the weight stream is the launch's fetched weight bytes
    over the L2's rate.  The two overlap in part: the estimate is the
    larger plus half the smaller (as ring launches measured with and
    without their MMAs add up); a tiling without ring stages is its
    blocks' work alone, its panels charged in each block.  Issued work
    counts the tensor-core instructions of all blocks."""
    lay = _layout(chain, geom, ch, last_conv, c_in, toc, ni)
    cout = lay["cout"]
    cycles = 500 + ni * lay["win"][0] / 64
    issued = 0
    for i, st in enumerate(chain):
        px = ni * lay["rows"][i] * lay["cols"][i]
        if st[0] == "conv":
            steps = lay["kps"][i] // 32
            if i in lay["staged"]:
                nt = conv_nt(cout[i])
                items = -(-px // 16) * -(-cout[i] // (8 * nt))
                cycles += (lay["panels"][i] / 32 + 100
                           + -(-items // (THREADS // 32)) * steps
                           * (6 + 2 * nt))
                issued += items * steps * nt
            else:
                bn, bm, mp, np_ = ring_passes(cout[i], px)
                cycles += (100 + mp * np_ * (steps * RING_K_STEP + RING_PASS)
                           + np_ * steps * -(-px // 32) * RING_ROW_STEP)
                issued += mp * np_ * steps * (bm // 16) * (bn // 8)
        elif st[0] == "pool":
            cycles += -(-px * cout[i] // THREADS) * st[3] * st[4] * 4
        else:
            cycles += -(-px * cout[i] // THREADS) * 8
    tiles = geom["n_h"] * geom["n_w"] * (oc // toc)
    blocks = -(-n // ni) * tiles
    # blocks an SM holds: by shared memory, at most four, and two for the
    # ring's kernel (its registers allow no more)
    occ = max(1, min(2 if lay["ring_b"] else 4,
                     SMEM_MAX // (lay["smem"] + 1024)))
    fetch = _fetch(chain, lay, n, tiles)
    work = cycles * -(-blocks // (N_SM * occ))
    if not lay["ring_b"]:        # staged panels: charged in each block
        return lay["smem"], work, issued * blocks, fetch
    stream = fetch / FETCH_BYTES_PER_UNIT
    est = max(work, stream) + min(work, stream) / 2
    return lay["smem"], est, issued * blocks, fetch


def _ladder(n: int) -> list[int]:
    out = [t for t in (32, 16, 8, 4, 2, 1) if t < n]
    return sorted(set(out + [min(n, 32)]), reverse=True)


def _images(n: int) -> list[int]:
    """Images a block may take at batch ``n``: powers of two below it, and
    ``n`` itself."""
    return sorted({t for t in (1, 2, 4, 8, 16, 32) if t < n} | {n})


def _tocs(oc: int) -> list[int]:
    """Output-channel tiles the chooser weighs, largest first."""
    return sorted({t for t in (oc, oc // 2, oc // 4, oc // 8, 64, 32, 16, 8)
                   if t >= 1 and oc % t == 0}, reverse=True)


def chain_tile_candidates(chain, oh: int, ow: int, oc: int, c_in: int,
                          n: int, oc_list: tuple, shape: tuple = ()):
    """Every tiling the chooser weighs at batch ``n``: ((th, tw, toc, ni),
    blocks, smem bytes, estimated time, issued work, fetched weight bytes)
    for the tilings whose buffers fit in a block's shared memory; with
    ``shape`` (th, tw, toc), only the counts of images at that shape."""
    ch, last_conv = _chain_channels(chain, c_in, lambda i: oc_list[i])
    ths, tws, tocs = (([shape[0]], [shape[1]], [shape[2]]) if shape else
                      (_ladder(oh), _ladder(ow), _tocs(oc)))
    for th in ths:
        for tw in tws:
            geom = chain_geometry(chain, th, oh, ow, tw)
            for toc in tocs:
                for ni in _images(n):
                    smem, est, total, fetch = _plan_cost(
                        chain, geom, ch, last_conv, c_in, toc, n, oc, ni)
                    if smem > SMEM_MAX:
                        break          # more images take more windows
                    blocks = -(-n // ni) * geom["n_h"] * geom["n_w"] * (
                        oc // toc)
                    yield (th, tw, toc, ni), blocks, smem, est, total, fetch


@functools.lru_cache(maxsize=None)
def choose_chain_tile(chain, oh: int, ow: int, oc: int, c_in: int, n: int,
                      oc_list: tuple, shape: tuple = ()
                      ) -> tuple[int, int, int, int]:
    """(th, tw, toc, ni) for the card: among the tilings whose buffers fit
    in a block's shared memory (``chain_tile_candidates``) and that give at
    least half the SMs a block (or half as many blocks as the output
    allows), the one whose estimated time (per-block work times waves of
    blocks over the SMs, or the weight bytes fetched over the L2's rate) is
    least.  (Fewer, larger blocks often win: each block of a chain
    recomputes the stages before its last conv and fetches their weights;
    a rule that every SM get a block kept most batch-1 ResNet and VGG16
    chains off their fastest tilings.)  A block takes ``ni`` images; at
    batch 1 that is one.  With ``shape`` (th, tw,
    toc), as a tile record fixes it, only ``ni`` is chosen.  The output
    does not depend on the choice: the padded-coordinate masking makes
    every tile exact."""
    fill = min(N_SM, n * oh * ow * (oc // _tocs(oc)[-1]))
    best = None
    for tile, blocks, _, est, total, _ in chain_tile_candidates(
            chain, oh, ow, oc, c_in, n, oc_list, shape):
        key = (2 * blocks < fill, est, total, -tile[0] * tile[1], tile[3])
        if best is None or key < best[0]:
            best = (key, tile)
    if best is None:
        raise ValueError(f"chain {[st[1] for st in chain]} does not fit in "
                         f"{SMEM_MAX} bytes of shared memory even at 1x1")
    return best[1]


def card_tile(chain, oh: int, ow: int, oc: int, c_in: int, oc_list: tuple,
              tile) -> tuple[tuple, str | None]:
    """The tile the chain kernel runs for a forced (th, tw, toc) or
    (th, tw, toc, ni) — th and tw clamped to the output, in the form it was
    given (without ni a block takes one image) — and why the card cannot
    run it (None when it can): the OC grid axis cannot run ragged, and a
    block's buffers must fit in its shared memory."""
    th, tw, toc = (max(1, min(int(tile[0]), oh)),
                   max(1, min(int(tile[1]), ow)), int(tile[2]))
    t = (th, tw, toc, *(int(v) for v in tile[3:4]))
    if toc < 1 or oc % toc:
        return t, f"toc {toc} does not divide {oc}"
    if _tile4(t)[3] < 1:
        return t, f"ni {t[3]} is not a count of images"
    _, smem = chain_plan(chain, oh, ow, oc, c_in, oc_list, t)
    if smem > SMEM_MAX:
        return t, (f"needs {smem} bytes of shared memory, a block has "
                   f"{SMEM_MAX}")
    return t, None


def _tile4(tile) -> tuple:
    """A tile as (th, tw, toc, ni); a 3-tuple takes one image a block."""
    return tuple(tile) if len(tile) > 3 else (*tile, 1)


@functools.lru_cache(maxsize=None)
def chain_plan(chain, oh: int, ow: int, oc: int, c_in: int, oc_list: tuple,
               tile: tuple) -> tuple[np.ndarray, int]:
    """Packed int32 descriptor (header + one record per stage) of a chain at
    one tiling, (th, tw, toc) or (th, tw, toc, ni), and its shared-memory
    bytes.  Per-call fields (batch, input and side strides) are left 0 and
    filled by the wrapper."""
    th, tw, toc, ni = _tile4(tile)
    m = len(chain)
    if m > MAX_STAGES:
        raise ValueError(f"chain of {m} stages; the kernel takes at most "
                         f"{MAX_STAGES}")
    geom = chain_geometry(chain, th, oh, ow, tw)
    ch, last_conv = _chain_channels(chain, c_in, lambda i: oc_list[i])
    lay = _layout(chain, geom, ch, last_conv, c_in, toc, ni)
    cout, in_c = lay["cout"], lay["in_c"]
    d = np.zeros(HDR + STG * m, np.int32)
    d[0] = m
    d[4] = c_in
    wins = lay["windows"]
    d[8:11] = (wins[0][0], wins[0][1], in_c)
    d[11] = int(last_conv < 0)
    d[12:17] = (geom["f_in"], geom["fw_in"], geom["q_in"][0],
                geom["q_in"][1], geom["fill0"])
    d[17:23] = (th, tw, toc, geom["n_h"], geom["n_w"], oc // toc)
    d[23:26] = (oh, ow, oc)
    d[26:32] = (lay["size_a"], _ps(in_c), lay["w_off"], lay["w1_off"],
                lay["koff"], lay["ring_b"])
    d[32:34] = wins[0][2:]
    d[34:37] = (ni, lay["ring_off"], lay["ring_ks"])
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
        s[12:16] = (lay["rows"][i], lay["cols"][i], cin, cout[i])
        s[17] = int(i >= last_conv)
        s[18:20] = geom["q"][i]
        s[20:22] = _true_hw(st)
        s[22:24] = (geom["fout"][i], geom["foutw"][i])
        s[24] = _fill_of(chain[i + 1]) if i + 1 < m else 0
        s[25] = 2 if i == m - 1 else (1 if i % 2 == 0 else 0)
        s[31] = lay["ps"][i] if i < m - 1 else 0
        s[32:34] = wins[i + 1][2:] if i < m - 1 else (-1, -1)
        cin = cout[i]
    d.setflags(write=False)
    return d, lay["smem"]


@functools.lru_cache(maxsize=None)
def chain_fetch(chain, oh: int, ow: int, oc: int, c_in: int, oc_list: tuple,
                tile: tuple, n: int) -> int:
    """Weight bytes a launch at ``tile`` and batch ``n`` fetches from
    device memory (``_fetch``): what the planner charges."""
    th, tw, toc, ni = _tile4(tile)
    geom = chain_geometry(chain, th, oh, ow, tw)
    ch, last_conv = _chain_channels(chain, c_in, lambda i: oc_list[i])
    lay = _layout(chain, geom, ch, last_conv, c_in, toc, ni)
    return _fetch(chain, lay, n, geom["n_h"] * geom["n_w"] * (oc // toc))


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
    and the call's batch and strides written into the descriptor; a block
    takes the tile's ``ni`` images, so the batch makes ceil(n / ni) groups
    of blocks."""
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
    groups = -(-n // int(desc[34]))
    return desc, smem, groups * int(desc[20]) * int(desc[21]) * int(desc[22])


def _launch_chain(x, weights, biases, sides, *, chain, oh, ow, oc, tile,
                  packed=None, span=None):
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
    with _opened(span):
        rc = lib.repro_fused_chain(
            desc.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(len(desc)),
            ptrs.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(n_blocks),
            ctypes.c_int(smem), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_chain launch failed: "
                           f"{build.error(lib, rc)}")
    LAUNCHES["fused_chain"] += 1
    LAUNCHES["fused_chain_ring_stages"] += bin(int(desc[31])).count("1")
    return out


def fused_chain(x, weights, biases, sides, *, chain, oh, ow, oc,
                tile=None, packed=None, span=None):
    """Run a lowered chain.  x (N,H,W,C) int8 unpadded; one (KH,KW,IC,OC)
    int8 weight and (OC,) int32 bias per conv stage; one int8 side per elt
    stage.  ``tile`` (th, tw, toc), or (th, tw, toc, ni) with ni images a
    block (one without), overrides the card's tile choice;
    ``packed`` is ``pack_chain_weights`` of each weight, made once by the
    caller (the kernel packs them itself without it, the plain version
    ignores it).  ``span``, a context manager, encloses the kernel's launch
    alone, after its host preparation (the plain version's whole run).
    Not differentiable: raises under autograd."""
    refuse_autograd("fused_chain", x, *weights, *biases, *sides)
    if x.device.type == "cpu":
        PLAIN_CALLS["fused_chain"] += 1
        with _opened(span):
            return fused_chain_plain(x, weights, biases, sides, chain=chain,
                                     oh=oh, ow=ow, oc=oc)
    return _launch_chain(x, weights, biases, sides, chain=chain, oh=oh,
                         ow=ow, oc=oc, tile=tile, packed=packed, span=span)


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
                       packed=None, span=None):
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
        with _opened(span):
            return out
    plan = horizontal_plan(m, oc, kh * kw * ic)
    np_, kp = packed["w"].shape
    vec = (ic % 16 == 0 and x.data_ptr() % 16 == 0
           and all(s % 16 == 0 for s in x.stride()[:3]))
    dims = np.array([n, h, wd, ic, *x.stride()[:3], kh, kw, sh, sw, ph, pw,
                     oh, ow, oc, kp, np_, plan["split"], plan["bm"],
                     int(vec)], np.int32)
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _opened(span):
        scratch = None
        if plan["split"] > 1:   # partial sums, then one counter per tile
            gx, gy, _ = plan["grid"]
            scratch = torch.zeros(m * np_ + gx * gy, dtype=torch.int32,
                                  device=dev)
        ptrs = np.array([x.data_ptr(), packed["w"].data_ptr(),
                         packed["b"].data_ptr(), packed["shift"].data_ptr(),
                         packed["relu"].data_ptr(), out.data_ptr(),
                         0 if scratch is None else scratch.data_ptr()],
                        np.int64)
        rc = lib.repro_fused_horizontal(
            dims.ctypes.data_as(ctypes.c_void_p),
            ptrs.ctypes.data_as(ctypes.c_void_p), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"fused_horizontal launch failed: "
                           f"{build.error(lib, rc)}")
    LAUNCHES["fused_horizontal"] += 1
    return out


def fused_horizontal(x, w, b, shift_vec, relu_vec, *, stride, pad,
                     packed=None, span=None):
    """Sibling convs over OC-stacked weights w (KH,KW,IC,ΣOC) int8 with bias
    b and per-channel shift/ReLU vectors (ΣOC,) int32.  ``packed`` is
    ``pack_horizontal`` of the same operands, made once by the caller; the
    kernel packs them itself without it, the plain version ignores it.
    ``span`` encloses the launch's device work alone, as in
    ``fused_chain``.  Not differentiable: raises under autograd."""
    refuse_autograd("fused_horizontal", x, w, b, shift_vec, relu_vec)
    if x.device.type == "cpu":
        PLAIN_CALLS["fused_horizontal"] += 1
        with _opened(span):
            return fused_horizontal_plain(x, w, b, shift_vec, relu_vec,
                                          stride=stride, pad=pad)
    return _launch_horizontal(x, w, b, shift_vec, relu_vec, stride=stride,
                              pad=pad, packed=packed, span=span)


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
    """The (th, tw, toc, ni) a chain launch runs at: its record
    (``launch.tile``) as the card runs it, or None (the card's chooser)
    without one.  A record fixes (th, tw, toc); the images a block takes
    are the chooser's at the call's batch (``choose_chain_tile`` at that
    shape), as without a record.  A record the card cannot run raises: no
    quiet fall back to the chooser."""
    if not launch.tile:
        return None
    oh, ow, oc, c_in, oc_list = launch_geometry(launch, in_shape, conv_ocs)
    tile, why = card_tile(launch.stages, oh, ow, oc, c_in, oc_list,
                          launch.tile[:3])
    if why:
        raise ValueError(
            f"launch {'+'.join(launch.nodes)}: tile record "
            f"{tuple(launch.tile)} does not run on this card ({why}); "
            f"re-run the tile search (tune.search_tile_shapes) on this card")
    return choose_chain_tile(launch.stages, oh, ow, oc, c_in,
                             max(1, int(in_shape[0])), oc_list, tile)


def launch_plan_args(launch, in_shape, conv_ocs) -> dict:
    """What a chain launch on an input of ``in_shape`` runs at, for its
    device span: the images a block takes (``ni``) and the weight bytes the
    planner charges its blocks with fetching (``w_fetch_bytes``)."""
    oh, ow, oc, c_in, oc_list = launch_geometry(launch, in_shape, conv_ocs)
    n = int(in_shape[0])
    tile = launch_tile(launch, in_shape, conv_ocs) or choose_chain_tile(
        launch.stages, oh, ow, oc, c_in, n, oc_list)
    return {"ni": tile[3], "w_fetch_bytes": chain_fetch(
        launch.stages, oh, ow, oc, c_in, oc_list, tile, n)}


def run_launch(launch, env: dict, qm=None, prepared: dict | None = None,
               span=None) -> dict:
    """Execute one FusedLaunch; returns {tensor name: int8 tensor}.

    A chain launch with a tile record (``launch.tile``) runs at that
    (th, tw, toc) — th and tw clamped to the output — with the chooser's
    images a block at the call's batch, and counts in ``TILE_RECORDS``; a record the card cannot run raises
    (``launch_tile``).  Without one the card's chooser picks the tile.

    A horizontal launch's tile record is not applied on the card:
    ``horizontal_mma_kernel`` is an implicit GEMM whose plan (rows per
    tile, K split; ``horizontal_plan``) depends only on M, N and K, so a
    (t_h, t_w, t_oc) has no knob to set there.  The tile search records
    horizontal launches with no tile (``source: "card_plan"``).

    ``span``, a context manager (the executor's device span of the item),
    encloses the kernel's launch alone: the host's preparation before it
    does not count as the item's device time."""
    x = env[launch.in_name]
    if prepared is None:
        prepared = prepare_launch(launch, qm, x.device)
    if launch.kind == "horizontal":
        y = fused_horizontal(x, prepared["w"], prepared["b"],
                             prepared["shift"], prepared["relu"],
                             stride=tuple(launch.stride),
                             pad=tuple(launch.pad),
                             packed=prepared.get("packed"), span=span)
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
                    packed=prepared.get("packed"), span=span)
    return {launch.out_name: y}


# ------------------------------------------------------------ legacy wrapper
def supports(*, depthwise=False, **_ignored) -> bool:
    """What the chain kernel accepts (the reference's ``supports``).
    Depthwise convolution is the only structural exclusion; dilation,
    anisotropic strides and kernels and ceil or padded pool tails run
    through the kernel's padded coordinates (other keyword capabilities
    are accepted and ignored, as in the reference)."""
    return not depthwise


def fused_conv_block(x, w, b, *, stride=(1, 1), pad=(0, 0), shift=0,
                     relu=False, pool=None, eltwise=None):
    """Single conv (+maxpool | +eltwise) as a 1-2 stage chain through
    ``fused_chain`` (the reference's legacy wrapper, without its
    ``interpret``: the tensor's device picks kernel or plain version).

    eltwise = (side, s_conv, s_side, relu_out) or None; pool = (kp, sp)
    with VALID floor semantics."""
    n, h, w_, ic = x.shape
    kh, kw, _, oc = w.shape
    sh, sw = stride
    ph, pw = pad
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w_ + 2 * pw - kw) // sw + 1
    stages = [("conv", "w0", kh, kw, sh, sw, ph, pw, 1, 1,
               int(shift), bool(relu), oh, ow)]
    sides = ()
    if pool is not None:
        kp, sp = pool
        oh = (oh - kp) // sp + 1
        ow = (ow - kp) // sp + 1
        stages.append(("pool", "p0", "max", kp, kp, sp, sp, 0, 0, oh, ow,
                       kp * kp))
    if eltwise is not None:
        side, s_conv, s_side, relu_out = eltwise
        stages.append(("elt", "e0", int(s_conv), int(s_side),
                       bool(relu_out), oh, ow))
        sides = (side,)
    return fused_chain(x, (w,), (b,), sides, chain=tuple(stages), oh=oh,
                       ow=ow, oc=oc)
