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
    if model == "toy":
        return make_toy_graph(pkg)
    cnn = importlib.import_module(f"{pkg}.cnn")
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


def strategy(pkg: str, g, name: str = "search"):
    pathsearch = importlib.import_module(f"{pkg}.core.pathsearch")
    ZU2 = importlib.import_module(f"{pkg}.hw").ZU2
    return getattr(pathsearch, name)(g, ZU2)


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
]


def hand_chain_args(i, rng):
    chain, (h, w, c), wshape, sshape, oc = HAND_CHAINS[i]
    x = i8(rng, (2, h, w, c))
    weights, biases = [], []
    cin = c
    for st in chain:
        if st[0] == "conv":
            shape = wshape if not weights else (st[2], st[3], cin, oc)
            weights.append(i8(rng, shape))
            biases.append(rng.integers(-3000, 3000, shape[-1]).astype(np.int32))
            cin = shape[-1]
    sides = [i8(rng, (2,) + sshape)] if sshape else []
    last = chain[-1]
    oh, ow = ((last[12], last[13]) if last[0] == "conv" else
              (last[9], last[10]) if last[0] == "pool" else (last[5], last[6]))
    return chain, x, weights, biases, sides, oh, ow, oc


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
