"""The system under test, set up from a configuration, and the load that
drives it.

``make_inputs`` draws everything on the device, in a few large calls.  The
model, from the configuration's ``model_seed``: every conv and fc layer's
float weights and biases (normal, the weights at He's sqrt(2 / fan in), so
that the signal keeps its scale through the ReLU layers and each image gets
answers of its own, and the biases at 0.05), and the calibration image.  A
deployment serves one model calibrated once, and the model decides the
work: its fractions decide how many of a concat's inputs the port rescales,
which moved GoogLeNet's rate by a fifth from one set of weights to another.
The requests, from the run's seed: the pool of images, quantized at the
calibration image's input fraction and copied to the host, as a client
holds its images.  So every seed serves the same work on other images.

``Served`` is the program's own path: ``cnn.build`` → ``quantize.calibrate``
on the card → ``pathsearch.search`` under the configuration's plan target →
``runtime.Session`` (a plan-cache miss) → ``Session.serve``, whose warm-up
runs the server's allowed batch sizes.

A load generator, ``loads/<loop>.py``, drives ``Served.server`` and
returns a :class:`LoadResult`.
"""
from __future__ import annotations

import dataclasses
import math
import time

import torch

from portbench.reference import int8, model

WEIGHT_STD = 2 ** 0.5     # times 1 / sqrt(fan in): He, for ReLU layers
BIAS_STD = 0.05
LATE_S = 60.0           # an answer later than this past the close never came
POLL_S = 5e-4           # the wait between polls while a trace starts or stops


def _param_layout(layers):
    """(name, weight shape, fan in, offset of the weights, of the bias)."""
    off = 0
    for name, wshape, fan_in in model.param_shapes(layers):
        n = math.prod(wshape)
        yield name, wshape, fan_in, off, off + n
        off += n + wshape[-1]


@dataclasses.dataclass
class Inputs:
    layers: list
    flat: torch.Tensor          # every weight and bias, one device tensor
    calib: torch.Tensor         # (1, H, W, C) float32, device
    pool: torch.Tensor          # (P, H, W, C) int8, device
    f_img: int                  # the fraction the pool is quantized at

    def weights(self) -> dict:
        """name -> (w, b): views of ``flat`` on the device."""
        return {name: (self.flat[ow:ob].view(wshape),
                       self.flat[ob:ob + wshape[-1]])
                for name, wshape, _, ow, ob in _param_layout(self.layers)}

    def program_params(self) -> dict:
        """The same weights as the program takes them: numpy on the host."""
        host = self.flat.cpu().numpy()
        return {name: {"w": host[ow:ob].reshape(wshape),
                       "b": host[ob:ob + wshape[-1]]}
                for name, wshape, _, ow, ob in _param_layout(self.layers)}


def make_inputs(layers, pool_size: int, model_seed: int, seed: int,
                dev) -> Inputs:
    """The model (weights, biases and calibration image) from
    ``model_seed``, the request pool from ``seed``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(model_seed)
    layout = list(_param_layout(layers))
    total = sum(math.prod(w) + w[-1] for _, w, _, _, _ in layout)
    flat = torch.randn(total, generator=gen, device=dev)
    for _, wshape, fan_in, ow, ob in layout:
        flat[ow:ob].mul_(WEIGHT_STD / math.sqrt(fan_in))
        flat[ob:ob + wshape[-1]].mul_(BIAS_STD)
    shape = tuple(layers[0][3]["shape"])
    calib = torch.randn((1,) + shape, generator=gen, device=dev)
    gen.manual_seed(seed)
    imgs = torch.randn((pool_size,) + shape, generator=gen, device=dev)
    f_img = int8.best_fraction(calib)
    pool = int8.quantize(imgs, f_img, 8).to(torch.int8)
    return Inputs(layers, flat, calib, pool, f_img)


class Served:
    """The configuration compiled and served by the program."""

    def __init__(self, cfg: dict, traffic: dict, inputs: Inputs, dev,
                 observers=None):
        from functools import partial

        from repro_torch import hw
        from repro_torch.cnn import build
        from repro_torch.core import pathsearch, quantize
        from repro_torch.core.executor import run_float
        from repro_torch.runtime import Session

        self.graph = build(cfg["model"], img=cfg["img"],
                           num_classes=cfg["num_classes"])
        params = inputs.program_params()
        t0 = time.monotonic()
        qm = quantize.calibrate(self.graph, params, inputs.calib.cpu().numpy(),
                                partial(run_float, device=dev))
        self.calibrate_s = time.monotonic() - t0
        del params
        plan_dev = getattr(hw, cfg["plan_target"])
        t0 = time.monotonic()
        strategy = pathsearch.search(self.graph, plan_dev)
        self.plan_s = time.monotonic() - t0
        t0 = time.monotonic()
        self.session = Session(self.graph, strategy, plan_dev, qm, device=dev)
        self.compile_s = time.monotonic() - t0
        t0 = time.monotonic()
        self.server = self.session.serve(
            max_batch=traffic["max_batch"],
            max_latency_s=traffic["max_latency_s"], observers=observers)
        self.warmup_s = time.monotonic() - t0
        (self.output,) = self.session.outputs

    def shape(self, name: str) -> tuple:
        """Per-image (H, W, C) of a tensor of the program's graph."""
        return tuple(self.graph.shape(name)[1:])


@dataclasses.dataclass
class LoadResult:
    t_open: float
    t_close: float
    latencies: list             # seconds, each request answered in the window
    answers: list               # (pool indices, host tensor (n, ...)) per
                                # group of answers, every answer
    failed: list                # (pool index, error), requests that raised
    missing: int                # requests never answered
    completions: list           # (time, answers) of each group in the window


def to_host(outs: list):
    """The answers on the host, in one copy where they stack (answers of
    one size), else one each; returns a function from the answers' pool
    indices to the (indices, host tensor) pieces kept for the check."""
    try:
        host = [torch.cat(outs).cpu()] if outs else []
    except RuntimeError:
        host = [a.cpu() for a in outs]

    def pieces(ks):
        ks = list(ks)
        if len(host) == 1:
            return [(ks, host[0])]
        return [([k], a) for k, a in zip(ks, host)]
    return pieces
