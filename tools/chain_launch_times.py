"""Device time of each chain launch of a CNN plan on the card, at a batch.

    python3 tools/chain_launch_times.py [--model vgg16] [--target ZU2]
                                        [--batch 64] [--sweep K]
                                        [--reps 10] [--out FILE]

Builds the model at 224 (YOLO-lite at 256), plans it under ``hw.ZU2`` or
``hw.ZU9``, and runs each chain launch of the plan on random int8 inputs,
weights and biases (seed 0; the kernel's time does not depend on the
values) through ``ops.fused_chain`` with weights packed once, as the
executor runs it.  Each launch is timed with CUDA events around each of
``--reps`` launches after two warm-up launches; the line of a launch gives
the median and least ms, the tile the card's chooser takes and, where the
tree's planner has them, the images a block takes and the weight bytes its
blocks fetch (``ops.chain_fetch``).  With ``--sweep K`` the K tilings the
planner's cost model ranks best, and its best at each count of images a
block, are timed too, each held bit-equal to the chooser's output.  The
entry points are those an earlier tree of this repository has too, so
``PYTHONPATH=DIR/src`` times that tree's kernel.
One JSON line per launch, on stdout and appended to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch

from repro_torch.cnn import build
from repro_torch.core import lower, pathsearch
from repro_torch.kernels.conv_fused import ops
from repro_torch import hw


def _operands(g, launch, n, rng, dev):
    """Input, weights, biases, packed weights and sides of one launch."""
    shape = (n,) + tuple(g.shape(launch.in_name)[1:])
    x = torch.as_tensor(rng.integers(-128, 128, shape).astype(np.int8),
                        device=dev)
    if launch.fc_reshape:
        x = x.reshape(n, 1, 1, -1)
    w, b, cin = [], [], int(x.shape[-1])
    for st in launch.stages:
        if st[0] != "conv":
            continue
        co = g.shape(st[1])[3]
        w.append(torch.as_tensor(rng.integers(
            -128, 128, (st[2], st[3], cin, co)).astype(np.int8), device=dev))
        b.append(torch.as_tensor(rng.integers(-3000, 3000, co).astype(
            np.int32), device=dev))
        cin = co
    sides = [torch.as_tensor(rng.integers(-128, 128, (n,) + tuple(
        g.shape(s)[1:])).astype(np.int8), device=dev) for s in launch.sides]
    return x, w, b, tuple(ops.pack_chain_weights(t) for t in w), sides


def _time(fn, reps):
    for _ in range(2):
        fn()
    ms = []
    for _ in range(reps):
        a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        z.record()
        z.synchronize()
        ms.append(a.elapsed_time(z))
    return statistics.median(ms), min(ms)


def _ranked(chain, oh, ow, oc, c_in, n, oc_list, k):
    """The k tilings the planner's cost model ranks best, and the best it
    ranks at each count of images a block (this tree's planner only)."""
    out = sorted((est, tile, fetch) for tile, _, _, est, _, fetch in
                 ops.chain_tile_candidates(chain, oh, ow, oc, c_in, n,
                                           oc_list))
    best = {}
    for c in out:
        best.setdefault(c[1][3], c)
    return out[:k] + [c for c in best.values() if c not in out[:k]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="vgg16")
    ap.add_argument("--target", default="ZU2")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--sweep", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = torch.device("cuda")
    g = build(args.model, img=256 if args.model == "yolo_lite" else 224)
    prog = lower.lower_strategy(
        g, pathsearch.search(g, getattr(hw, args.target)), None)
    rng = np.random.default_rng(0)
    card = torch.cuda.get_device_name(0)
    lines = []
    for i, launch in enumerate(prog.items):
        if getattr(launch, "kind", None) != "chain":
            continue
        x, w, b, packed, sides = _operands(g, launch, args.batch, rng, dev)
        oh, ow, oc, c_in, oc_list = ops.launch_geometry(
            launch, g.shape(launch.in_name), [t.shape[-1] for t in w])
        kw = dict(chain=launch.stages, oh=oh, ow=ow, oc=oc)

        def run(tile=None):
            return ops.fused_chain(x, w, b, sides, **kw, tile=tile,
                                   packed=packed)
        tile = ops.choose_chain_tile(launch.stages, oh, ow, oc, c_in,
                                     args.batch, oc_list)
        med, least = _time(run, args.reps)
        line = {"item": i, "launch": "+".join(launch.nodes), "card": card,
                "batch": args.batch, "tile": list(tile), "ms": med,
                "least_ms": least}
        if hasattr(ops, "chain_fetch"):
            line["w_fetch_bytes"] = ops.chain_fetch(
                launch.stages, oh, ow, oc, c_in, oc_list, tile, args.batch)
        if args.sweep and hasattr(ops, "chain_tile_candidates"):
            want = run()
            swept = []
            for est, t, fetch in _ranked(launch.stages, oh, ow, oc, c_in,
                                         args.batch, oc_list, args.sweep):
                if not torch.equal(run(t), want):
                    raise AssertionError(f"{launch.nodes} at {t} differs "
                                         f"from the chooser's tile {tile}")
                swept.append({"tile": list(t), "est": est,
                              "w_fetch_bytes": fetch,
                              "ms": _time(lambda: run(t), args.reps)[0]})
            line["sweep"] = swept
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
