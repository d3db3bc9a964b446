"""Serving quickstart on the PyTorch/CUDA port: compile a CNN once, serve it
with dynamic batching.

    PYTHONPATH=src python examples/serve_cnn_torch.py --model vgg16 --img 32
    PYTHONPATH=src python examples/serve_cnn_torch.py --model resnet50 --requests 16
    PYTHONPATH=src python examples/serve_cnn_torch.py --model googlenet --img 64
    PYTHONPATH=src python examples/serve_cnn_torch.py --model vgg16 --img 224 --target ZU9

The port's counterpart of ``examples/serve_cnn.py`` (``repro_torch`` only,
no JAX): calibrate -> path-search under the planning target (ZU2 or ZU9)
-> compile through the plan cache -> open a ``Session`` -> submit requests
to the dynamic-batching ``Server`` -> print throughput, latency
percentiles, the batch histogram, the kernel launches per image and the
time-wheel engine schedule (in the planning target's simulated cycles).  A
second ``Session`` construction shows the plan-cache hit.  It runs on the
card (``--device cuda``, the default), where the fused backend launches the
chain and horizontal kernels; ``--device cpu`` takes their plain versions.
"""
from __future__ import annotations

import argparse
import time
from functools import partial

import numpy as np

MODELS = ["vgg16", "resnet50", "resnet152", "googlenet", "yolo_lite"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="vgg16", choices=MODELS)
    ap.add_argument("--img", type=int, default=32)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-latency-ms", type=float, default=20.0)
    ap.add_argument("--backend", default="fused", choices=["ref", "fused"])
    ap.add_argument("--target", default="ZU2", choices=["ZU2", "ZU9"],
                    help="the FPGA the plan is searched for")
    ap.add_argument("--device", default="cuda",
                    help="where the executor runs (cuda or cpu)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import hw
    from repro_torch.cnn import build, init_params
    from repro_torch.core import executor, partition, pathsearch, quantize
    from repro_torch.kernels.conv_fused import ops
    from repro_torch.runtime import Session

    dev = torch.device(args.device)
    target = getattr(hw, args.target)
    print(f"== compile {args.model}@{args.img} for {args.target} on {dev} ==")
    g = (build(args.model, img=args.img) if args.model == "yolo_lite"
         else build(args.model, img=args.img, num_classes=10))
    params = init_params(g)
    rng = np.random.default_rng(0)
    calib = rng.standard_normal(g.shape("data")).astype(np.float32)
    qm = quantize.calibrate(g, params, calib,
                            partial(executor.run_float, device=dev))
    dv = partition.device_of(g, "paper")
    strategy = pathsearch.search(g, target, device_of=dv)

    t0 = time.perf_counter()
    sess = Session(g, strategy, target, qm, backend=args.backend, device=dev)
    print(f"session (cold compile): {time.perf_counter() - t0:.2f}s, "
          f"fused coverage {sess.artifact.fused_coverage:.2f}, "
          f"peak DDR {sess.artifact.peak_ddr_bytes / 1e6:.2f} MB")
    t0 = time.perf_counter()
    Session(g, strategy, target, qm, backend=args.backend, device=dev)
    print(f"session (plan-cache hit): {time.perf_counter() - t0:.3f}s")

    print(f"== serve {args.requests} requests "
          f"(max_batch={args.max_batch}, "
          f"max_latency={args.max_latency_ms}ms) ==")
    reqs = [quantize.quantize_to(
        rng.standard_normal((1,) + tuple(g.shape("data")[1:])).astype(
            np.float32), qm.f_a["data"]) for _ in range(args.requests)]
    ops.reset_counts()
    sess.run(reqs[0])
    per_image = dict(ops.LAUNCHES if dev.type == "cuda" else ops.PLAIN_CALLS)
    with sess.serve(max_batch=args.max_batch,
                    max_latency_s=args.max_latency_ms * 1e-3) as server:
        t0 = time.perf_counter()
        futs = [server.submit(x) for x in reqs]
        outs = [f.result(timeout=600) for f in futs]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        stats = server.stats()
    top = sess.outputs[-1]
    print(f"served {len(outs)} requests in {wall:.2f}s "
          f"({len(outs) / wall:.2f} img/s)")
    print(f"latency p50={stats['p50_ms']:.1f}ms p99={stats['p99_ms']:.1f}ms, "
          f"batches {stats['batch_histogram']} "
          f"(mean {stats['mean_batch']:.1f})")
    kind = "kernel launches" if dev.type == "cuda" else "plain calls"
    print(f"{kind} per image: {per_image} (plan: "
          f"{sess.program.meta['n_launches']} launches, "
          f"{sess.program.meta['n_fallbacks']} fallbacks)")
    print(f"output {top!r} of request 0: "
          f"{outs[0][top].cpu().numpy().ravel()[:4]} ...")

    print("== engine-level schedule (time wheel) ==")
    rep = sess.pipeline_report(min(args.requests, 8), ddr_slots=4)
    util = ", ".join(f"{e}={u:.0%}" for e, u in rep.utilization().items())
    print(f"modeled cross-request speedup {rep.modeled_speedup:.3f}x "
          f"(overlap {rep.overlap:.1%}), bottleneck {rep.bottleneck}")
    print(f"per-engine utilization: {util}")
    lat = rep.request_latency_cycles()
    print(f"request latency (cycles): first {lat[0]}, steady-state ~{lat[-1]}")
    # the software pipeline: request 1's LOADs issued while request 0's
    # CONVs were still running
    conv0 = [w for w in rep.engine_timeline["CONV"] if w[3].startswith("r0:")]
    load1 = [w for w in rep.engine_timeline["DDR_RD"]
             if w[3].startswith("r1:")]
    overlapped = [w for w in load1
                  if any(w[0] < c[1] and c[0] < w[1] for c in conv0)]
    print(f"LOAD(r1) windows overlapping CONV(r0): "
          f"{len(overlapped)}/{len(load1)}, e.g. "
          + "; ".join(f"{t}@[{s},{e})" for s, e, _, t in overlapped[:2]))
    return {"outputs": outs, "stats": stats, "per_image": per_image,
            "session": sess, "wall_s": wall}


if __name__ == "__main__":
    main()
