"""One run of one cell: set-up, the measured window, the per-layer readings,
the check against the reference, the result line.

``run`` takes the cell's configuration and traffic as dictionaries and the
device to use, so a test can drive a whole run on the CPU at a small size;
``run.py`` resolves a cell's names, insists on a card and prints the line.

A per-layer metric's reader gets the :class:`Run` below.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import tempfile
import time

import torch

from portbench import cells, check, devtrace, serving, work
from portbench.reference import model

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(*a) -> None:
    print("[portbench]", *a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader may read."""
    images_per_s: float         # answers on the host in the window, a second
    records: list               # batcher observer records answered in it
    counts: dict                # executor calls, launches, fallbacks in it
    trace: dict                 # devtrace.summarize of the traced calls
    traced_batches: list        # batch size of each traced call
    launches: list              # the program's FusedLaunch items, in order
    shape: object               # name -> per-image (H, W, C), program graph
    wshape: object              # conv or fc name -> weight shape
    peak: dict | None           # work.PEAKS of this card
    model_ops: int              # int8 operations of one image
    calibrate_s: float
    compile_s: float


def _counts() -> dict:
    from repro_torch.kernels.conv_fused import ops
    from repro_torch.obs.metrics import REGISTRY

    return {"calls": REGISTRY.counter("executor.calls").value,
            "fallbacks": REGISTRY.counter("executor.fallback_launches").value,
            "chain": ops.LAUNCHES["fused_chain"],
            "horizontal": ops.LAUNCHES["fused_horizontal"]}


def _p95(values) -> float:
    """Nearest-rank 95th percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def run(cfg: dict, traffic: dict, metrics: tuple, seed: int,
        seconds: float, trace: bool, dev, t_start: float) -> dict:
    """One run; returns the result line's object.  ``metrics`` holds the
    cell's end-to-end and per-layer metric entries; the first are reported
    without ``trace``, the second with it."""
    end_to_end, per_layer = metrics
    dev = torch.device(dev)
    layers = cells.reference(cfg["reference"]).layers(
        cfg["img"], cfg["num_classes"], cfg["in_channels"])
    t_run = time.monotonic()
    inputs = serving.make_inputs(layers, traffic["pool"], cfg["model_seed"],
                                 seed, dev)
    t_inputs = time.monotonic()
    records: list = []
    sut = serving.Served(cfg, traffic, inputs, dev,
                         observers=[records.append] if trace else None)
    log(f"set-up: start to run {t_run - t_start:.3f} s, inputs "
        f"{t_inputs - t_run:.3f} s, calibrate {sut.calibrate_s:.3f} s, plan "
        f"{sut.plan_s:.3f} s, compile {sut.compile_s:.3f} s, server warm-up "
        f"{sut.warmup_s:.3f} s, to here {time.monotonic() - t_start:.3f} s")
    pool_host = inputs.pool.cpu().numpy()
    f_img = inputs.f_img
    del inputs                       # the reference draws the model again
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    marks: list = []
    want_mark = [False]
    prof = devtrace.Profiled(traffic["profile_batches"], dev) if trace \
        else None

    def hook(x):
        if want_mark[0]:
            marks.append(_counts())
            want_mark[0] = False
        if prof is not None:
            prof.hook(x)

    at = []
    if trace:
        if dev.type == "cuda":
            devtrace.warm_profiler(dev)
        sut.session.set_launch_hook(hook)
        at = [(0.0, lambda: want_mark.__setitem__(0, True)),
              (traffic["profile_after"] * seconds, prof.arm)]
    load = cells.load(traffic["loop"])(
        sut.server, sut.output,
        [pool_host[i] for i in range(len(pool_host))], traffic)
    res = load.run(traffic["warm_seconds"], seconds, at=at, service=prof)
    setup_s = res.t_open - t_start
    log(f"batches over the whole load: "
        f"{sut.server.stats()['batch_histogram']}")
    fifths = [0] * 5
    for t, n in res.completions:
        fifths[min(4, int(5 * (t - res.t_open) / seconds))] += n
    log(f"images/s in each fifth of the window: "
        f"{[round(5 * n / seconds, 1) for n in fifths]}")
    if trace:
        prof.finish()
    sut.server.close(timeout_s=10.0)
    if trace:
        sut.session.set_launch_hook(None)
    peak_bytes = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                  else 0)
    answered = len(res.latencies)
    unanswered = len(res.failed) + res.missing
    log(f"window: {answered} answered in {seconds} s, {len(res.failed)} "
        f"failed, {res.missing} never answered, "
        f"{sum(len(ks) for ks, _ in res.answers)} answers in all")

    metrics = {}
    breakdown = None
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak_bytes)}
    if not answered:
        raise RuntimeError("no request was answered inside the window")
    images_per_s = answered / seconds
    if not trace:
        value = {"images_per_s": images_per_s,
                 "latency_p95_ms": 1e3 * _p95(res.latencies),
                 "setup_s": setup_s}
        metrics = {m["name"]: {"value": value[m["name"]], "unit": m["unit"]}
                   for m in end_to_end}
    else:
        summary = {}
        if prof.complete:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                prof.prof.export_chrome_trace(path)
                summary = devtrace.summarize(path, prof)
        else:
            log(f"trace: {len(prof.batches)} of {prof.n_calls} calls traced "
                f"before the window closed; no device reading")
        end = _counts()
        counts = ({k: end[k] - marks[0][k] for k in end} if marks else {})
        t_open, t_close = res.t_open, res.t_close
        window_recs = [r for r in records if r["status"] == "ok"
                       and t_open <= r["submit_s"] + r["latency_s"] < t_close]
        wshapes = {n: w for n, w, _ in model.param_shapes(layers)}
        ctx = Run(images_per_s=images_per_s, records=window_recs,
                  counts=counts, trace=summary,
                  traced_batches=list(prof.batches) if summary else [],
                  launches=sut.session.program.launches(), shape=sut.shape,
                  wshape=wshapes.__getitem__,
                  peak=work.PEAKS.get(device["kind"]),
                  model_ops=work.model_ops(layers),
                  calibrate_s=sut.calibrate_s, compile_s=sut.compile_s)
        for m in per_layer:
            v = cells.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if summary:
            device["busy_s"] = summary["busy_s"]
            device["window_s"] = summary["window_s"]
            breakdown = {"device_ops": summary["device_ops"],
                         "idle_gaps": summary["idle_gaps"]}
            log(f"trace: {json.dumps(summary)}")
        log(f"counts over the window: {counts}")

    del sut, load
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    inputs = serving.make_inputs(layers, traffic["pool"], cfg["model_seed"],
                                 seed, dev)
    if inputs.f_img != f_img:
        raise RuntimeError("the seed drew another model the second time")
    want, ref = check.reference_answers(
        layers, inputs.weights(), inputs.calib,
        torch.from_numpy(pool_host).to(dev), f_img)
    log(f"reference: logits' fraction {ref.f[layers[-1][2][0]]}")
    numbers = check.compare(res.answers, want, unanswered)
    correct, checks = check.verdict(numbers, cfg["check"])
    log(f"reference: {time.monotonic() - t0:.3f} s for {want.shape[0]} "
        f"images")
    out = {"correct": correct, "attempted": answered + unanswered,
           "failed": unanswered, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    return out
