"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the build of the conv_fused kernels from ``src/repro_torch`` with
   nvcc (``sm_90a``).
2. Kernels against their plain PyTorch versions on the card, int8 bit
   equality: ``fused_chain`` on every distinct chain launch of GoogLeNet-224
   and ResNet50-224 (strategies from ``pathsearch.search(g, ZU2)``, weights
   calibrated on the card), a tile sweep with ragged tiles, hand-built
   chains (avg and ceil-mode pools, negative shifts, dilation, global
   pooling); ``fused_horizontal`` on all GoogLeNet-224 horizontal launches.
   Each kernel is timed with CUDA events at the main path's shapes beside
   its plain version (and, for the horizontal 1x1 launches, ``torch._int_mm``
   at the same M, K, N as a yardstick the port never calls).
3. The slice: GoogLeNet at 224x224x3, 1000 classes, random weights from a
   seed, calibrated with the port's float executor on the card, planned
   under ZU2, served by ``Session(device="cuda")``: ``validate.bit_exact``
   (fused against ref), launch counts per image, and a ``Server`` answering
   16 requests bit-equal to ``Session.run``.

The second-to-last lines are the kernels' JSON record and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "smoke_out")   # per-launch times, profiler trace
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 0
IMG = 224
MEM_BW = 3.35e12          # H100 SXM HBM3 bytes/s (data sheet)
INT8_PEAK = 1979e12       # H100 SXM dense int8 tensor-core OP/s (data sheet)


def log(*a) -> None:
    print(*a, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call of ``fn``: a sleep kernel holds the
    stream while the host enqueues ``reps`` calls between two CUDA events,
    so host overhead between launches is not counted."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((reps * host_s * 2 + 2e-3) * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ----------------------------------------------------------------- models
def prepare_model(name: str, dev):
    """Graph, float params, calibrated QuantizedModel, strategy and
    quantized program of one model at 224."""
    from functools import partial

    from repro_torch.cnn import build, init_params
    from repro_torch.core import lower, pathsearch, quantize
    from repro_torch.core.executor import run_float
    from repro_torch.hw import ZU2

    g = build(name, img=IMG)
    params = init_params(g, seed=SEED)
    x = np.random.default_rng(SEED).standard_normal(
        g.shape("data")).astype(np.float32)
    qm = quantize.calibrate(g, params, x, partial(run_float, device=dev))
    strategy = pathsearch.search(g, ZU2)
    prog = lower.lower_strategy(g, strategy, qm)
    return {"g": g, "params": params, "x": x, "qm": qm,
            "strategy": strategy, "program": prog}


def rand_int8(shape, gen, dev):
    return torch.randint(-128, 128, tuple(shape), generator=gen,
                         dtype=torch.int8, device="cpu").to(dev)


def chain_args(launch, g, prep, gen, dev, n=1):
    x = rand_int8((n,) + tuple(g.shape(launch.in_name)[1:]), gen, dev)
    if launch.fc_reshape:
        x = x.reshape(n, 1, 1, -1)
    sides = tuple(rand_int8((n,) + tuple(g.shape(s)[1:]), gen, dev)
                  for s in launch.sides)
    w = prep["weights"]
    oc = int(w[-1].shape[-1]) if w else int(x.shape[-1])
    oh, ow = launch.out_hw
    return (x, w, prep["biases"], sides), dict(chain=launch.stages, oh=oh,
                                               ow=ow, oc=oc)


def chain_work(launch, args, kw) -> tuple[int, int]:
    """(bytes a chain launch must move, its MACs): each input, weight,
    bias and side read once, the output written once."""
    x, w, b, sides = args
    n = x.shape[0]
    nbytes = (x.numel() + sum(t.numel() for t in w) + 4 * sum(
        t.numel() for t in b) + sum(s.numel() for s in sides)
        + n * kw["oh"] * kw["ow"] * kw["oc"])
    convs = [st for st in launch.stages if st[0] == "conv"]
    macs = sum(n * st[12] * st[13] * t.numel() for st, t in zip(convs, w))
    return nbytes, macs


def check_equal(got, want, what: str) -> int:
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        diff = float((got.double() - want.double()).abs().max())
        raise AssertionError(f"{what}: {bad} values differ, max |diff| "
                             f"{diff}")


# ----------------------------------------------------------------- phase 2
def hand_chains(gen, dev):
    """Chains the two models do not produce: avg and ceil-mode pools,
    negative shifts, an elt side with its own shift, dilation, gap."""
    c1 = (("conv", "c", 3, 3, 1, 1, 1, 1, 1, 1, -2, True, 13, 11),
          ("pool", "a", "avg", 3, 3, 2, 2, 1, 1, 7, 6, 9),
          ("elt", "e", 1, -1, True, 7, 6),
          ("pool", "m", "max", 2, 2, 2, 2, 0, 0, 4, 3, 4))
    c2 = (("conv", "c", 3, 3, 2, 1, 2, 1, 2, 1, 5, False, 7, 11),
          ("pool", "g", "gap", 7, 11, 1, 1, 0, 0, 1, 1, 77))
    c3 = (("pool", "m", "max", 3, 3, 2, 2, 0, 0, 6, 5, 9),
          ("pool", "a", "avg", 2, 2, 2, 2, 0, 0, 3, 3, 4))
    x = rand_int8((2, 13, 11, 8), gen, dev)
    out = []
    for chain, w_shape, side_shape, oh, ow, oc in (
            (c1, (3, 3, 8, 16), (2, 7, 6, 16), 4, 3, 16),
            (c2, (3, 3, 8, 12), None, 1, 1, 12),
            (c3, None, None, 3, 3, 8)):
        w = (rand_int8(w_shape, gen, dev),) if w_shape else ()
        b = (torch.randint(-3000, 3000, (w_shape[-1],), generator=gen,
                           dtype=torch.int32).to(dev),) if w_shape else ()
        sides = (rand_int8(side_shape, gen, dev),) if side_shape else ()
        out.append(((x, w, b, sides), dict(chain=chain, oh=oh, ow=ow, oc=oc)))
    return out


def kernel_phase(models, dev) -> dict:
    from repro_torch.kernels.conv_fused import ops

    gen = torch.Generator().manual_seed(SEED)
    n_chain = n_tiles = n_hand = n_horiz = 0
    for name, m in models.items():
        g, qm, prog = m["g"], m["qm"], m["program"]
        seen = set()
        for launch in prog.launches():
            if launch.kind != "chain":
                continue
            key = (launch.stages, tuple(g.shape(launch.in_name)))
            if key in seen:
                continue
            seen.add(key)
            prep = ops.prepare_launch(launch, qm, dev)
            args, kw = chain_args(launch, g, prep, gen, dev, n=2)
            want = ops.fused_chain_plain(*args, **kw)
            check_equal(ops.fused_chain(*args, **kw), want,
                        f"{name} chain {launch.nodes}")
            n_chain += 1
        log(f"fused_chain == plain on {len(seen)} distinct {name}-224 "
            f"chain launches")
    # tile sweep: ragged and odd tiles on each model's two longest chains
    # and its first pool-only chain
    sweep = []
    for name, m in models.items():
        chains = [lc for lc in m["program"].launches() if lc.kind == "chain"]
        picks = sorted(chains, key=lambda lc: -len(lc.stages))[:2]
        picks += [lc for lc in chains
                  if all(st[0] == "pool" for st in lc.stages)][:1]
        sweep += [(name, lc, m) for lc in picks]
    for name, launch, m in sweep:
        prep = ops.prepare_launch(launch, m["qm"], dev)
        args, kw = chain_args(launch, m["g"], prep, gen, dev, n=2)
        want = ops.fused_chain_plain(*args, **kw)
        oc = kw["oc"]
        for tile in ((3, 5, oc), (1, 1, oc), (5, 3, oc // 2 if oc % 2 == 0
                                               else oc), (7, 9, oc)):
            check_equal(ops.fused_chain(*args, **kw, tile=tile), want,
                        f"{name} chain {launch.nodes} tile {tile}")
            n_tiles += 1
    log(f"fused_chain == plain on {n_tiles} forced tiles (ragged included)")
    for args, kw in hand_chains(gen, dev):
        want = ops.fused_chain_plain(*args, **kw)
        for tile in (None, (1, 1, kw["oc"]), (3, 2, kw["oc"] // 2)):
            check_equal(ops.fused_chain(*args, **kw, tile=tile), want,
                        f"hand chain {[st[0] for st in kw['chain']]} {tile}")
            n_hand += 1
    log(f"fused_chain == plain on {n_hand} hand-built chain runs")
    m = models["googlenet"]
    for launch in m["program"].launches():
        if launch.kind != "horizontal":
            continue
        prep = ops.prepare_launch(launch, m["qm"], dev)
        for n in (2, 8):   # 32x32 and 64x64 output tiles
            x = rand_int8((n,) + tuple(m["g"].shape(launch.in_name)[1:]),
                          gen, dev)
            a = (x, prep["w"], prep["b"], prep["shift"], prep["relu"])
            kw = dict(stride=tuple(launch.stride), pad=tuple(launch.pad))
            check_equal(ops.fused_horizontal(*a, **kw),
                        ops.fused_horizontal_plain(*a, **kw),
                        f"horizontal {launch.nodes} batch {n}")
        n_horiz += 1
    log(f"fused_horizontal == plain on {n_horiz} GoogLeNet-224 launches at "
        f"batch 2 and 8")
    return {"chain_launches": n_chain, "tiles": n_tiles, "hand": n_hand,
            "horizontal_launches": n_horiz}


def timing_phase(m, dev) -> dict:
    """Per-kernel device time summed over one GoogLeNet-224 image's
    launches (batch 1), beside the plain versions and the bound."""
    from repro_torch.kernels.conv_fused import ops

    gen = torch.Generator().manual_seed(SEED + 1)
    rec = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "bound_bytes_ms": 0.0, "bound_ops_ms": 0.0, "library_ms": None,
               "n": 0, "max_abs_err": 0}
           for k in ("fused_chain", "fused_horizontal")}
    lib_ms = 0.0
    rows = []
    for launch in m["program"].launches():
        prep = ops.prepare_launch(launch, m["qm"], dev)
        if launch.kind == "chain":
            args, kw = chain_args(launch, m["g"], prep, gen, dev)
            r = rec["fused_chain"]
            k_ms = device_ms(lambda: ops.fused_chain(*args, **kw))
            p_ms = device_ms(lambda: ops.fused_chain_plain(*args, **kw))
            err = (ops.fused_chain(*args, **kw).to(torch.int32)
                   - ops.fused_chain_plain(*args, **kw).to(torch.int32))
            nbytes, macs = chain_work(launch, args, kw)
        else:
            x = rand_int8((1,) + tuple(m["g"].shape(launch.in_name)[1:]),
                          gen, dev)
            a = (x, prep["w"], prep["b"], prep["shift"], prep["relu"])
            kw = dict(stride=tuple(launch.stride), pad=tuple(launch.pad))
            r = rec["fused_horizontal"]
            k_ms = device_ms(lambda: ops.fused_horizontal(*a, **kw))
            p_ms = device_ms(lambda: ops.fused_horizontal_plain(*a, **kw))
            err = (ops.fused_horizontal(*a, **kw).to(torch.int32)
                   - ops.fused_horizontal_plain(*a, **kw).to(torch.int32))
            kh, kwd, ic, oc = prep["w"].shape
            oh, ow = launch.out_hw
            mm, kk = oh * ow, kh * kwd * ic
            nbytes = x.numel() + prep["w"].numel() + 12 * oc + mm * oc
            macs = mm * kk * oc
            if kh == kwd == 1 and launch.stride == (1, 1):
                am = x.reshape(mm, kk)
                bm = prep["w"].reshape(kk, oc)
                lib_ms += device_ms(lambda: torch._int_mm(am, bm))
        t_bytes, t_ops = 1e3 * nbytes / MEM_BW, 1e3 * 2 * macs / INT8_PEAK
        b_ms = max(t_bytes, t_ops)
        r["ms"] += k_ms
        r["plain_ms"] += p_ms
        r["bound_ms"] += b_ms
        r["bound_bytes_ms"] += t_bytes
        r["bound_ops_ms"] += t_ops
        r["n"] += 1
        r["max_abs_err"] = max(r["max_abs_err"], int(err.abs().max()))
        rows.append({"kind": launch.kind, "nodes": "+".join(launch.nodes),
                     "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms})
    rec["fused_horizontal"]["library_ms"] = lib_ms
    with open(os.path.join(OUT, "chip_smoke_launches.json"), "w") as f:
        json.dump(rows, f, indent=1)
    for k, r in rec.items():
        log(f"{k}: {r['n']} launches/image, kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
            f"(bytes {r['bound_bytes_ms']:.6f}, ops {r['bound_ops_ms']:.6f})"
            f", library {r['library_ms']}")
    return rec


# ----------------------------------------------------------------- phase 3
def profile_runs(sess, imgs) -> dict:
    """Device busy share and kernel time by name over ``Session.run`` of
    each image, from a ``torch.profiler`` trace (saved in the output
    directory):
    busy = union of kernel and copy intervals over the span from the first
    device event to the last."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x in imgs:
            sess.run(x)
        torch.cuda.synchronize()
    path = os.path.join(OUT, "googlenet_run_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in
                 ("kernel", "gpu_memcpy", "gpu_memset"))
    if not dev:
        return {"device_busy_share": "not measured"}
    busy, end = 0.0, dev[0][0]
    by_name: dict = {}
    for t0, t1, name in dev:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        key = name.split("(")[0][:60]
        by_name[key] = by_name.get(key, 0.0) + (t1 - t0) / 1e3 / len(imgs)
    span = dev[-1][1] - dev[0][0]
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    return {"device_busy_share": busy / span,
            "device_span_ms_per_image": span / 1e3 / len(imgs),
            "device_ms_per_image_by_kernel": top}


def slice_phase(m, dev, card: str) -> dict:
    from repro_torch.core import quantize, validate
    from repro_torch.hw import ZU2
    from repro_torch.kernels.conv_fused import ops
    from repro_torch.runtime import Session

    g, qm, s = m["g"], m["qm"], m["strategy"]
    xq = quantize.quantize_to(m["x"], qm.f_a["data"])
    rep = validate.bit_exact(g, qm, xq, s, device=dev,
                             float_params=m["params"])
    if not rep.bit_exact:
        raise AssertionError(f"GoogLeNet-224 fused != ref on {dev}: {rep}")
    log(f"validate.bit_exact(fused vs ref) on the card: True, SQNR vs float "
        f"{rep.sqnr_db}")

    rng = np.random.default_rng(SEED + 2)
    imgs = [quantize.quantize_to(rng.standard_normal(g.shape("data")[1:]),
                                 qm.f_a["data"]) for _ in range(16)]
    ops.reset_counts()                       # ---- main path starts here
    sess = Session(g, s, ZU2, qm, device=dev)
    out = sess.run(imgs[0])
    torch.cuda.synchronize()
    per_image = dict(ops.LAUNCHES)
    plain = dict(ops.PLAIN_CALLS)
    if per_image != {"fused_chain": 42, "fused_horizontal": 9} or any(
            plain.values()):
        raise AssertionError(f"launches per image {per_image}, plain calls "
                             f"{plain}")
    prob = out["prob"]
    if tuple(prob.shape) != (1, 1, 1, 1000) or not bool(
            torch.isfinite(prob).all()):
        raise AssertionError(f"bad output {tuple(prob.shape)}")
    if abs(float(prob.sum()) - 1.0) > 1e-4:
        raise AssertionError(f"softmax sums to {float(prob.sum())}")
    server = sess.serve(max_batch=8, max_latency_s=5e-3)
    t0 = time.perf_counter()
    futs = [server.submit(x) for x in imgs]
    answers = [f.result(timeout=300) for f in futs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = server.stats()
    server.close()
    launches = dict(ops.LAUNCHES)            # ---- main path ends here
    if any(ops.PLAIN_CALLS.values()):
        raise AssertionError(f"plain calls on the main path "
                             f"{ops.PLAIN_CALLS}")
    for i, (x, ans) in enumerate(zip(imgs, answers)):
        want = sess.run(x)["prob"]
        check_equal(ans["prob"], want, f"server answer {i}")
    lat = []
    for x in imgs:
        t1 = time.perf_counter()
        sess.run(x)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t1)
    lat.sort()
    prof = profile_runs(sess, imgs[:5])
    res = {"card": card, "server_images_per_s": 16 / wall,
           "server_p50_ms": stats["p50_ms"], "server_p99_ms": stats["p99_ms"],
           "server_batches": stats["batch_histogram"],
           "run_p50_ms": 1e3 * lat[len(lat) // 2],
           "run_p99_ms": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
           "launches_per_image": per_image, "launches": launches, **prof}
    log(f"GoogLeNet-224 serving on {card}: " + json.dumps(res))
    return res


def main() -> int:
    global OUT
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT, help="directory for the per-launch "
                    "times and the profiler trace (default: smoke_out/)")
    OUT = os.path.abspath(ap.parse_args().out)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.conv_fused import build

    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda")
    card = smi()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}"
        f", {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    path, out = build.compile_library(extra_flags=["-Xptxas", "-v"])
    log(f"built {os.path.relpath(path, ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log("  ptxas:", line.strip())
    build.library()

    t0 = time.perf_counter()
    models = {name: prepare_model(name, dev)
              for name in ("googlenet", "resnet50")}
    log(f"calibrated and planned GoogLeNet-224 and ResNet50-224 on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    checked = kernel_phase(models, dev)
    timing = timing_phase(models["googlenet"], dev)
    served = slice_phase(models["googlenet"], dev, card)

    kernels = []
    for name, replaces in (
            ("fused_chain",
             "src/repro/kernels/conv_fused/conv_fused.py:246"),
            ("fused_horizontal",
             "src/repro/kernels/conv_fused/conv_fused.py:333")):
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/conv_fused/csrc/conv_fused.cu",
            "replaces": replaces, "launches": served["launches"][name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bound_bytes_ms"] >= t["bound_ops_ms"]
                         else "operations"),
            "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels, "checked": checked,
                      "card": card}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
