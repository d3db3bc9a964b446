"""Paired before/after measurement of the PyTorch/CUDA port on one card.

    python3 tools/port_ab.py --parent DIR [--turns 4] [--only GROUPS]
                             [--out FILE]

DIR holds an unpacked copy of an earlier commit of this repository (for
example ``git archive <commit> | tar -x -C DIR``).  The script measures the
two trees in turns (parent, this tree, this tree, parent), each turn in a
process of its own whose ``PYTHONPATH`` is that tree's ``src/`` and whose
kernels build into that tree's own build directory, so both versions run
on the same card in one call.  Each turn measures, through the entry points
both versions share (``--only`` picks groups, comma-separated, by the names
in brackets; all by default):

- [flash] ``flash_attention`` at Granite-8B's prefill shape (bf16, B=4, S=2048, 32
  heads on 8 kv heads, d=128): device ms per call (CUDA events, the stream
  held by a sleep kernel while the calls are queued);
- [conv] ``fused_horizontal`` and ``fused_chain``: device ms per
  GoogLeNet-224 image at batch 1, summed over its nine horizontal and 42
  chain launches (``run_launch`` with the executor's prepared operands);
- [scan] ``ssm_scan`` (bf16) at xLSTM-1.3B's prefill shape (B=4, S=2048, 4
  heads, K=V=1024) and Zamba2-1.2B's (32 heads, K=64, V=128, q and k
  broadcast over the heads): device ms per call;
- [recurrent] xLSTM-1.3B and Zamba2-1.2B at full width and depth (random
  bf16 weights from seed 0): the 4x2048 prefill, wall ms and tokens/s of
  each of 3 timed calls after a warm-up;
- [granite] Granite-8B at full width (36 layers, random bf16 weights from seed 0):
  the 4x2048 flash prefill, wall ms and tokens/s of each of 3 timed calls
  after a warm-up, and flash's share of the device time of one profiled
  call (``torch.profiler``);
- [session] GoogLeNet-224 (random weights from seed 0, calibrated on the
  card, planned under ZU2): ``Session.run`` p50 and p99 over 64 single-image
  calls, and a ``Server(max_batch=8)`` answering 16 requests submitted at
  once, images/s of each of 3 rounds.

Each turn prints one JSON line; the last line is a summary with every
metric per tree (the turns' values in order).  The card's name and power
limit (``nvidia-smi``) lead the output.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRANITE_PREFILL = (4, 2048, 2048, 32, 8, 128)
# (b, s, h, k, v, q and k broadcast over the heads) of the scan timings
SCAN_SHAPES = {"xlstm-1.3b": (4, 2048, 4, 1024, 1024, False),
               "zamba2-1.2b": (4, 2048, 32, 64, 128, True)}
GROUPS = ("flash", "conv", "scan", "recurrent", "session", "granite")
SEED = 0


def device_ms(fn, reps: int = 20) -> float:
    import torch

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


def kernel_share(fn, needle: str) -> dict:
    """Device ms of the kernels of one call of ``fn`` and the share of it in
    kernels whose name contains ``needle`` (a torch.profiler trace)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    events = events.get("traceEvents", events)
    total = part = 0.0
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            total += e["dur"]
            if needle in e["name"]:
                part += e["dur"]
    return {"kernel_ms": total / 1e3, f"{needle}_ms": part / 1e3,
            f"{needle}_share": part / total if total else None}


def timed_prefill(prefill, params, tokens) -> list:
    """Wall seconds of 3 prefill calls after a warm-up, each ended by a
    synchronize."""
    import torch

    prefill(params, {"tokens": tokens})                      # warm-up
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def worker(groups) -> dict:
    import dataclasses
    from functools import partial

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.cnn import build, init_params
    from repro_torch.core import lower, pathsearch, quantize
    from repro_torch.core.executor import run_float
    from repro_torch.hw import ZU2
    from repro_torch.kernels.conv_fused import ops as conv
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.ssm_scan import ops as scan
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.runtime import Session

    dev = torch.device("cuda")
    res = {}
    b, s, sk, h, kv, d = GRANITE_PREFILL
    if "flash" in groups:
        gen = torch.Generator(device=dev).manual_seed(SEED)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16) for shape in ((b, s, h, d), (b, sk, kv, d),
                                          (b, sk, kv, d)))
        res["flash_ms"] = device_ms(lambda: flash.flash_attention(q, k, v))
        del q, k, v

    if "scan" in groups:
        for arch, (sb, ss, sh, dk, dv, bcast) in SCAN_SHAPES.items():
            gen = torch.Generator(device=dev).manual_seed(SEED)
            hq = 1 if bcast else sh
            q, k = ((torch.randn((sb, ss, hq, dk), generator=gen, device=dev)
                     / dk ** 0.5).to(torch.bfloat16).expand(sb, ss, sh, dk)
                    for _ in range(2))
            v = torch.randn((sb, ss, sh, dv), generator=gen,
                            device=dev).to(torch.bfloat16)
            la = torch.nn.functional.logsigmoid(
                torch.randn((sb, ss, sh), generator=gen, device=dev))
            res[f"scan_ms_{arch}"] = device_ms(
                lambda: scan.ssm_scan(q, k, v, la), reps=5)
            del q, k, v, la

    if "conv" in groups or "session" in groups:
        g = build("googlenet", img=224)
        params = init_params(g, seed=SEED)
        x = np.random.default_rng(SEED).standard_normal(
            g.shape("data")).astype(np.float32)
        qm = quantize.calibrate(g, params, x, partial(run_float, device=dev))
        strategy = pathsearch.search(g, ZU2)
        prog = lower.lower_strategy(g, strategy, qm)
    if "conv" in groups:
        rng = torch.Generator().manual_seed(SEED + 1)
        per_kind = {"horizontal": 0.0, "chain": 0.0}
        for launch in prog.launches():
            prep = conv.prepare_launch(launch, qm, dev)
            env = {launch.in_name: torch.randint(
                -128, 128, (1,) + tuple(g.shape(launch.in_name)[1:]),
                generator=rng, dtype=torch.int8).to(dev)}
            for side in launch.sides if launch.kind == "chain" else ():
                env[side] = torch.randint(
                    -128, 128, (1,) + tuple(g.shape(side)[1:]),
                    generator=rng, dtype=torch.int8).to(dev)
            per_kind[launch.kind] += device_ms(
                lambda: conv.run_launch(launch, env, prepared=prep))
        res["horizontal_ms_per_image"] = per_kind["horizontal"]
        res["chain_ms_per_image"] = per_kind["chain"]
    if "session" in groups:
        sess = Session(g, strategy, ZU2, qm, device=dev)
        nrng = np.random.default_rng(SEED + 2)
        imgs = [quantize.quantize_to(
            nrng.standard_normal(g.shape("data")[1:]), qm.f_a["data"])
            for _ in range(16)]
        for x in imgs[:4]:
            sess.run(x)
        lat = []
        for i in range(64):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess.run(imgs[i % 16])
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        lat.sort()
        res["run_p50_ms"] = 1e3 * lat[len(lat) // 2]
        res["run_p99_ms"] = 1e3 * lat[min(len(lat) - 1,
                                          int(0.99 * len(lat)))]
        ips = []
        for _ in range(3):
            server = sess.serve(max_batch=8, max_latency_s=5e-3)
            t0 = time.perf_counter()
            futs = [server.submit(x) for x in imgs]
            for f in futs:
                f.result(timeout=300)
            torch.cuda.synchronize()
            ips.append(16 / (time.perf_counter() - t0))
            server.close()
        res["server_images_per_s"] = ips
        del sess
        torch.cuda.empty_cache()

    with torch.inference_mode():
        if "recurrent" in groups:
            for arch in ("xlstm-1.3b", "zamba2-1.2b"):
                cfg = configs.get(arch)
                lm = api.init_params(cfg, torch.Generator(
                    device=dev).manual_seed(SEED), dev)
                tokens = torch.as_tensor(np.random.default_rng(
                    SEED).integers(0, cfg.vocab, (b, s)), device=dev)
                walls = timed_prefill(serve.make_prefill_step(cfg), lm,
                                      tokens)
                res[f"prefill_ms_{arch}"] = [1e3 * w for w in walls]
                res[f"prefill_tokens_per_s_{arch}"] = [b * s / w
                                                       for w in walls]
                del lm
                torch.cuda.empty_cache()
        if "granite" in groups:
            cfg = dataclasses.replace(configs.get("granite-8b"),
                                      attn_impl="flash")
            lm = api.init_params(cfg, torch.Generator(
                device=dev).manual_seed(SEED), dev)
            tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
                0, cfg.vocab, (b, s)), device=dev)
            prefill = serve.make_prefill_step(cfg)
            walls = timed_prefill(prefill, lm, tokens)
            res["prefill_ms"] = [1e3 * w for w in walls]
            res["prefill_tokens_per_s"] = [b * s / w for w in walls]
            res["prefill_profile"] = kernel_share(
                lambda: prefill(lm, {"tokens": tokens}), "flash")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="unpacked earlier tree")
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--only", default=",".join(GROUPS),
                    help=f"groups to measure, of {', '.join(GROUPS)}")
    ap.add_argument("--out", help="also write the summary JSON here")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    groups = set(args.only.split(","))
    if groups - set(GROUPS):
        print(f"port_ab: unknown groups {sorted(groups - set(GROUPS))}",
              file=sys.stderr)
        return 1
    if args.worker:
        print(json.dumps(worker(groups)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or not args.parent:
        print("port_ab: needs a CUDA card and --parent", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    trees = {"parent": os.path.abspath(args.parent), "this": ROOT}
    order = (["parent", "this", "this", "parent"] * args.turns)[:args.turns]
    summary: dict = {"card": card, "order": order}
    for name in order:
        tree = trees[name]
        env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"),
                   REPRO_TORCH_BUILD_DIR=os.path.join(tree, "build",
                                                      "repro_torch"))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--worker", "--only", args.only], env=env,
                              cwd=tree,
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": name, "seconds": time.perf_counter() - t0,
                          **res}), flush=True)
        for key, val in res.items():
            summary.setdefault(key, {}).setdefault(name, []).append(val)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
