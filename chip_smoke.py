"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Environment: the card's name and power limit, torch and CUDA versions,
   and the build of the kernel libraries (conv_fused, flash_attention,
   ssm_scan) from ``src/repro_torch`` with nvcc (``sm_90a``), one nvcc
   each, started together.
2. Kernels against their plain PyTorch versions on the card, int8 bit
   equality: ``fused_chain`` on every distinct chain launch of GoogLeNet-224
   and ResNet50-224 (strategies from ``pathsearch.search(g, ZU2)``, weights
   calibrated on the card), a tile sweep with ragged tiles, hand-built
   chains (avg and ceil-mode pools, negative shifts, dilation, global
   pooling); ``fused_horizontal`` on all GoogLeNet-224 horizontal launches
   at batch 1 (split-K), 2 and 8, and on hand-made ragged launches (M not a
   multiple of the tile, N not a multiple of 8, K not a multiple of 32, a
   split-K case, IC = 3, 3x3 windows at stride 2 with padding).
   The chain kernel gets each launch's weights packed once
   (``prepare_launch``), as the executor passes them.  Each kernel is timed
   with CUDA events at the main path's shapes beside its plain version (and, for the horizontal 1x1 launches, ``torch._int_mm``
   at the same M, K, N as a yardstick the port never calls).
   At int32-extreme biases (within 2^20 of +-2^31) and shifts 1, 31, 32,
   33 and 40, hand-built chains (conv then elt) and horizontal launches.
3. The slice: GoogLeNet at 224x224x3, 1000 classes, random weights from a
   seed, calibrated with the port's float executor on the card, planned
   under ZU2, compiled through the plan cache (``asm.PLAN_CACHE``: a miss,
   then a hit) and served by ``Session(device="cuda")``:
   ``validate.bit_exact`` (fused against ref), launch counts per image, and
   a ``Server`` answering 16 requests bit-equal to ``Session.run``.  The
   DNNVM object file: saved, loaded and reopened by
   ``Session.from_artifact`` with no recompile, its stored program
   dispatched (42 chain + 9 horizontal launches per image, no plain call)
   and bit-equal to the compiled session on 16 images;
   ``stages.compile_model(...).session`` bit-equal too;
   ``validate.artifact_round_trip`` exact on the card for GoogLeNet-224 and
   ResNet50-224.  The host's seconds to compile, save and load, the file's
   bytes, the plan's peak DDR bytes, reuse factor, instruction count and
   simulated cycles, and the two sessions' ``Session.run`` p50 are logged.
4. Flash attention on the card: fp32 (TF32 off) against its plain PyTorch
   version at 2e-5, and bf16 against the kernel's arithmetic unfused in
   fp32 (``attention_fp32``) at two bf16 unit roundoffs of each output
   row's largest value, at Granite-8B's prefill shape (B=4, S=2048, 32
   heads on 8 kv heads, d=128), SmolLM-360M's (15 on 5, d=64), a ``q_offset`` tail and a
   non-causal call; timed with CUDA events beside the plain version, the
   bound and ``scaled_dot_product_attention`` (a yardstick the port never
   calls), with the kernel's own tensor work (6 d FLOP per kept pair: P V
   runs on both halves of P) and its share of the bf16 peak.
5. The LM slice: Granite-8B at full width (36 layers, random bf16 weights
   from seed 0) on the card: ``make_prefill_step`` with
   ``attn_impl="flash"`` on a 4x2048 prompt (36 flash launches, no plain
   call), its logits no farther from the fp32 prefill of the same weights
   than 1.25 times the ``attn_impl="xla"`` prefill's distance, then the
   ``serve`` loop (prefill-by-decode of a 4x128 prompt, 32 greedy steps);
   and a 2-layer fp32 Granite at full width holding flash
   prefill against plain prefill at 1e-4 and teacher-forced decode against
   prefill at 1e-3.
6. The chunked linear scan on the card (TF32 off), each dtype's route
   (bf16: ``scan_intra_kernel`` + ``scan_state_kernel`` on the tensor
   cores; fp32 and fp16: ``ssm_scan_kernel``) at every slab width it takes:
   fp32 against ``chunked_linear_scan`` at 2e-4 of each output row's
   largest value, bf16 and fp16 against ``scan_fp32`` (the plain version on
   inputs upcast to fp32) at two unit roundoffs of their dtype, bf16 also
   element by element (at most ``ROUND_SHARE_TOL`` of its elements differ
   from ``scan_fp32`` rounded to bf16, which a route without the hi/lo
   splits misses), at
   xLSTM-1.3B's prefill shape (B=4, S=2048, 4 heads, K=V=1024),
   Zamba2-1.2B's (32 heads, K=64, V=128, q and k broadcast over the heads
   with stride 0), a ragged S=200 and K != V; the bf16 route timed with
   CUDA events at both model shapes (at each slab width too) beside the
   plain version, the bound and the fp32 route's kernel.
7. The recurrent LM slices at full width and depth (random bf16 weights
   from seed 0): xLSTM-1.3B (48 layers, 42 scan launches per prefill) and
   Zamba2-1.2B (38 layers, 38 launches).  For each: ``make_prefill_step``
   on a 4x2048 prompt (no plain call), its logits no farther from the fp32
   prefill of the same weights (plain scan, TF32 off) than 1.25 times the
   bf16 prefill with the plain scan (swapped in by patching
   ``ops.ssm_scan`` here), every launch of a prefill held on the model's
   own inputs against ``scan_fp32`` at two bf16 unit roundoffs, the
   ``serve`` loop (prefill-by-decode of a 4x128 prompt, 32 greedy steps), a
   profile of one prefill whose trace must hold one ``scan_intra_kernel``
   and one ``scan_state_kernel`` per wrapper launch; then the model at full width and a cut depth
   (xLSTM 8 layers; Zamba2 1 layer and its shared block): in fp32 every
   launch against the plain scan at 2e-4 row-relative, kernel prefill
   against plain prefill at 1e-4 and teacher-forced decode against prefill
   at 1e-3, and the bf16 prefill's distance to fp32 held as at full depth,
   the plain scan's within a quarter of the largest |logit|.
8. The tune phase, run after phase 3 on its GoogLeNet-224: ``calibrate``
   under ZU2 through a ``MeasurementHarness`` on the card (the default
   candidate groups and stacked launches; CUDA-event device time), the
   profile saved in a ``ProfileCache`` under the output directory and
   reloaded by name with an equal hash; ``pathsearch.search`` under the
   ``CalibratedEvaluator`` beside the analytic strategy;
   ``search_tile_shapes`` under ``hw.H100`` (top 3), every measured
   candidate run through ``run_launch`` and equal to the plain version;
   three sessions of the calibrated strategy (the search's records, every
   chain forced to its fastest non-default candidate, none), each
   ``bit_exact`` with its applied records counted and no plain call, their
   ``Session.run`` p50 in turns and ``chain_kernel`` device ms per image in
   a profiled run; ``Lowered.retune`` with stage-cache counters; and
   ``pipeline_report(8, ddr_slots=None)`` in the ZU2 model's cycles.

The second-to-last lines are the kernels' JSON record and the card's
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "smoke_out")   # per-launch times, profiler trace
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 0
IMG = 224
MEM_BW = 3.35e12          # H100 SXM HBM3 bytes/s (data sheet)
INT8_PEAK = 1979e12       # H100 SXM dense int8 tensor-core OP/s (data sheet)
BF16_PEAK = 989e12        # H100 SXM dense bf16 tensor-core FLOP/s (data sheet)
FLASH_REPLACES = "src/repro/kernels/flash_attention/flash_attention.py:73"
FLASH_SOURCE = ("src/repro_torch/kernels/flash_attention/csrc/"
                "flash_attention.cu")
# (b, sq, sk, h, kv, d, q_offset, causal) of the flash checks on the card
GRANITE_PREFILL = (4, 2048, 2048, 32, 8, 128, 0, True)
FLASH_CASES = {
    "granite prefill": GRANITE_PREFILL,
    "smollm prefill": (4, 2048, 2048, 15, 5, 64, 0, True),
    "granite q_offset tail": (4, 128, 2048, 32, 8, 128, 1920, True),
    "granite non-causal": (1, 512, 512, 32, 8, 128, 0, False),
}
FP32_TOL = 2e-5            # fp32 kernel vs attention_ref, max |diff|
# hand-made horizontal launches (h, w, ic, oc, kh, kw, stride, pad) at
# batch 1 and 2: M not a multiple of the tile with N not a multiple of 8
# and K not a multiple of 32, a split-K case, IC = 3 (the byte-gather path)
# and 3x3 windows at stride 2 with padding
HORIZONTAL_RAGGED = [
    (5, 7, 48, 37, 1, 1, 1, 0), (7, 7, 832, 40, 1, 1, 1, 0),
    (9, 11, 3, 20, 3, 3, 2, 1), (9, 11, 32, 24, 3, 3, 2, 1),
    (13, 13, 24, 70, 3, 3, 2, 1)]
# round_shift where the reference's int32 arithmetic wraps: biases within
# 2^20 of -2^31 and 2^31 - 1, shifts from 1 past 32
EXTREME_SHIFTS = (1, 31, 32, 33, 40)
SCAN_REPLACES = "src/repro/kernels/ssm_scan/ssm_scan.py:49"
SCAN_SOURCE = "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu"
# (b, s, h, k, v, q and k broadcast over the heads) of the scan checks
XLSTM_SCAN = (4, 2048, 4, 1024, 1024, False)
ZAMBA_SCAN = (4, 2048, 32, 64, 128, True)
SCAN_CASES = {
    "xlstm prefill": XLSTM_SCAN,
    "zamba2 prefill": ZAMBA_SCAN,
    "ragged S=200": (4, 200, 4, 64, 96, False),
    "K != V": (2, 256, 2, 40, 24, False),
}
SCAN_FP32_TOL = 2e-4       # row-relative, the JAX package's Pallas tolerance
# the recurrent LMs' bf16 prefill logits with the kernel, against the fp32
# prefill, at most 1.25 times as far as with the plain bf16 scan
LOGITS_KERNEL_VS_PLAIN = 1.25
# The recurrent LMs' checks at full width and a cut depth (config fields):
# fp32 kernel prefill vs plain prefill at FP32_PREFILL_TOL, teacher-forced
# decode vs prefill at FP32_DECODE_TOL, and the bf16 prefill no farther
# from the fp32 one than LOGITS_KERNEL_VS_PLAIN times the plain scan's bf16
# prefill, itself within BF16_PLAIN_MAX of the largest |logit| (farther,
# the check would pass any kernel).  Zamba2 under random weights turns
# last-bit differences of its scan into about 1e-3 on the logits of 8
# layers, in the JAX reference as in the port
# (tools/jax_scan_rounding_spread.py), and its bf16 logits decorrelate from
# fp32 within a few layers, so it is checked at one Mamba2 layer followed
# by one application of its shared block.
DEPTH_CHECKS = {
    "xlstm-1.3b": {"n_layers": 8},                  # 7 mLSTM, 1 sLSTM block
    "zamba2-1.2b": {"n_layers": 1, "shared_attn_every": 1},
}
FP32_PREFILL_TOL = 1e-4
FP32_DECODE_TOL = 1e-3
BF16_PLAIN_MAX = 0.25
# Granite's bf16 prefill logits, flash and xla, each against the fp32
# prefill of the same weights: flash rounds less (fp32 scores and weights)
# than the plain path, so its max |diff| may be at most 1.25 times xla's
LOGITS_FLASH_VS_XLA = 1.25


def log(*a) -> None:
    print(*a, flush=True)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def sass_counts(path) -> dict:
    """Per kernel of a built library, how many of its SASS instructions are
    wgmma (HGMMA), TMA loads (UTMALDG), int8 MMA (IMMA), 16-bit mma.sync
    (HMMA) and __dp4a (IDP.4A), from ``cuobjdump -sass``."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")
    if not os.path.exists(tool):
        return {"cuobjdump": "not found"}
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True).stdout
    counts: dict = {}
    fn = None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {}
        elif fn is not None:
            for op in ("HGMMA", "UTMALDG", "IMMA", "HMMA", "IDP.4A"):
                if op in line:
                    counts[fn][op] = counts[fn].get(op, 0) + 1
    return counts


# kernels that must run on the tensor cores: library, kernel name, the
# SASS instruction that shows it
TENSOR_CORE_KERNELS = [
    ("conv_fused", "chain_kernel", "IMMA"),
    ("conv_fused", "horizontal_mma_kernel", "IMMA"),
    ("flash_attention", "flash_wgmma_kernel", "HGMMA"),
    ("ssm_scan", "scan_intra_kernel", "HMMA"),
    ("ssm_scan", "scan_state_kernel", "HMMA")]


def check_tensor_cores(sass: dict) -> None:
    """Every instantiation of a tensor-core kernel holds its MMA
    instruction, and the chain kernel no __dp4a; fails without cuobjdump."""
    for lib, kernel, op in TENSOR_CORE_KERNELS:
        if "cuobjdump" in sass[lib]:
            raise AssertionError(f"{lib}: cuobjdump not found, the SASS of "
                                 f"its tensor-core kernels is unchecked")
        fns = {f: c for f, c in sass[lib].items()
               if f.startswith(f"_Z{len(kernel)}{kernel}")}
        if not fns or not all(c.get(op) for c in fns.values()):
            raise AssertionError(f"{lib}: {kernel} lacks {op}: {fns}")
        if kernel == "chain_kernel" and any(c.get("IDP.4A")
                                            for c in fns.values()):
            raise AssertionError(f"chain_kernel still uses __dp4a: {fns}")


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
def extreme_bias(n, gen, dev):
    """int32 biases within 2^20 of -2^31 and 2^31 - 1, alternating."""
    off = torch.randint(0, 1 << 20, (n,), generator=gen, dtype=torch.int64)
    top = torch.arange(n) % 2 == 1
    b = torch.where(top, (1 << 31) - 1 - off, -(1 << 31) + off)
    return b.to(torch.int32).to(dev)


def extreme_horizontal(gen, dev):
    """Horizontal launches at batch 1 and 2 whose 4-channel siblings carry
    the shifts of ``EXTREME_SHIFTS`` and biases near the int32 extremes."""
    k, oc = 4, 4 * len(EXTREME_SHIFTS)
    shift = torch.tensor(EXTREME_SHIFTS, dtype=torch.int32).repeat_interleave(k)
    relu = (torch.arange(len(EXTREME_SHIFTS)) % 2).to(torch.int32)
    out = []
    for n, (h, w, ic, kh) in ((1, (8, 6, 16, 3)), (2, (14, 14, 64, 1))):
        a = (rand_int8((n, h, w, ic), gen, dev),
             rand_int8((kh, kh, ic, oc), gen, dev), extreme_bias(oc, gen, dev),
             shift.to(dev), relu.repeat_interleave(k).to(dev))
        out.append((a, dict(stride=(1, 1), pad=(kh // 2, kh // 2))))
    return out


def hand_chains(gen, dev):
    """Chains the two models do not produce: avg and ceil-mode pools,
    negative shifts, an elt side with its own shift, dilation, gap; and a
    conv with biases near the int32 extremes then an elt stage, at each of
    ``EXTREME_SHIFTS`` (the elt side shifted left by as much)."""
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
    for s in EXTREME_SHIFTS:
        chain = (("conv", "c", 3, 3, 1, 1, 1, 1, 1, 1, s, False, 13, 11),
                 ("elt", "e", s, -s, s % 2 == 0, 13, 11))
        out.append(((x, (rand_int8((3, 3, 8, 12), gen, dev),),
                     (extreme_bias(12, gen, dev),),
                     (rand_int8((2, 13, 11, 12), gen, dev),)),
                    dict(chain=chain, oh=13, ow=11, oc=12)))
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
            check_equal(ops.fused_chain(*args, **kw, packed=prep["packed"]),
                        want, f"{name} chain {launch.nodes}")
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
            check_equal(ops.fused_chain(*args, **kw, tile=tile,
                                        packed=prep["packed"]), want,
                        f"{name} chain {launch.nodes} tile {tile}")
            n_tiles += 1
    log(f"fused_chain == plain on {n_tiles} forced tiles (ragged included)")
    for args, kw in hand_chains(gen, dev):
        want = ops.fused_chain_plain(*args, **kw)
        for tile in (None, (1, 1, kw["oc"]), (3, 2, kw["oc"] // 2)):
            check_equal(ops.fused_chain(*args, **kw, tile=tile), want,
                        f"hand chain {[st[0] for st in kw['chain']]} {tile}")
            n_hand += 1
    log(f"fused_chain == plain on {n_hand} hand-built chain runs "
        f"({len(EXTREME_SHIFTS)} chains at int32-extreme biases, shifts {EXTREME_SHIFTS})")
    for a, kw in extreme_horizontal(gen, dev):
        check_equal(ops.fused_horizontal(*a, **kw),
                    ops.fused_horizontal_plain(*a, **kw),
                    f"horizontal at int32 extremes, batch {a[0].shape[0]}")
    log(f"fused_horizontal == plain at int32-extreme biases, sibling shifts "
        f"{EXTREME_SHIFTS}, batch 1 (3x3) and 2 (1x1)")
    m = models["googlenet"]
    for launch in m["program"].launches():
        if launch.kind != "horizontal":
            continue
        prep = ops.prepare_launch(launch, m["qm"], dev)
        for n in (1, 2, 8):   # split-K at batch 1, larger tiles at 8
            x = rand_int8((n,) + tuple(m["g"].shape(launch.in_name)[1:]),
                          gen, dev)
            a = (x, prep["w"], prep["b"], prep["shift"], prep["relu"])
            kw = dict(stride=tuple(launch.stride), pad=tuple(launch.pad))
            check_equal(ops.fused_horizontal(*a, **kw,
                                             packed=prep["packed"]),
                        ops.fused_horizontal_plain(*a, **kw),
                        f"horizontal {launch.nodes} batch {n}")
        n_horiz += 1
    log(f"fused_horizontal == plain on {n_horiz} GoogLeNet-224 launches at "
        f"batch 1, 2 and 8")
    n_ragged = 0
    for h, w, ic, oc, kh, kwd, st, pd in HORIZONTAL_RAGGED:
        for n in (1, 2):
            a = (rand_int8((n, h, w, ic), gen, dev),
                 rand_int8((kh, kwd, ic, oc), gen, dev),
                 torch.randint(-3000, 3000, (oc,), generator=gen,
                               dtype=torch.int32).to(dev),
                 torch.randint(-1, 12, (oc,), generator=gen,
                               dtype=torch.int32).to(dev),
                 torch.randint(0, 2, (oc,), generator=gen,
                               dtype=torch.int32).to(dev))
            kw = dict(stride=(st, st), pad=(pd, pd))
            oh, ow = ((h + 2 * pd - kh) // st + 1, (w + 2 * pd - kwd) // st
                      + 1)
            plan = ops.horizontal_plan(n * oh * ow, oc, kh * kwd * ic)
            check_equal(ops.fused_horizontal(*a, **kw),
                        ops.fused_horizontal_plain(*a, **kw),
                        f"horizontal {(h, w, ic, oc, kh, kwd, st, pd)} "
                        f"batch {n} plan {plan}")
            n_ragged += 1
    log(f"fused_horizontal == plain on {n_ragged} hand-made ragged, split-K "
        f"and 3x3 stride-2 launches")
    return {"chain_launches": n_chain, "tiles": n_tiles, "hand": n_hand,
            "horizontal_launches": n_horiz, "horizontal_ragged": n_ragged}


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
            pk = prep["packed"]            # as the executor passes them
            k_ms = device_ms(lambda: ops.fused_chain(*args, **kw, packed=pk))
            p_ms = device_ms(lambda: ops.fused_chain_plain(*args, **kw))
            err = (ops.fused_chain(*args, **kw, packed=pk).to(torch.int32)
                   - ops.fused_chain_plain(*args, **kw).to(torch.int32))
            nbytes, macs = chain_work(launch, args, kw)
        else:
            x = rand_int8((1,) + tuple(m["g"].shape(launch.in_name)[1:]),
                          gen, dev)
            a = (x, prep["w"], prep["b"], prep["shift"], prep["relu"])
            kw = dict(stride=tuple(launch.stride), pad=tuple(launch.pad))
            r = rec["fused_horizontal"]
            pk = prep["packed"]            # as the executor passes it
            k_ms = device_ms(lambda: ops.fused_horizontal(*a, **kw,
                                                          packed=pk))
            p_ms = device_ms(lambda: ops.fused_horizontal_plain(*a, **kw))
            err = (ops.fused_horizontal(*a, **kw, packed=pk).to(torch.int32)
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
def profile_device(fn, n: int, trace_name: str) -> dict:
    """Device busy share, kernel time by name and device launches by
    kernel over ``n`` calls of ``fn``, from a ``torch.profiler`` trace
    (saved in the output directory): busy = union of kernel and copy
    intervals over the span from the first device event to the last; the
    launches count the trace's kernel events by the kernel's name without
    its template arguments.  One more call of ``fn`` before them is the
    profiler's warm-up step, traced and dropped: without it the first
    kernels of the traced calls can be missing from the trace; the host
    then idles 0.2 s into the active step before the first traced call
    (one trace of 42 xLSTM-1.3B scan calls still lacked one call's two
    kernels without that pause).  ``trace_launches_without_kernel`` counts
    kernel-launch API events whose kernel the trace lacks.  The wrappers'
    launch counts are set to 0 after the warm-up, so on return they hold
    the traced calls' launches."""
    from torch.profiler import ProfilerActivity, profile, schedule

    path = os.path.join(OUT, trace_name)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)
                 ) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        reset_all_counts()
        time.sleep(0.2)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        prof.step()
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"], e["cat"])
                 for e in events if e.get("ph") == "X" and e.get("cat") in
                 ("kernel", "gpu_memcpy", "gpu_memset"))
    if not dev:
        return {"device_busy_share": "not measured"}
    busy, end = 0.0, dev[0][0]
    by_name: dict = {}
    launches: dict = {}
    ms_by_base: dict = {}
    for t0, t1, name, cat in dev:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        key = name.split("(")[0][:60]
        by_name[key] = by_name.get(key, 0.0) + (t1 - t0) / 1e3 / n
        if cat == "kernel":
            base = kernel_name(name)
            launches[base] = launches.get(base, 0) + 1
            ms_by_base[base] = ms_by_base.get(base, 0.0) + (t1 - t0) / 1e3 / n
    span = dev[-1][1] - dev[0][0]
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    traced = {e.get("args", {}).get("correlation") for e in events
              if e.get("ph") == "X" and e.get("cat") == "kernel"}
    lost = sum(1 for e in events if e.get("ph") == "X"
               and e.get("cat") == "cuda_runtime" and "LaunchKernel" in
               e.get("name", "") and e.get("args", {}).get("correlation")
               not in traced)
    return {"device_busy_share": busy / span,
            "device_span_ms_per_call": span / 1e3 / n,
            "device_events_per_call": len(dev) / n,
            "device_ms_per_call_by_kernel": top,
            "device_launches_by_kernel": launches,
            "device_ms_per_call_by_kernel_name": ms_by_base,
            "trace_launches_without_kernel": lost}


def kernel_name(event: str) -> str:
    """A trace event's kernel name without return type, namespace,
    template arguments or parameters: ``void scan_state_kernel<2, 256,
    true>(...)`` -> ``scan_state_kernel``."""
    head = event.split("(")[0].split("<")[0].strip()
    return head.split()[-1].split("::")[-1] if head else event


def profile_runs(sess, imgs) -> dict:
    """``profile_device`` over ``Session.run`` of each image."""
    it = itertools.cycle(imgs)
    return profile_device(lambda: sess.run(next(it)), len(imgs),
                          "googlenet_run_trace.json")


def outputs_equal(got: dict, want: dict, what: str) -> None:
    if set(got) != set(want):
        raise AssertionError(f"{what}: outputs {sorted(got)} vs "
                             f"{sorted(want)}")
    for k in want:
        check_equal(got[k], want[k], f"{what} {k}")


def run_p50_ms(sessions: dict, imgs, turns: int = 4) -> dict:
    """Host-clock p50 of ``Session.run`` per session, the sessions taking
    turns over the images so the host's drift falls on each alike."""
    lat = {k: [] for k in sessions}
    for _ in range(turns):
        for x in imgs:
            for k, sess in sessions.items():
                t0 = time.perf_counter()
                sess.run(x)
                torch.cuda.synchronize()
                lat[k].append(time.perf_counter() - t0)
    return {k: 1e3 * sorted(v)[len(v) // 2] for k, v in lat.items()}


def artifact_path(sess, imgs, dev) -> dict:
    """The DNNVM object file of the compiled session: saved, loaded and
    reopened through ``Session.from_artifact`` with no recompile, then the
    reopened session serving every image (its own counted path)."""
    from repro_torch import asm
    from repro_torch.kernels.conv_fused import ops
    from repro_torch.runtime import Session

    path = os.path.join(OUT, "googlenet224.dnnvm.npz")
    _, save_s = timed(lambda: asm.save_artifact(sess.artifact, path))
    loaded, load_s = timed(lambda: asm.load_artifact(path))
    misses = asm.PLAN_CACHE.misses
    reopened, open_s = timed(lambda: Session.from_artifact(loaded,
                                                           device=dev))
    if asm.PLAN_CACHE.misses != misses or not reopened.cache_hit:
        raise AssertionError("Session.from_artifact recompiled")
    if reopened.executor.program is not loaded.program:
        raise AssertionError("the reopened session re-lowered the program")
    ops.reset_counts()                       # ---- reopened path starts
    outs = [reopened.run(x) for x in imgs]
    torch.cuda.synchronize()
    launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
    # ---- reopened path ends
    n = len(imgs)
    if launches != {"fused_chain": 42 * n, "fused_horizontal": 9 * n} or any(
            plain.values()):
        raise AssertionError(f"reopened session: launches {launches} for "
                             f"{n} images, plain calls {plain}")
    for i, (x, got) in enumerate(zip(imgs, outs)):
        outputs_equal(got, sess.run(x), f"reopened session image {i}")
    art = sess.artifact
    return {"session": reopened, "launches": launches,
            "save_s": save_s, "load_s": load_s, "open_s": open_s,
            "bytes_on_disk": os.path.getsize(path),
            "peak_ddr_bytes": art.peak_ddr_bytes,
            "reuse_factor": art.reuse_factor,
            "instructions": len(art.instrs),
            "sim_total_cycles": art.sim_total_cycles,
            "fused_coverage": art.fused_coverage,
            "ref_fallbacks": art.program.meta["n_fallbacks"]}


def slice_phase(models, dev, card: str) -> dict:
    from repro_torch import asm, stages
    from repro_torch.core import quantize, validate
    from repro_torch.hw import ZU2
    from repro_torch.kernels.conv_fused import ops
    from repro_torch.runtime import Session

    m = models["googlenet"]
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
    t0 = time.perf_counter()
    sess = Session(g, s, ZU2, qm, device=dev)      # plan-cache miss: compile
    compile_s = time.perf_counter() - t0
    out = sess.run(imgs[0])
    torch.cuda.synchronize()
    per_image = dict(ops.LAUNCHES)
    plain = dict(ops.PLAIN_CALLS)
    if sess.cache_hit:
        raise AssertionError("the first Session did not compile")
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
    t0 = time.perf_counter()
    second = Session(g, s, ZU2, qm, device=dev)
    hit_s = time.perf_counter() - t0
    if not second.cache_hit or second.artifact is not sess.artifact:
        raise AssertionError("a second Session with the same arguments "
                             "missed the plan cache")
    art = artifact_path(sess, imgs, dev)
    reopened = art.pop("session")
    co = stages.compile_model(g, qm, ZU2, strategy=s).session(device=dev)
    for i, x in enumerate(imgs):
        outputs_equal(co.run(x), sess.run(x), f"compile_model session "
                      f"image {i}")
    trips = {}
    for name in ("googlenet", "resnet50"):
        mm = models[name]
        t0 = time.perf_counter()
        trip = validate.artifact_round_trip(
            mm["g"], mm["qm"], quantize.quantize_to(mm["x"],
                                                    mm["qm"].f_a["data"]),
            mm["strategy"], ZU2, os.path.join(OUT, f"{name}_trip.npz"),
            device=dev)
        if not trip.bit_exact:
            raise AssertionError(f"{name}-224 artifact round trip on {dev}: "
                                 f"{trip}")
        trips[name] = time.perf_counter() - t0
    log(f"validate.artifact_round_trip on the card: exact for GoogLeNet-224 "
        f"and ResNet50-224 ({json.dumps(trips)} s)")
    p50 = run_p50_ms({"compiled": sess, "reopened": reopened}, imgs)
    art.update({"compile_s": compile_s, "cache_hit_s": hit_s,
                "run_p50_ms_compiled": p50["compiled"],
                "run_p50_ms_reopened": p50["reopened"]})
    log(f"GoogLeNet-224 object file on {card} (host seconds and host-clock "
        f"p50, not kernel times): " + json.dumps(art))
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
           "launches_per_image": per_image, "launches": launches,
           "artifact": art, **prof}
    log(f"GoogLeNet-224 serving on {card}: " + json.dumps(res))
    return res


# ----------------------------------------------------------------- phase 8
def _counts(reg) -> dict:
    return {st: (reg.get(f"stages.{st}.misses").value
                 if reg.get(f"stages.{st}.misses") else 0.0)
            for st in ("wrapped", "lowered", "planned", "compiled")}


def check_candidates(m, prog, provenance, gen, dev) -> int:
    """Every tile the search measured, run through ``run_launch`` on the
    card on random inputs, equals the chain's plain version bit for bit."""
    import dataclasses

    from repro_torch.core import lower
    from repro_torch.kernels.conv_fused import ops

    by_key = {lower.tile_key(it.nodes): it for it in prog.launches()}
    n = 0
    for u in provenance:
        if u["kind"] != "chain":
            continue
        item = dataclasses.replace(by_key[u["key"]], tile=())
        prep = ops.prepare_launch(item, m["qm"], dev)
        args, kw = chain_args(item, m["g"], prep, gen, dev)
        env = dict(zip((item.in_name,) + tuple(item.sides),
                       (args[0],) + tuple(args[3])))
        want = ops.fused_chain_plain(*args, **kw)
        for c in u["candidates"]:
            it = dataclasses.replace(
                item, tile=() if c["default"] else tuple(c["shape"]))
            check_equal(ops.run_launch(it, env, prepared=prep)[it.out_name],
                        want, f"tile candidate {c['shape']} of {u['key']}")
            n += 1
    return n


def tune_phase(m, dev, card: str) -> dict:
    """The measured compile loop on GoogLeNet-224 (phase 8)."""
    import copy

    from repro_torch import stages, tune
    from repro_torch.core import lower, pathsearch, quantize, validate
    from repro_torch.hw import H100, ZU2
    from repro_torch.kernels.conv_fused import ops
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.runtime import Session

    t_phase = time.perf_counter()
    g, qm = m["g"], m["qm"]
    # 1. calibrate: the default candidate groups and stacked rows
    cal, cal_s = timed(lambda: tune.calibrate(
        g, qm, ZU2, harness=tune.MeasurementHarness(g, qm, ZU2, device=dev)))
    prof, rep = cal.profile, cal.report
    cache = tune.ProfileCache(os.path.join(OUT, "profiles"))
    cache.put(prof)
    again = tune.resolve_profile(prof.name, cache=cache)
    if again.hash() != prof.hash():
        raise AssertionError(f"profile {prof.name} reloaded with hash "
                             f"{again.hash()}, saved {prof.hash()}")
    with open(os.path.join(OUT, "tune_calibration.json"), "w") as f:
        json.dump({"profile": prof.to_json(), "report": rep}, f, indent=1)
    eff = prof.effective_summary(H100)
    log(f"calibrate on {card}: {rep['n_samples']} rows "
        f"({rep['stacked']['n_samples']} stacked launches), deviation "
        f"{rep['deviation']} (stacked {rep['stacked']['deviation']}; the "
        f"paper's band is 5-10%), form {prof.combine}, {rep['n_skipped']} "
        f"skipped, {cal_s:.1f} s; profile {prof.name} {prof.hash()} "
        f"reloaded from the cache by name with an equal hash; effective "
        f"rates at the H100 clock: " + json.dumps(eff))

    # 2. the path search under the calibrated evaluator
    s_cal = pathsearch.search(g, ZU2, evaluator=tune.CalibratedEvaluator(
        g, ZU2, prof))
    plans = {}
    for name, s in (("analytic", m["strategy"]), ("calibrated", s_cal)):
        meta = lower.lower_strategy(g, s, qm).meta
        plans[name] = {"groups": len(s.groups),
                       "horizontals": len(s.horizontal),
                       "launches": meta["n_launches"],
                       "fallbacks": meta["n_fallbacks"],
                       "fused_coverage": meta["coverage"]}
    log("pathsearch.search(ZU2) analytic vs calibrated: " + json.dumps(plans))
    s_plain = copy.copy(s_cal)              # same partition, no tile records
    s_plain.meta = {k: v for k, v in s_cal.meta.items()
                    if not k.startswith("tile_")}

    # 3. the tile search on the card, candidates under the H100 model
    tsr, ts_s = timed(lambda: tune.search_tile_shapes(
        g, qm, H100, s_cal,
        harness=tune.MeasurementHarness(g, qm, H100, device=dev), top_k=3))
    prog = lower.lower_strategy(g, s_cal, qm)
    gen = torch.Generator().manual_seed(SEED + 5)
    n_cands = check_candidates(m, prog, tsr.provenance, gen, dev)
    units, chain_us = [], {"default": 0.0, "tuned": 0.0}
    ratios = []              # each unit's fastest other candidate / default
    for u in tsr.provenance:
        if u["kind"] != "chain":
            continue
        rows = {tuple(c["shape"]): c["measured"] for c in u["candidates"]}
        base = rows[tuple(u["default"])]
        others = [c["measured"] for c in u["candidates"] if not c["default"]]
        if others:
            ratios.append(min(others) / base)
        win = rows[tuple(u["chosen"])] if u["chosen"] else base
        chain_us["default"] += 1e6 * base
        chain_us["tuned"] += 1e6 * win
        if u["chosen"]:
            units.append({"key": u["key"], "default": u["default"],
                          "default_us": 1e6 * base, "chosen": u["chosen"],
                          "chosen_us": 1e6 * win})
    n_dropped = sum(len(u["dropped"]) for u in tsr.provenance)
    with open(os.path.join(OUT, "tune_tiles.json"), "w") as f:
        json.dump(tsr.to_json(), f, indent=1)
    log(f"tile search on {card}: {tsr.n_units} units, {tsr.n_tuned} tuned, "
        f"{n_dropped} candidates the card cannot launch (reasons in "
        f"tune_tiles.json), {n_cands} measured candidates == plain, "
        f"{ts_s:.1f} s ({1e3 * ts_s / (12 * n_cands):.2f} ms per sample of "
        f"12 passes); chain device us per image (the search's own "
        f"samples): default {chain_us['default']:.2f}, tuned "
        f"{chain_us['tuned']:.2f}; fastest other candidate / default per "
        f"unit: min {min(ratios):.4f}, median {float(np.median(ratios)):.4f}"
        f", max {max(ratios):.4f} over {len(ratios)} units; tuned units: "
        + json.dumps(units))

    # 4. the sessions, each its own path: the search's winners ("tuned"),
    # every chain at its fastest measured non-default candidate ("forced":
    # tile records the card executes even where none wins), and none
    s_forced = copy.copy(s_plain)
    s_forced.meta = dict(s_plain.meta, tile_shapes={
        u["key"]: min((c for c in u["candidates"] if not c["default"]),
                      key=lambda c: c["measured"])["shape"]
        for u in tsr.provenance
        if any(not c["default"] for c in u["candidates"])})
    rng = np.random.default_rng(SEED + 6)
    imgs = [quantize.quantize_to(rng.standard_normal(g.shape("data")[1:]),
                                 qm.f_a["data"]) for _ in range(8)]
    xq = quantize.quantize_to(m["x"], qm.f_a["data"])
    sessions, paths = {}, {}
    for name, strat in (("untuned", s_plain), ("tuned", s_cal),
                        ("forced", s_forced)):
        records = sum(1 for it in lower.lower_strategy(g, strat,
                                                       qm).launches()
                      if it.tile)
        ops.reset_counts()                   # ---- this path starts here
        sess = Session(g, strat, ZU2, qm, device=dev, profile=prof)
        outs = [sess.run(x) for x in imgs]
        torch.cuda.synchronize()
        launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN_CALLS)
        applied = ops.TILE_RECORDS["applied"]   # ---- this path ends here
        if applied != records * len(imgs) or any(plain.values()):
            raise AssertionError(f"{name} session: {applied} tile records "
                                 f"applied over {len(imgs)} images for "
                                 f"{records} records, plain calls {plain}")
        if not validate.bit_exact(g, qm, xq, strat, device=dev):
            raise AssertionError(f"{name} GoogLeNet-224 fused != ref on the "
                                 f"card")
        if name != "untuned":
            for i, (x, got) in enumerate(zip(imgs, outs)):
                outputs_equal(got, sessions["untuned"].run(x),
                              f"{name} vs untuned image {i}")
        sessions[name] = sess
        paths[name] = {"records": records, "applied": applied,
                       "launches": launches}
    if paths["tuned"]["records"] != tsr.n_tuned:
        raise AssertionError(f"{tsr.n_tuned} tuned units, "
                             f"{paths['tuned']['records']} records")
    sess = sessions["tuned"]
    p50 = run_p50_ms(sessions, imgs)
    chain_ms = {}
    for name, ss in sessions.items():
        it = itertools.cycle(imgs)
        pr = profile_device(lambda: ss.run(next(it)), 5,
                            f"googlenet_{name}_trace.json")
        chain_ms[name] = pr.get("device_ms_per_call_by_kernel_name",
                                {}).get("chain_kernel")
    applied = paths["tuned"]["applied"]
    log(f"GoogLeNet-224 sessions on {card}, bit_exact each, per path over "
        f"{len(imgs)} images: " + json.dumps(paths) + "; Session.run p50 ms "
        "(host clock, turns) " + json.dumps(p50) + "; chain_kernel device "
        "ms per image in a profiled run " + json.dumps(chain_ms))

    # Lowered.retune reruns only the tile search
    reg = MetricsRegistry()
    sc = stages.StageCache(registry=reg)
    lo = stages.wrap(g, qm, ZU2, cache=sc).lower(strategy=s_plain,
                                                 profile=prof)
    before = _counts(reg)
    lo2 = lo.retune(profile=prof)
    after = _counts(reg)
    if (after["wrapped"] != before["wrapped"]
            or after["lowered"] != before["lowered"] + 1
            or [list(x) for x in lo2.strategy.groups]
            != [list(x) for x in lo.strategy.groups]):
        raise AssertionError(f"Lowered.retune: stage misses {before} -> "
                             f"{after}")
    log(f"Lowered.retune: stage-cache misses {before} -> {after} (one new "
        f"lowering, no search, no wrap), "
        f"{len(lo2.strategy.meta['tile_shapes'])} profile-predicted tiles")

    # 5. the cross-request schedule view (the ZU2 model's cycles)
    pr = sess.pipeline_report(8, ddr_slots=None)
    sched = {"ddr_slots": pr.ddr_slots, "source": pr.ddr_slots_source,
             "makespan_cycles": pr.total_cycles,
             "single_request_cycles": pr.single_request_cycles,
             "modeled_speedup": pr.modeled_speedup,
             "bottleneck": pr.bottleneck, "utilization": pr.utilization()}
    log("pipeline_report(8) of the tuned session, ZU2-model cycles (the "
        "FPGA model's, not the card's): " + json.dumps(sched))
    secs = time.perf_counter() - t_phase
    log(f"tune phase took {secs:.1f} s")
    return {"rows": rep["n_samples"], "deviation": rep["deviation"],
            "stacked_deviation": rep["stacked"]["deviation"],
            "profile_hash": prof.hash(), "plans": plans,
            "n_units": tsr.n_units, "n_tuned": tsr.n_tuned,
            "candidates_checked": n_cands, "chain_us_search": chain_us,
            "candidate_ratio": {"min": min(ratios), "max": max(ratios),
                                "median": float(np.median(ratios))},
            "paths": paths,
            "tile_records_applied": applied, "run_p50_ms": p50,
            "chain_ms_per_image": chain_ms, "schedule": sched,
            "seconds": secs}


# ----------------------------------------------------------------- phase 4
def flash_inputs(case, dtype, dev, seed):
    b, sq, sk, h, kv, d, off, causal = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
    return (q, k, v), dict(q_offset=off, causal=causal)


def flash_work(case, elem_bytes: int) -> tuple[int, int]:
    """(bytes, FLOPs) one flash call needs: q, k, v read once, o written
    once; 4 d FLOPs (QK^T and PV) for each (query, key) pair the mask
    keeps, which for causal rows is q_offset + i + 1 keys (up to Sk)."""
    b, sq, sk, h, kv, d, off, causal = case
    nbytes = elem_bytes * (2 * b * sq * h * d + 2 * b * sk * kv * d)
    pairs = (sum(min(sk, off + i + 1) for i in range(sq)) if causal
             else sq * sk)
    return nbytes, 4 * d * b * h * pairs


def flash_kernel_phase(dev) -> dict:
    from repro_torch.kernels.flash_attention import ops as flash

    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {}
    for i, (name, case) in enumerate(FLASH_CASES.items()):
        (q, k, v), kw = flash_inputs(case, torch.float32, dev, SEED + i)
        got = flash.flash_attention(q, k, v, **kw)
        err = float((got - flash.attention_ref(q, k, v, **kw)).abs().max())
        if not err <= FP32_TOL:
            raise AssertionError(f"flash_attention {name} fp32: max |err| "
                                 f"{err} > {FP32_TOL}")
        errs[f"{name} float32"] = err
        q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        got = flash.flash_attention(q, k, v, **kw)
        want = flash.attention_fp32(q, k, v, **kw)
        rel = flash.row_rel_err(got, want)
        tol = flash.OUT_REL_TOL[torch.bfloat16]
        if not (rel <= tol and torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention {name} bf16: max row-"
                                 f"relative |err| {rel} > {tol}")
        errs[f"{name} bfloat16"] = float((got.float() - want).abs().max())
        errs[f"{name} bfloat16 row-relative"] = rel
        del q, k, v, got, want
    log("flash_attention == plain on the card (fp32 max |err| vs "
        "attention_ref; bf16 max |err| and row-relative err vs "
        "attention_fp32): " + json.dumps(errs))
    return errs


def flash_timing_phase(dev) -> dict:
    """One Granite-8B prefill call (bf16, the tensor-core kernel) of the
    kernel, its plain version and SDPA, with the bound from this call's
    shapes; and the CUDA-core kernel on the same call in fp32."""
    from repro_torch.kernels.flash_attention import ops as flash

    (q, k, v), kw = flash_inputs(GRANITE_PREFILL, torch.float32, dev, SEED)
    fp32_ms = device_ms(lambda: flash.flash_attention(q, k, v, **kw), reps=3)
    (q, k, v), kw = flash_inputs(GRANITE_PREFILL, torch.bfloat16, dev, SEED)
    ms = device_ms(lambda: flash.flash_attention(q, k, v, **kw), reps=10)
    plain_ms = device_ms(lambda: flash.attention_ref(q, k, v, **kw), reps=10)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), reps=10)
    nbytes, flops = flash_work(GRANITE_PREFILL, 2)
    t_bytes, t_ops = 1e3 * nbytes / MEM_BW, 1e3 * flops / BF16_PEAK
    # the kernel's own tensor work: P V runs on P's hi and lo halves, so 6 d
    # FLOP per kept pair against the function's 4 d
    tc_flops = flops * 6 // 4
    rec = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": max(t_bytes, t_ops), "bound_bytes_ms": t_bytes,
           "bound_ops_ms": t_ops, "flops": flops, "bytes": nbytes,
           "tflops": flops / ms / 1e9, "kernel_tensor_flops": tc_flops,
           "kernel_tensor_tflops": tc_flops / ms / 1e9,
           "kernel_tensor_share_of_bf16_peak": tc_flops * 1e3 / ms
           / BF16_PEAK, "fp32_cuda_core_ms": fp32_ms}
    log("flash_attention at Granite-8B prefill (4x2048, 32/8 heads, d=128, "
        "bf16): " + json.dumps(rec))
    return rec


# ----------------------------------------------------------------- phase 5
def _kernel_ops():
    from repro_torch.kernels.conv_fused import ops as conv
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.ssm_scan import ops as scan

    return conv, flash, scan


def reset_all_counts() -> None:
    for mod in _kernel_ops():
        mod.reset_counts()


def all_counts() -> tuple[dict, dict]:
    launches, plain = {}, {}
    for mod in _kernel_ops():
        launches.update(mod.LAUNCHES)
        plain.update(mod.PLAIN_CALLS)
    return launches, plain


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@torch.inference_mode()
def lm_slice_phase(dev, card: str) -> dict:
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import api

    base = configs.get("granite-8b")
    cfg = dataclasses.replace(base, attn_impl="flash")
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for d in (params, params["layers"])
                   for t in d.values() if torch.is_tensor(t))
    log(f"Granite-8B at full width on the card: {n_params} parameters "
        f"(bf16) drawn in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    B, S = GRANITE_PREFILL[0], GRANITE_PREFILL[1]
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device=dev)
    prefill = serve.make_prefill_step(cfg)
    prefill(params, {"tokens": tokens[:, :128]})            # warm-up

    reset_all_counts()                        # ---- main path starts here
    logits, prefill_s = timed(lambda: prefill(params, {"tokens": tokens}))
    launches, plain = all_counts()            # ---- main path ends here
    if launches.get("flash_attention") != cfg.n_layers or any(
            plain.values()):
        raise AssertionError(f"flash prefill: launches {launches}, plain "
                             f"calls {plain}")
    if tuple(logits.shape) != (B, S, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"bad prefill logits {tuple(logits.shape)}")
    xla_cfg = dataclasses.replace(cfg, attn_impl="xla")
    want, xla_s = timed(lambda: serve.make_prefill_step(xla_cfg)(
        params, {"tokens": tokens}))
    torch.backends.cuda.matmul.allow_tf32 = False
    ref_cfg = dataclasses.replace(xla_cfg, dtype="float32")
    ref = serve.make_prefill_step(ref_cfg)(
        {k: ({kk: t.float() for kk, t in v.items()} if isinstance(v, dict)
             else v.float()) for k, v in params.items()}, {"tokens": tokens})
    diff = float((logits.float() - want.float()).abs().max())
    err_flash = float((logits.float() - ref).abs().max())
    err_xla = float((want.float() - ref).abs().max())
    scale = float(ref.abs().max())
    agree = float((logits.argmax(-1) == want.argmax(-1)).float().mean())
    del ref
    if not err_flash <= LOGITS_FLASH_VS_XLA * err_xla:
        raise AssertionError(f"flash prefill logits vs fp32: max |diff| "
                             f"{err_flash} > {LOGITS_FLASH_VS_XLA} x {err_xla}"
                             f" (xla's)")
    log(f"Granite-8B prefill {B}x{S} (flash): {prefill_s * 1e3:.1f} ms, "
        f"{B * S / prefill_s:.0f} tokens/s; xla prefill {xla_s * 1e3:.1f} "
        f"ms; logits max |flash - xla| {diff}, against the fp32 prefill of "
        f"the same weights: flash {err_flash}, xla {err_xla} (largest "
        f"|logit| {scale}); argmax agreement flash/xla {agree}")
    del logits, want
    torch.cuda.empty_cache()

    reset_all_counts()
    prompt = rng.integers(0, cfg.vocab, (B, 128))
    served = serve.serve_loop(cfg, params, prompt, 32, dev)
    served = serve.serve_loop(cfg, params, prompt, 32, dev)   # warm
    if any(all_counts()[1].values()) or served["tokens"].shape != (B, 32) \
            or not ((0 <= served["tokens"]).all()
                    and (served["tokens"] < cfg.vocab).all()):
        raise AssertionError(f"serve loop: {served['tokens'].shape}")
    pbd_tps = B * 127 / served["prefill_s"]
    dec_tps = B * 32 / served["decode_s"]
    log(f"Granite-8B serve loop (batch {B}): prefill-by-decode of 127 tokens "
        f"{pbd_tps:.1f} tokens/s, 32 greedy steps {dec_tps:.1f} tokens/s "
        f"({served['decode_s'] / 32 * 1e3:.2f} ms/step)")
    prof_prefill = profile_device(lambda: prefill(params, {"tokens": tokens}),
                                  1, "granite_prefill_trace.json")
    cache = api.init_cache(cfg, B, 160, dev)
    step = serve.make_serve_step(cfg)
    tok = tokens[:, 0]
    prof_decode = profile_device(lambda: step(params, cache, tok, 0), 4,
                                 "granite_decode_trace.json")
    del cache
    log("Granite-8B profiled: prefill " + json.dumps(prof_prefill)
        + "; decode step " + json.dumps(prof_decode))
    del params
    torch.cuda.empty_cache()

    # fp32 at full width, 2 layers: the path's arithmetic, tightly
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    p32 = api.init_params(cfg32, torch.Generator(device=dev).manual_seed(
        SEED + 1), dev)
    toks = tokens[:, :512]
    got = serve.make_prefill_step(cfg32)(p32, {"tokens": toks})
    want = serve.make_prefill_step(dataclasses.replace(
        cfg32, attn_impl="xla"))(p32, {"tokens": toks})
    err32 = float((got - want).abs().max())
    if not err32 <= 1e-4:
        raise AssertionError(f"fp32 flash vs plain prefill: {err32}")
    short = toks[:, :128]
    full = serve.make_prefill_step(cfg32)(p32, {"tokens": short})
    cache = api.init_cache(cfg32, B, 128, dev)
    dec = []
    for t in range(128):
        lg, cache = api.decode_step(cfg32, p32, cache, short[:, t], t)
        dec.append(lg)
    err_dec = float((torch.stack(dec, 1) - full).abs().max())
    if not err_dec <= 1e-3:
        raise AssertionError(f"fp32 decode vs prefill: {err_dec}")
    log(f"Granite-8B full width, 2 layers, fp32: flash vs plain prefill "
        f"({B}x512) max |diff| {err32}; teacher-forced decode vs prefill "
        f"({B}x128) max |diff| {err_dec}")
    return {"card": card, "prefill_ms": prefill_s * 1e3,
            "prefill_tokens_per_s": B * S / prefill_s,
            "xla_prefill_ms": xla_s * 1e3, "logits_max_abs_diff": diff,
            "logits_err_vs_fp32": {"flash": err_flash, "xla": err_xla},
            "logits_max_abs": scale, "argmax_agreement": agree,
            "prefill_by_decode_tokens_per_s": pbd_tps,
            "decode_tokens_per_s": dec_tps, "launches": launches,
            "prefill_profile": prof_prefill, "decode_profile": prof_decode,
            "fp32_prefill_err": err32, "fp32_decode_err": err_dec}


# ----------------------------------------------------------------- phase 6
def scan_inputs(case, dtype, dev, seed):
    """q, k (stride 0 over the heads where the case broadcasts them, as
    Zamba2's are), v and log_a = log_sigmoid(N(0, 1)) (mean about -0.8, the
    decay of both models under random weights)."""
    b, s, h, dk, dv, bcast = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    hq = 1 if bcast else h
    q, k = ((torch.randn((b, s, hq, dk), generator=gen, device=dev)
             / dk ** 0.5).to(dtype).expand(b, s, h, dk) for _ in range(2))
    v = torch.randn((b, s, h, dv), generator=gen, device=dev).to(dtype)
    la = torch.nn.functional.logsigmoid(
        torch.randn((b, s, h), generator=gen, device=dev))
    return q, k, v, la


def scan_work(case, elem_bytes: int) -> tuple[int, int]:
    """(bytes, FLOPs) one scan call needs: q, k, v and log_a read once (a
    broadcast q or k once per (batch, step)), y written once; the least
    work of the function, the step-by-step recurrence's 4 K V per step and
    head (2 K V for k_t v_t^T into the state, 2 K V for S^T q_t).  A chunked
    form adds its masked L x L products, L (L + 1) (K + V) per chunk and
    head, which the function does not need."""
    b, s, h, dk, dv, bcast = case
    hq = 1 if bcast else h
    nbytes = (elem_bytes * (2 * b * s * hq * dk + 2 * b * s * h * dv)
              + 4 * b * s * h)
    return nbytes, 4 * b * s * h * dk * dv


def scan_kernel_phase(dev) -> dict:
    from repro_torch.kernels.ssm_scan import ops as scan
    from repro_torch.nn.recurrent import chunk_for, chunked_linear_scan

    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {}
    for i, (name, case) in enumerate(SCAN_CASES.items()):
        q, k, v, la = scan_inputs(case, torch.float32, dev, SEED + i)
        want32 = chunked_linear_scan(q, k, v, la, chunk=chunk_for(case[1]))[0]
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            qt, kt, vt_ = (t.to(dtype) for t in (q, k, v))
            want = want32 if dtype == torch.float32 else scan.scan_fp32(
                qt, kt, vt_, la)
            tol = scan.OUT_REL_TOL.get(dtype, SCAN_FP32_TOL)
            for vt in scan.slabs(dtype, case[3]):
                got = scan.launch(qt, kt, vt_, la, vt)
                rel = scan.row_rel_err(got, want)
                if not (rel <= tol and torch.isfinite(got).all()):
                    raise AssertionError(
                        f"ssm_scan {name} {dtype} ({scan.ROUTES[dtype]}) "
                        f"slab {vt}: max row-relative |err| {rel} > {tol}")
                key = f"{name} {str(dtype)[6:]} slab {vt}"
                errs[key] = float((got.float() - want.float()).abs().max())
                errs[f"{key} row-relative"] = rel
                if dtype == torch.bfloat16:
                    share = scan.round_mismatch(got, want)
                    errs[f"{key} share off bf16(scan_fp32)"] = share
                    if not share <= scan.ROUND_SHARE_TOL:
                        raise AssertionError(
                            f"ssm_scan {name} bf16 slab {vt}: {share} of "
                            f"the elements differ from scan_fp32 rounded "
                            f"to bf16 > {scan.ROUND_SHARE_TOL}")
            del qt, kt, vt_, want, got
        del q, k, v, la, want32
    log("ssm_scan == plain on the card at every route and slab width "
        "(fp32 against chunked_linear_scan, bf16 and fp16 against "
        "scan_fp32; max |err| and row-relative err; for bf16 the share of "
        "elements that differ from scan_fp32 rounded to bf16): "
        + json.dumps(errs))
    return errs


def scan_timing_phase(dev) -> dict:
    """One call at each model's prefill shape of the bf16 route (at the slab
    width the wrapper chooses, and at every width it takes), its plain
    version and the bound from the call's shapes; the fp32/fp16 route's
    kernel on the same inputs upcast to fp32 beside it."""
    from repro_torch.kernels.ssm_scan import ops as scan
    from repro_torch.nn.recurrent import chunked_linear_scan

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for name, case in (("xlstm-1.3b", XLSTM_SCAN),
                       ("zamba2-1.2b", ZAMBA_SCAN)):
        q, k, v, la = scan_inputs(case, torch.bfloat16, dev, SEED)
        b, s, h, dk, dv, _ = case
        ms = device_ms(lambda: scan.ssm_scan(q, k, v, la), reps=5)
        plain_ms = device_ms(lambda: chunked_linear_scan(q, k, v, la)[0],
                             reps=5)
        nbytes, flops = scan_work(case, 2)
        t_bytes, t_ops = 1e3 * nbytes / MEM_BW, 1e3 * flops / BF16_PEAK
        rec = {"slab": scan.slab_width(b, h, dk, dv, n_sm), "ms": ms,
               "plain_ms": plain_ms, "library_ms": None,
               "bound_ms": max(t_bytes, t_ops), "bound_bytes_ms": t_bytes,
               "bound_ops_ms": t_ops, "flops": flops, "bytes": nbytes,
               "tflops": flops / ms / 1e9,
               "ms_by_slab": {vt: device_ms(
                   lambda: scan.launch(q, k, v, la, vt), reps=5)
                   for vt in scan.slabs(torch.bfloat16, dk)}}
        q32, k32, v32 = (t.float() for t in (q, k, v))
        rec["fp32_route_ms"] = device_ms(lambda: scan.ssm_scan(
            q32, k32, v32, la), reps=3)
        out[name] = rec
        log(f"ssm_scan at {name}'s prefill shape {case[:5]}, bf16: "
            + json.dumps(rec))
        del q, k, v, la, q32, k32, v32
    return out


# ----------------------------------------------------------------- phase 7
@contextlib.contextmanager
def plain_scan(chunk: int | None = None, check: list | None = None):
    """The models' scan seam: ``ops.ssm_scan`` replaced by the plain
    ``chunked_linear_scan`` (at the caller's chunk, or at ``chunk``) while
    the block runs.  With ``check``, every call also launches the kernel on
    the same inputs and appends its row-relative error against the kernel's
    arithmetic: the plain output itself for fp32 inputs, ``scan_fp32`` for
    bf16 and fp16 ones."""
    from repro_torch.kernels.ssm_scan import ops as scan
    from repro_torch.nn.recurrent import chunked_linear_scan

    kernel = scan.ssm_scan

    def seam(q, k, v, la, chunk_=128):
        y = chunked_linear_scan(q, k, v, la, chunk=chunk or chunk_)[0]
        if check is not None:
            want = y if q.dtype == torch.float32 else scan.scan_fp32(
                q, k, v, la)
            check.append(scan.row_rel_err(kernel(q, k, v, la, chunk=chunk_),
                                          want))
        return y

    scan.ssm_scan = lambda q, k, v, la, chunk=128: seam(q, k, v, la, chunk)
    try:
        yield
    finally:
        scan.ssm_scan = kernel


def _to(params, dtype):
    return {k: _to(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in params.items()}


def _n_scans(cfg) -> int:
    if cfg.family == "ssm":
        return cfg.n_layers - cfg.n_layers // cfg.slstm_every
    return cfg.n_layers


@torch.inference_mode()
def recurrent_slice_phase(arch: str, dev, card: str) -> dict:
    import dataclasses

    from repro_torch import configs
    from repro_torch.kernels.ssm_scan import ops as scan
    from repro_torch.launch import serve
    from repro_torch.models import api

    cfg = configs.get(arch)
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for d in params.values()
                   for t in (d.values() if isinstance(d, dict) else [d]))
    log(f"{arch} at full width and depth on the card: {n_params} parameters "
        f"(bf16) drawn in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    B, S = 4, 2048
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device=dev)
    prefill = serve.make_prefill_step(cfg)
    prefill(params, {"tokens": tokens[:, :128]})            # warm-up

    reset_all_counts()                        # ---- main path starts here
    logits, prefill_s = timed(lambda: prefill(params, {"tokens": tokens}))
    launches, plain = all_counts()            # ---- main path ends here
    want_launches = {"fused_chain": 0, "fused_horizontal": 0,
                     "flash_attention": 0, "ssm_scan": _n_scans(cfg)}
    if launches != want_launches or any(plain.values()):
        raise AssertionError(f"{arch} prefill: launches {launches}, plain "
                             f"calls {plain}")
    if tuple(logits.shape) != (B, S, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"bad prefill logits {tuple(logits.shape)}")
    with plain_scan():
        want, plain_s = timed(lambda: prefill(params, {"tokens": tokens}))
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        ref = serve.make_prefill_step(cfg32)(_to(params, torch.float32),
                                             {"tokens": tokens})
    # every launch of the path on the model's own inputs (those of the plain
    # prefill), against the kernel's arithmetic in fp32
    per_launch: list = []
    with plain_scan(check=per_launch):
        prefill(params, {"tokens": tokens})
    tol = scan.OUT_REL_TOL[torch.bfloat16]
    if len(per_launch) != _n_scans(cfg) or not max(per_launch) <= tol:
        raise AssertionError(f"{arch} bf16 launches on the model's inputs: "
                             f"max row-relative |err| {max(per_launch)} > "
                             f"{tol} ({len(per_launch)} launches)")
    diff = float((logits.float() - want.float()).abs().max())
    err_kernel = float((logits.float() - ref).abs().max())
    err_plain = float((want.float() - ref).abs().max())
    scale = float(ref.abs().max())
    agree = float((logits.argmax(-1) == want.argmax(-1)).float().mean())
    del ref, want
    if not err_kernel <= LOGITS_KERNEL_VS_PLAIN * err_plain:
        raise AssertionError(f"{arch} prefill logits vs fp32: max |diff| "
                             f"{err_kernel} > {LOGITS_KERNEL_VS_PLAIN} x "
                             f"{err_plain} (the plain scan's)")
    log(f"{arch} prefill {B}x{S} (ssm_scan kernel): {prefill_s * 1e3:.1f} ms"
        f", {B * S / prefill_s:.0f} tokens/s; plain-scan prefill "
        f"{plain_s * 1e3:.1f} ms; logits max |kernel - plain| {diff}, "
        f"against the fp32 prefill of the same weights: kernel {err_kernel}"
        f", plain {err_plain} (largest |logit| {scale}); argmax agreement "
        f"{agree}; each of the {len(per_launch)} launches on the model's "
        f"inputs against scan_fp32: max row-relative |err| "
        f"{max(per_launch)}")
    prof_prefill = profile_device(lambda: prefill(params, {"tokens": tokens}),
                                  1, f"{arch}_prefill_trace.json")
    n_calls = all_counts()[0]["ssm_scan"]
    device_launches = {kern: prof_prefill.get(
        "device_launches_by_kernel", {}).get(kern, 0)
        for kern in scan.ROUTES[torch.bfloat16]}
    if n_calls != _n_scans(cfg) or any(
            c != n_calls for c in device_launches.values()):
        raise AssertionError(
            f"{arch} profiled prefill: {n_calls} ssm_scan calls, device "
            f"launches in the trace {device_launches}; kernel launches "
            f"whose kernel the trace lacks: "
            f"{prof_prefill.get('trace_launches_without_kernel')}")
    log(f"{arch} prefill profiled ({n_calls} ssm_scan calls; device "
        f"launches in the trace {device_launches}): "
        + json.dumps(prof_prefill))
    del logits
    torch.cuda.empty_cache()

    prompt = rng.integers(0, cfg.vocab, (B, 128))
    serve.serve_loop(cfg, params, prompt[:, :8], 4, dev)      # warm-up
    reset_all_counts()
    served = serve.serve_loop(cfg, params, prompt, 32, dev)
    if any(all_counts()[0].values()) or any(all_counts()[1].values()) \
            or served["tokens"].shape != (B, 32) \
            or not ((0 <= served["tokens"]).all()
                    and (served["tokens"] < cfg.vocab).all()):
        raise AssertionError(f"{arch} serve loop: {served['tokens'].shape}, "
                             f"counts {all_counts()}")
    pbd_tps = B * 127 / served["prefill_s"]
    dec_tps = B * 32 / served["decode_s"]
    log(f"{arch} serve loop (batch {B}): prefill-by-decode of 127 tokens "
        f"{pbd_tps:.1f} tokens/s, 32 greedy steps {dec_tps:.1f} tokens/s "
        f"({served['decode_s'] / 32 * 1e3:.2f} ms/step)")
    del params
    torch.cuda.empty_cache()

    checks = depth_check(arch, cfg, DEPTH_CHECKS[arch], tokens[:, :512],
                         dev)
    return {"card": card, "prefill_ms": prefill_s * 1e3,
            "prefill_tokens_per_s": B * S / prefill_s,
            "plain_scan_prefill_ms": plain_s * 1e3,
            "logits_max_abs_diff": diff,
            "logits_err_vs_fp32": {"kernel": err_kernel, "plain": err_plain},
            "logits_max_abs": scale, "argmax_agreement": agree,
            "prefill_by_decode_tokens_per_s": pbd_tps,
            "decode_tokens_per_s": dec_tps, "launches": launches,
            "prefill_profile": prof_prefill,
            "scan_device_launches": device_launches,
            "launch_err_bf16": max(per_launch), "cut_depth": checks}


@torch.inference_mode()
def depth_check(arch: str, cfg, fields: dict, toks, dev) -> dict:
    """The model at full width and a cut depth (``fields`` of its config),
    weights drawn in bf16 from seed 1 and also carried to fp32.  In fp32:
    every launch against the plain scan, kernel prefill against plain
    prefill and teacher-forced decode against prefill; then the bf16
    prefill, kernel and plain scan, against the fp32 one."""
    import dataclasses

    from repro_torch.launch import serve
    from repro_torch.models import api

    cfg16 = dataclasses.replace(cfg, dtype="bfloat16", **fields)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    label = f"{arch} " + ", ".join(f"{k}={v}" for k, v in fields.items())
    p16 = api.init_params(cfg16, torch.Generator(device=dev).manual_seed(
        SEED + 1), dev)
    p32 = _to(p16, torch.float32)
    B = toks.shape[0]
    batch = {"tokens": toks}
    step32 = serve.make_prefill_step(cfg32)
    reset_all_counts()
    got = step32(p32, batch)
    n32 = all_counts()[0]["ssm_scan"]
    if n32 != _n_scans(cfg32):
        raise AssertionError(f"{label} fp32 prefill: {n32} launches")
    per_launch: list = []
    with plain_scan(check=per_launch):
        want = step32(p32, batch)
    if not max(per_launch) <= SCAN_FP32_TOL:
        raise AssertionError(f"{label} fp32 launches on the model's inputs: "
                             f"max row-relative |err| {max(per_launch)}")
    # the plain path's own fp32 rounding spread (the same prefill with the
    # plain scan at chunk 64 and at chunk 1, the step-by-step recurrence),
    # the reading tools/jax_scan_rounding_spread.py takes of the reference
    spread = 0.0
    for c in (64, 1):
        with plain_scan(chunk=c):
            spread = max(spread, float(
                (step32(p32, batch) - want).abs().max()))
    err32 = float((got - want).abs().max())
    if not err32 <= FP32_PREFILL_TOL:
        raise AssertionError(f"{label} fp32 kernel vs plain prefill: {err32} "
                             f"> {FP32_PREFILL_TOL}")
    short = toks[:, :128]
    full = step32(p32, {"tokens": short})
    cache = api.init_cache(cfg32, B, 128, dev)
    dec = []
    for t in range(128):
        lg, cache = api.decode_step(cfg32, p32, cache, short[:, t], t)
        dec.append(lg)
    err_dec = float((torch.stack(dec, 1) - full).abs().max())
    if not err_dec <= FP32_DECODE_TOL:
        raise AssertionError(f"{label} fp32 decode vs prefill: {err_dec} > "
                             f"{FP32_DECODE_TOL}")
    del cache, full, dec
    scale = float(want.abs().max())
    step16 = serve.make_prefill_step(cfg16)
    e_kernel = float((step16(p16, batch).float() - want).abs().max())
    with plain_scan():
        e_plain = float((step16(p16, batch).float() - want).abs().max())
    if not e_plain <= BF16_PLAIN_MAX * scale:
        raise AssertionError(f"{label} bf16 plain prefill {e_plain} from "
                             f"fp32: above {BF16_PLAIN_MAX} x {scale}")
    if not e_kernel <= LOGITS_KERNEL_VS_PLAIN * e_plain:
        raise AssertionError(f"{label} bf16 prefill vs fp32: kernel "
                             f"{e_kernel} > {LOGITS_KERNEL_VS_PLAIN} x "
                             f"{e_plain} (the plain scan's)")
    log(f"{label}, full width ({n32} scan launches): fp32 launches on the "
        f"model's inputs against the plain scan: max row-relative |err| "
        f"{max(per_launch)}; plain path's own rounding spread (chunk 64 and "
        f"1 against 128) {spread}; kernel vs plain prefill ({B}x512) max "
        f"|diff| {err32}; teacher-forced decode vs prefill ({B}x128) "
        f"{err_dec} (largest |logit| {scale}); bf16 prefill vs fp32: kernel "
        f"{e_kernel}, plain {e_plain}")
    del p16, p32, got, want
    torch.cuda.empty_cache()
    return {"config": label, "scan_launches": n32,
            "launch_err_fp32": max(per_launch),
            "fp32_rounding_spread": spread, "fp32_prefill_err": err32,
            "fp32_decode_err": err_dec, "logits_max_abs": scale,
            "bf16_err_vs_fp32": {"kernel": e_kernel, "plain": e_plain}}


def main() -> int:
    global OUT
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT, help="directory for the per-launch "
                    "times and the profiler trace (default: smoke_out/)")
    OUT = os.path.abspath(ap.parse_args().out)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda")
    card = smi()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}"
        f", {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(build.SOURCES)) as pool:   # one nvcc each
        built = dict(zip(build.SOURCES, pool.map(
            lambda name: build.compile_library(name, ["-Xptxas", "-v"]),
            build.SOURCES)))
    for name, (path, out) in built.items():
        log(f"built {os.path.relpath(path, ROOT)}")
        for line in out.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry")):
                log("  ptxas:", line.strip())
    log(f"built {len(built)} libraries in {time.perf_counter() - t0:.1f} s")
    sass = {name: sass_counts(path) for name, (path, _) in built.items()}
    for name, counts in sass.items():
        log(f"sass of {name}: " + json.dumps(counts))
    check_tensor_cores(sass)
    for mod in _kernel_ops():
        mod.library()
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    models = {name: prepare_model(name, dev)
              for name in ("googlenet", "resnet50")}
    log(f"calibrated and planned GoogLeNet-224 and ResNet50-224 on the card "
        f"in {time.perf_counter() - t0:.1f} s")
    checked = kernel_phase(models, dev)
    timing = timing_phase(models["googlenet"], dev)
    served = slice_phase(models, dev, card)
    tuned = tune_phase(models["googlenet"], dev, card)
    del models
    torch.cuda.empty_cache()
    flash_errs = flash_kernel_phase(dev)
    flash_t = flash_timing_phase(dev)
    lm = lm_slice_phase(dev, card)
    log(f"Granite-8B serving on {card}: " + json.dumps(lm))
    log(f"phases 2-5 took {time.perf_counter() - t_start:.1f} s")
    scan_errs = scan_kernel_phase(dev)
    scan_t = scan_timing_phase(dev)
    recurrent = {}
    for arch in ("xlstm-1.3b", "zamba2-1.2b"):
        t0 = time.perf_counter()
        recurrent[arch] = recurrent_slice_phase(arch, dev, card)
        log(f"{arch} serving on {card} ({time.perf_counter() - t0:.1f} s): "
            + json.dumps(recurrent[arch]))
    log(f"phases 2-7 took {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for name, replaces, cuda_kernels in (
            ("fused_chain",
             "src/repro/kernels/conv_fused/conv_fused.py:246",
             ["chain_kernel (conv stages on int8 mma.sync, staged weight "
              "panels)"]),
            ("fused_horizontal",
             "src/repro/kernels/conv_fused/conv_fused.py:333",
             ["horizontal_mma_kernel"])):
        t = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "kernels": cuda_kernels,
            "source": "src/repro_torch/kernels/conv_fused/csrc/conv_fused.cu",
            "replaces": replaces, "launches": served["launches"][name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bound_bytes_ms"] >= t["bound_ops_ms"]
                         else "operations"),
            "library_ms": t["library_ms"]})
    kernels[0].update({
        "tuned_ms_per_image": tuned["chain_ms_per_image"]["tuned"],
        "untuned_ms_per_image": tuned["chain_ms_per_image"]["untuned"],
        "tuned_vs_untuned": "chain_kernel device ms per GoogLeNet-224 image "
                            "in a profiled Session.run of the calibrated "
                            "strategy: with the tile search's records, "
                            "without, and forced to each chain's fastest "
                            "non-default candidate",
        "forced_ms_per_image": tuned["chain_ms_per_image"]["forced"],
        "tuned_launches": tuned["tile_records_applied"]})
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "kernels": ["flash_wgmma_kernel (bf16/fp16, d 64 and 128)",
                    "flash_kernel (fp32; d 16 and 32)"],
        "kernel_tensor_share_of_bf16_peak":
            flash_t["kernel_tensor_share_of_bf16_peak"],
        "replaces": FLASH_REPLACES,
        "launches": lm["launches"]["flash_attention"],
        "max_abs_err": flash_errs["granite prefill bfloat16"],
        "ms": flash_t["ms"], "plain_ms": flash_t["plain_ms"],
        "bound_ms": flash_t["bound_ms"],
        "bound_by": ("bytes" if flash_t["bound_bytes_ms"]
                     >= flash_t["bound_ops_ms"] else "operations"),
        "library_ms": flash_t["library_ms"]})
    xl = scan_t["xlstm-1.3b"]
    n_scan = recurrent["xlstm-1.3b"]["launches"]["ssm_scan"]
    kernels.append({
        "name": "ssm_scan", "route": "cuda", "source": SCAN_SOURCE,
        "kernels": ["scan_intra_kernel + scan_state_kernel (bf16, mma.sync "
                    "with hi/lo splits; the main path)",
                    "ssm_scan_kernel (fp32 and fp16, CUDA cores)"],
        "device_launches": {arch: recurrent[arch]["scan_device_launches"]
                            for arch in recurrent},
        "replaces": SCAN_REPLACES,
        "launches": n_scan,
        "max_abs_err": scan_errs["xlstm prefill bfloat16 slab 32"],
        "ms": xl["ms"], "plain_ms": xl["plain_ms"],
        "bound_ms": xl["bound_ms"],
        "bound_by": ("bytes" if xl["bound_bytes_ms"] >= xl["bound_ops_ms"]
                     else "operations"),
        "library_ms": None,
        "paths": {arch: {"launches": recurrent[arch]["launches"]["ssm_scan"],
                         "ms": scan_t[arch]["ms"],
                         "plain_ms": scan_t[arch]["plain_ms"],
                         "bound_ms": scan_t[arch]["bound_ms"]}
                  for arch in recurrent}})
    checked["artifact"] = served["artifact"]
    checked["tune"] = tuned
    checked["flash_max_abs_err"] = flash_errs
    checked["ssm_scan_err"] = scan_errs
    print(json.dumps({"kernels": kernels, "checked": checked,
                      "card": card}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
