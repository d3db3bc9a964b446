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
   pooling; chains of 10 and 12 stages whose one-pixel tiles reach past the
   input, so the card cuts their windows); ``fused_horizontal`` on all
   GoogLeNet-224 horizontal launches
   at batch 1 (split-K), 2 and 8, and on hand-made ragged launches (M not a
   multiple of the tile, N not a multiple of 8, K not a multiple of 32, a
   split-K case, IC = 3, 3x3 windows at stride 2 with padding).
   The chain kernel gets each launch's weights packed once
   (``prepare_launch``), as the executor passes them.  Each kernel is timed
   with CUDA events at the main path's shapes beside its plain version (and, for the horizontal 1x1 launches, ``torch._int_mm``
   at the same M, K, N as a yardstick the port never calls).
   At int32-extreme biases (within 2^20 of +-2^31) and shifts 1, 31, 32,
   33 and 40, hand-built chains (conv then elt) and horizontal launches.
   ``fused_conv_block`` (a conv, conv + max-pool, conv + eltwise through
   the chain kernel) against the same call on the CPU (its plain version).
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
   heads on 8 kv heads, d=128), SmolLM-360M's (15 on 5, d=64), a
   ``q_offset`` tail, a non-causal call and one rank's share of the TP = 2
   prefill of phase 13 (16 heads on 4) and Qwen2-VL-7B's (14 on 2); timed with CUDA events beside the plain version, the
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
   with stride 0), each at one TP = 2 rank's heads (2 and 16), a ragged
   S=200 and K != V; the bf16 route timed with
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
9. The serving plane, after phase 8 and with its profile, in a temporary
   directory: (a) GoogLeNet-224 and ResNet50-224 compiled into a
   ``ModelZoo`` by ``stages.compile_model(zoo=...)`` and reopened by a
   fresh stage cache with 0 stages compiled; (b) both served by one
   ``MultiServer`` on the card (GoogLeNet ``gold``, ResNet50
   ``best_effort``), 64 interleaved requests at once, each answer
   bit-equal to the tenant's own ``Session.run``, 42 + 9 kernel launches
   per GoogLeNet executor launch and 45 per ResNet50 one (counted through
   the sessions' launch hooks), no plain call, the DDR carve-up disjoint
   and within the ZU2 budget, each tenant's card memory beside its
   planned bytes; (c) a ``DriftProfiler`` on the GoogLeNet tenant
   (``every=16``), not drifted against the profile calibrated in phase 8
   and drifted against a copy with halved rates; (d) the OpenMetrics
   endpoint scraped over loopback mid-stream and strict-parsed
   (per-tenant requests, burn and drift gauges), ``/explain/googlenet``
   with its drift section, ``python -m repro_torch.obs.dump`` against it;
   (e) a tenant re-added with ``max_queue=4`` shedding a flood
   (``serve.rejected``), and a gold tenant at a 0.5 ms target firing a
   burn alert with a flight dump on disk; (f) a two-replica GoogLeNet-224
   ``Fleet`` on ``cuda:0`` under ``ChaosInjector``: r1 killed after 4
   launches in a 32-request burst (every answer bit-exact, r1 evicted with
   an event and a flight dump), healed and re-admitted by its canary, a
   poisoned r0 launch retried; the only failed attempts ``ChaosError``s,
   the kernel launches again 42 + 9 per executor launch; the fleet's
   images/s at 1 and 2 replicas (host clock).
14. Run right after phase 9: the paper's other CNNs and its second FPGA
    target (``ZOO_PLANS``): VGG16-224 (1,000 classes), ResNet152-224 and
    YOLO-lite-256 (at 224 its reorg meets a 7x7 map, which the reference
    cannot split either; 256 lowers the same plans), each planned under ZU2
    and ZU9, and GoogLeNet-224 and ResNet50-224 under ZU9, at batch 1.  A
    model is calibrated once on the card (its two plans share the
    ``QuantizedModel``).  Per plan: every
    distinct chain launch bit-equal to ``fused_chain_plain`` with its
    weights packed once, each call launching the kernel (YOLO-lite's
    10-stage ZU9 chain and VGG16's fc6 chain, c_in 25,088, named in the
    log); ``validate.bit_exact`` of the compiled session's program against
    ``ref``; kernel launches and ref-path nodes per image against the
    ``GroupProgram`` (no plain call); ``Session.run`` p50/p99 over 32 runs
    and a ``Server(max_batch=8)``'s images/s over 16 requests, each answer
    equal to ``Session.run`` (host clock); the image's chain launches back
    to back in CUDA events beside their bound, and VGG16's int8 TOP/s.

10. Seamless-m4t-large-v2 served at full width and depth (24 encoder and
    24 decoder layers, d_model 1024, d_ff 8192, vocab 256206, random bf16
    weights from seed 0; attention ``xla`` as in the reference, so no
    kernel): ``make_prefill_step`` on a 4x2048 prefill split by
    ``ENC_FRACTION["prefill"]`` (1792 frames, 256 tokens; no launch, no
    plain call), the ``serve`` loop (a 4x128 prompt, 32 greedy steps,
    ``api.init_cache``'s 4096-frame cross cache); at full width and 2+2
    layers in fp32, teacher-forced ``decode_step`` from a cache filled from
    ``encode``'s output against the prefill at 1e-3.
11. The scan's backward on the card (TF32 off): the kernels of
    ``ssm_scan_bw.cu`` on every route (bf16 on the tensor cores, fp32 and
    fp16) through ``ScanFunction`` at every ``BW_CASES`` shape (xLSTM-1.3B's
    and Zamba2-1.2B's at a 2x2048 training microbatch, Zamba2's q and k
    broadcast with stride 0; a rank's shapes of the TP = 2 prefills; a
    ragged S=200 and K != V): fp32 gradients against autograd through
    ``chunked_linear_scan`` and against ``ops.plain_backward`` (the same
    passes in plain torch) at ``BW_FP32_TOL``; bf16 and fp16 no farther from
    the fp32 ones than 1.25 times plain autograd and 1.25 times
    ``plain_backward`` in the same dtype; each call 1 forward launch and 1
    backward launch, no plain call; the kernels' gradient of the leaves
    timed at both model shapes beside ``kernel_backward`` alone, the plain
    autograd backward and the function's bound.
12. Training at full width: (a) Zamba2-1.2B, all 38 layers, bf16 params and
    moments, fp32 gradient buffers, ``make_train_step`` with
    ``grad_accum=2`` on ``SyntheticLM`` batches of 4x2048 for 8 steps
    (each step 152 scan launches and 76 backward launches: a forward,
    its remat recompute and a backward per layer and microbatch; no plain
    call), every loss finite, every gradient leaf finite and nonzero and
    each Mamba2 layer's ``w_in``, ``w_out``, ``w_bcdt`` and ``a_log``
    gradient nonzero, an async checkpoint at step 4 restored onto a
    ``meta`` template bit-equal leaf by leaf with the data cursor resumed,
    steps/s and tokens/s, one step profiled; (b) Seamless-m4t-large-v2, 2
    steps on 2x2048 (1024 frames, 1024 tokens), every gradient leaf finite
    and nonzero; (c) Zamba2 at full width and 1 layer with its shared
    block in fp32, one train step through the kernels against the same
    step with the plain scan under autograd, gradients and updated params
    at ``STEP_FP32_TOL``; (d) xLSTM-1.3B, all 48 layers (42 mLSTM, 6
    sLSTM), bf16, 2 steps on 2x2048 (each 84 scan launches and 42
    backward launches, no plain call), every loss finite, every gradient leaf
    finite and nonzero, each mLSTM layer's ``w_up``, ``w_qkg`` and
    ``w_down`` gradient nonzero.

13. The multi-device slice (``launch/mesh``, ``shard``, ``train`` with a
    mesh, ``checkpoint`` placements, ``distributed/elastic``), ranks spawned
    by ``launch.mesh.run_ranks``, rank r on ``cuda:{r % device_count}``,
    gloo where ranks share a card (NCCL refuses two ranks on one device),
    60 s per collective: (a) Granite-8B at full width and depth, seed-0
    bf16 weights placed by ``shard.param_specs`` on a (1, 2) mesh: the
    4x2048 flash prefill (36 launches a rank on 16 q / 4 kv heads, no plain
    call, only all-reduces issued), its logits no farther from phase 5's
    fp32 prefill than 1.25 times phase 5's unsharded flash prefill, argmax
    agreement with it, then the serve loop on a ``cache_specs``-sharded
    cache; at fp32 and 4 layers, against the unsharded model with plain
    attention: prefill within 1e-4, teacher-forced decode within 1e-4 and
    its tokens kept at every generated position whose top-2 margin is more
    than twice the distance, free-running greedy tokens equal up to their
    first parting, which must fall on such a near tie (its step, row,
    margin and distance are logged); (b) 4 layers at full width on (2, 2), a 4x2048
    batch, ``grad_accum=2``, ZeRO-1 moments: the unsharded step (rank 0,
    first, then freed), then ``grad_sync`` "auto", "late" and "late" with
    ``compress=True``, each within 5e-3 (loss) and rtol 5e-3 / atol 5e-4
    (params) of it; "late" at half of "auto"'s gradient all-reduce bytes
    over the data group; compressed gradients within 5% of the exact mean;
    (c) the late step on a (1, 1) NCCL mesh bit-equal to the unsharded
    step, ``compressed_psum`` bit-equal to ``quantize_ef``; (d) the (2, 2)
    state saved, ranks 2-3 lost, ``plan_mesh`` -> (1, 2), ``remesh`` over
    ranks 0-1, ``restore_latest(placements=)`` bit-equal leaf by leaf, one
    more step finite; the compressed step's state, whose int8 error
    feedback rides in ``opt["err"]``, restored the same way; host-clock
    times, per-rank peak memory and collective bytes by op, all with the
    ranks sharing one card.  Then every other family (``MESH_FAMILIES``),
    its unsharded references computed first in this process: at TP = 2 on
    (1, 2), a 4x2048 bf16 prefill and the serve loop of (e) Zamba2-1.2B
    at full depth (38 scan launches a rank on 16 heads, q and k at head
    stride 0; fp32 at one layer against the unsharded model within
    ``MESH_FP32_REL_TOL`` of the largest |logit|), (f) xLSTM-1.3B at full
    depth (42 launches a rank on 2 heads; one sLSTM block's loop timed on
    the mesh and alone), (g) Qwen2-VL-7B at full depth with patch
    embeddings (28 flash launches a rank on 14 q / 2 kv heads) and
    Seamless-m4t-large-v2 at full depth, (h) Mixtral-8x7B at 4 layers (4
    flash launches a rank on 16 / 4 heads; fp32 at two layers against the
    unsharded model, on flash and with plain attention, within
    ``MESH_FP32_REL_TOL`` of the largest |logit|): each without a plain call,
    its logits at every 8th position no farther from the fp32 prefill than
    1.25 times the unsharded bf16 prefill's; (i) one (2, 2)
    ``grad_sync="late"`` step (4x2048, ``grad_accum=2``) of Zamba2 at 6
    layers (24 scan launches and 12 backward launches a rank), Mixtral at 1
    and Qwen2-VL at 4: losses finite, every gradient leaf finite and
    nonzero.

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
import shutil
import subprocess
import sys
import time
from collections import Counter
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
    # one rank's heads in the TP = 2 prefills of phase 13 (Granite-8B's and
    # Mixtral-8x7B's: 16 on 4; Qwen2-VL-7B's: 14 on 2)
    "granite TP=2 rank prefill": (4, 2048, 2048, 16, 4, 128, 0, True),
    "qwen2-vl TP=2 rank prefill": (4, 2048, 2048, 14, 2, 128, 0, True),
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
# fused_conv_block cases (h, w, ic, oc, k, stride, pad, relu, shift, pool,
# eltwise ReLU or None): a conv, conv + max-pool, conv + eltwise
CONV_BLOCKS = [
    (12, 12, 8, 16, 3, 2, 1, True, 7, None, None),
    (9, 9, 3, 5, 3, 1, 0, True, 7, None, None),
    (14, 14, 8, 16, 3, 1, 1, True, 7, (3, 1), None),
    (10, 10, 4, 8, 3, 1, 1, True, 7, (2, 2), None),
    (8, 8, 4, 8, 3, 1, 1, False, 6, None, True),
]
# round_shift where the reference's int32 arithmetic wraps: biases within
# 2^20 of -2^31 and 2^31 - 1, shifts from 1 past 32
EXTREME_SHIFTS = (1, 31, 32, 33, 40)
# hand-built chains of 10 and 12 stages (tests/torch_common.py HAND_CHAINS):
# (chain, input (h, w, c), side (h, w, c) or None, oc), every conv to oc
# channels.  YOLO-lite's shape under ZU9 (conv/pool pairs from 3 channels)
# with a ragged tail; pairs with ceil-mode max and avg pools, a 1x1 conv and
# an eltwise add mid-chain, a dilated conv and a 1x1 conv as the tail.  At a
# one-pixel tile their windows reach past the input and the card cuts them.
LONG_HAND_CHAINS = [
    ((("conv", "c0", 3, 3, 1, 1, 1, 1, 1, 1, 8, True, 40, 36),
      ("pool", "p0", "max", 2, 2, 2, 2, 0, 0, 20, 18, 4),
      ("conv", "c1", 3, 3, 1, 1, 1, 1, 1, 1, 10, True, 20, 18),
      ("pool", "p1", "max", 2, 2, 2, 2, 0, 0, 10, 9, 4),
      ("conv", "c2", 3, 3, 1, 1, 1, 1, 1, 1, 10, True, 10, 9),
      ("pool", "p2", "max", 2, 2, 2, 2, 0, 0, 5, 5, 4),
      ("conv", "c3", 3, 3, 1, 1, 1, 1, 1, 1, 10, True, 5, 5),
      ("pool", "p3", "max", 3, 3, 2, 2, 1, 1, 3, 3, 9),
      ("conv", "c4", 3, 3, 1, 1, 1, 1, 1, 1, 10, False, 3, 3),
      ("pool", "p4", "avg", 2, 2, 1, 1, 0, 0, 2, 2, 4)),
     (40, 36, 3), None, 16),
    ((("conv", "c0", 3, 3, 1, 1, 1, 1, 1, 1, 10, True, 45, 39),
      ("pool", "p0", "max", 3, 3, 2, 2, 0, 0, 22, 19, 9),
      ("conv", "c1", 3, 3, 1, 1, 1, 1, 1, 1, 10, True, 22, 19),
      ("pool", "p1", "max", 2, 2, 2, 2, 0, 0, 11, 10, 4),
      ("conv", "c2", 3, 3, 1, 1, 1, 1, 1, 1, 10, True, 11, 10),
      ("pool", "p2", "avg", 2, 2, 2, 2, 0, 0, 6, 5, 4),
      ("conv", "c3", 1, 1, 1, 1, 0, 0, 1, 1, 9, False, 6, 5),
      ("elt", "e0", 1, -1, True, 6, 5),
      ("pool", "p3", "max", 2, 2, 2, 2, 0, 0, 3, 3, 4),
      ("conv", "c4", 3, 3, 1, 1, 2, 2, 2, 2, 10, True, 3, 3),
      ("pool", "p4", "max", 2, 2, 1, 1, 0, 0, 2, 2, 4),
      ("conv", "c5", 1, 1, 1, 1, 0, 0, 1, 1, 9, True, 2, 2)),
     (45, 39, 8), (6, 5, 16), 16),
]
SCAN_REPLACES = "src/repro/kernels/ssm_scan/ssm_scan.py:49"
SCAN_SOURCE = "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu"
SCAN_BW_SOURCE = "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan_bw.cu"
# (b, s, h, k, v, q and k broadcast over the heads) of the scan checks
XLSTM_SCAN = (4, 2048, 4, 1024, 1024, False)
ZAMBA_SCAN = (4, 2048, 32, 64, 128, True)
SCAN_CASES = {
    "xlstm prefill": XLSTM_SCAN,
    "zamba2 prefill": ZAMBA_SCAN,
    "ragged S=200": (4, 200, 4, 64, 96, False),
    "K != V": (2, 256, 2, 40, 24, False),
    # one rank's heads in the TP = 2 prefills of phase 13
    "xlstm TP=2 rank prefill": (4, 2048, 2, 1024, 1024, False),
    "zamba2 TP=2 rank prefill": (4, 2048, 16, 64, 128, True),
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
    ("ssm_scan", "scan_state_kernel", "HMMA"),
    ("ssm_scan_bw", "scan_intra_kernel", "HMMA"),
    ("ssm_scan_bw", "scan_state_kernel", "HMMA")]


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
def prepare_model(name: str, dev, img: int | None = None):
    """Graph, float params, calibrated QuantizedModel, strategy and
    quantized program (under ZU2) of one model at ``img`` (None: ``IMG``)."""
    from functools import partial

    from repro_torch.cnn import build, init_params
    from repro_torch.core import lower, pathsearch, quantize
    from repro_torch.core.executor import run_float
    from repro_torch.hw import ZU2

    img = img or IMG
    g = build(name, img=img)
    params = init_params(g, seed=SEED)
    x = np.random.default_rng(SEED).standard_normal(
        g.shape("data")).astype(np.float32)
    qm = quantize.calibrate(g, params, x, partial(run_float, device=dev))
    strategy = pathsearch.search(g, ZU2)
    prog = lower.lower_strategy(g, strategy, qm)
    return {"g": g, "params": params, "x": x, "qm": qm,
            "strategy": strategy, "program": prog, "img": img}


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
    negative shifts, an elt side with its own shift, dilation, gap; a conv
    with biases near the int32 extremes then an elt stage, at each of
    ``EXTREME_SHIFTS`` (the elt side shifted left by as much); and the 10-
    and 12-stage chains of ``LONG_HAND_CHAINS``."""
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
    for chain, (h, w, c), side, oc in LONG_HAND_CHAINS:
        ws, bs, cin = [], [], c
        for st in chain:
            if st[0] == "conv":
                ws.append(rand_int8((st[2], st[3], cin, oc), gen, dev))
                bs.append(torch.randint(-3000, 3000, (oc,), generator=gen,
                                        dtype=torch.int32).to(dev))
                cin = oc
        last = chain[-1]
        oh, ow = last[12:14] if last[0] == "conv" else last[9:11]
        out.append(((rand_int8((2, h, w, c), gen, dev), tuple(ws), tuple(bs),
                     (rand_int8((2,) + side, gen, dev),) if side else ()),
                    dict(chain=chain, oh=oh, ow=ow, oc=oc)))
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
    n_block = 0
    for h, w, ic, oc, k, st, pd, relu, shift, pool, elt in CONV_BLOCKS:
        x = rand_int8((2, h, w, ic), gen, dev)
        wt = rand_int8((k, k, ic, oc), gen, dev)
        b = torch.randint(-2000, 2000, (oc,), generator=gen,
                          dtype=torch.int32).to(dev)
        oh = (h + 2 * pd - k) // st + 1
        eltwise = None if elt is None else (
            rand_int8((2, oh, (w + 2 * pd - k) // st + 1, oc), gen, dev), 1,
            2, elt)
        kw = dict(stride=(st, st), pad=(pd, pd), shift=shift, relu=relu,
                  pool=pool, eltwise=eltwise)
        before = ops.LAUNCHES["fused_chain"]
        got = ops.fused_conv_block(x, wt, b, **kw)
        if ops.LAUNCHES["fused_chain"] != before + 1:
            raise AssertionError("fused_conv_block did not launch the chain "
                                 "kernel")
        plain_kw = dict(kw, eltwise=eltwise and (eltwise[0].cpu(),
                                                 *eltwise[1:]))
        want = ops.fused_conv_block(x.cpu(), wt.cpu(), b.cpu(), **plain_kw)
        check_equal(got, want.to(dev),
                    f"fused_conv_block {(h, w, ic, oc, k, st, pd, pool, elt)}")
        n_block += 1
    log(f"fused_conv_block (the chain kernel) == plain on {n_block} conv, "
        f"conv+max-pool and conv+eltwise blocks")
    return {"chain_launches": n_chain, "tiles": n_tiles, "hand": n_hand,
            "horizontal_launches": n_horiz, "horizontal_ragged": n_ragged,
            "conv_blocks": n_block}


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


def kernel_means(path: str) -> dict:
    """Per kernel (its name with template arguments) of a trace saved by
    ``profile_device``: the mean device ms of its events and their count.
    A mean stays right where the trace lacks some of a kernel's events."""
    with open(path) as f:
        events = json.load(f)
    events = events.get("traceEvents", events)
    durs: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            durs.setdefault(e["name"].split("(")[0], []).append(e["dur"])
    return {name: {"mean_ms": sum(d) / len(d) / 1e3, "events": len(d)}
            for name, d in durs.items()}


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
    launches, plain = conv_launches(), dict(ops.PLAIN_CALLS)
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
    per_image = conv_launches()
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
    launches = conv_launches()            # ---- main path ends here
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
        launches, plain = conv_launches(), dict(ops.PLAIN_CALLS)
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
    return {"profile": prof,
            "rows": rep["n_samples"], "deviation": rep["deviation"],
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


# ----------------------------------------------------------------- phase 9
GOOGLENET_LAUNCHES = {"fused_chain": 42, "fused_horizontal": 9}
RESNET50_LAUNCHES = {"fused_chain": 45, "fused_horizontal": 0}


def count_launches(session, counter: dict, key: str) -> None:
    """Count ``session``'s executor launches under ``counter[key]`` through
    its launch hook (keeping any hook already installed, such as the chaos
    injector's): a launch whose hook raised never reached the executor and
    is not counted."""
    inner = session._launch_hook
    counter.setdefault(key, 0)

    def hook(x):
        if inner is not None:
            inner(x)
        counter[key] += 1

    session.set_launch_hook(hook)


def check_kernel_launches(counter: dict, per_launch: dict, what: str
                          ) -> dict:
    """The conv kernels' launches since the last reset equal each counted
    executor launch's own (42 + 9 per GoogLeNet-224 launch, 45 per
    ResNet50-224 launch), and no plain conv call ran."""
    from repro_torch.kernels.conv_fused import ops

    torch.cuda.synchronize()
    want = {k: sum(counter[name] * per_launch[name][k] for name in counter)
            for k in ("fused_chain", "fused_horizontal")}
    got, plain = conv_launches(), dict(ops.PLAIN_CALLS)
    if got != want or any(plain.values()):
        raise AssertionError(f"{what}: kernel launches {got} for executor "
                             f"launches {counter} (want {want}), plain "
                             f"calls {plain}")
    return got


def quantized_images(m, n: int, seed: int) -> list:
    from repro_torch.core import quantize

    rng = np.random.default_rng(seed)
    return [quantize.quantize_to(rng.standard_normal(m["g"].shape(
        "data")[1:]), m["qm"].f_a["data"]) for _ in range(n)]


def zoo_phase(models, zoo) -> tuple:
    """(a) Both models compiled into the zoo, then reopened by a fresh
    stage cache with no stage past ``wrap`` compiled."""
    from repro_torch import stages
    from repro_torch.hw import ZU2
    from repro_torch.obs.metrics import MetricsRegistry

    out, compiled = {}, {}
    for name in ("googlenet", "resnet50"):
        m = models[name]
        co, put_s = timed(lambda: stages.compile_model(
            m["g"], m["qm"], ZU2, zoo=zoo, name=name,
            cache=stages.StageCache(registry=MetricsRegistry())))
        reg = MetricsRegistry()
        again, open_s = timed(lambda: stages.compile_model(
            m["g"], m["qm"], ZU2, zoo=zoo,
            cache=stages.StageCache(registry=reg)))
        misses = _counts(reg)
        if again.key != co.key or any(misses[st] for st in
                                      ("lowered", "planned", "compiled")):
            raise AssertionError(f"{name}: zoo reopen compiled stages "
                                 f"{misses} (keys {co.key} / {again.key})")
        out[name] = {"compile_and_put_s": put_s, "reopen_s": open_s,
                     "stage_misses_on_reopen": misses}
        compiled[name] = again
    recs = {r["name"]: r for r in zoo.list()}
    for name in out:
        out[name]["bytes_on_disk"] = recs[name]["size_bytes"]
    return compiled, out


def multitenant_phase(compiled, models, prof, flight, dev) -> dict:
    """(b)-(e): both tenants on one MultiServer, drift on GoogLeNet, the
    scrape endpoint, admission and the SLO burn alert."""
    import dataclasses
    import urllib.request

    from repro_torch.obs import DriftProfiler, MetricsRegistry
    from repro_torch.obs.export import find_samples, parse_openmetrics
    from repro_torch.obs.metrics import REGISTRY
    from repro_torch.kernels.conv_fused import ops
    from repro_torch.runtime import AdmissionError, MultiServer

    res = {}
    ms = MultiServer(flight=flight)
    per_launch = {"googlenet": GOOGLENET_LAUNCHES,
                  "resnet50": RESNET50_LAUNCHES}
    # (b) the two tenants, the card's memory beside the planned bytes
    memory = {}
    for name, slo in (("googlenet", "gold"), ("resnet50", "best_effort")):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        ms.add_model(name, compiled[name], slo=slo,
                     session_kw={"device": dev})
        torch.cuda.synchronize()
        memory[name] = {
            "card_bytes_allocated": torch.cuda.memory_allocated(dev) - before,
            "planned_ddr_bytes": ms.ddr_partition()[-1]["bytes"]}
    sessions = {name: ms._models[name]["session"] for name in per_launch}
    parts = ms.ddr_partition()
    budget = ms.stats()["ddr_budget_bytes"]
    if parts[0]["base"] != 0 or parts[1]["base"] != parts[0]["bytes"] or \
            sum(p["bytes"] for p in parts) > budget:
        raise AssertionError(f"DDR partition {parts} within {budget}")
    imgs = {name: quantized_images(models[name], 8, SEED + 9 + i)
            for i, name in enumerate(per_launch)}
    stream = [("resnet50" if i % 4 == 3 else "googlenet") for i in range(64)]
    counter: dict = {}
    for name, sess in sessions.items():
        count_launches(sess, counter, name)
    ops.reset_counts()                   # ---- multi-tenant path starts
    t0 = time.perf_counter()
    futs = [(name, i, ms.submit(name, imgs[name][i % 8]))
            for i, name in enumerate(stream)]
    answers = [(name, i, f.result(timeout=300)) for name, i, f in futs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = check_kernel_launches(counter, per_launch,
                                     "multi-tenant stream")
    # ---- multi-tenant path ends
    st = ms.stats()
    for name, sess in sessions.items():
        sess.set_launch_hook(None)
    for name, i, got in answers:
        outputs_equal(got, sessions[name].run(imgs[name][i % 8]),
                      f"{name} tenant answer {i}")
    res["multitenant"] = {
        "requests": {"googlenet": stream.count("googlenet"),
                     "resnet50": stream.count("resnet50")},
        "images_per_s": len(stream) / wall,
        "executor_launches": dict(counter), "kernel_launches": launches,
        "per_tenant": {name: {k: st["models"][name][k] for k in
                              ("p50_ms", "p99_ms", "n_batches",
                               "effective_max_batch", "slo_shrinks")}
                       for name in sessions},
        "ddr_partition": parts, "ddr_budget_bytes": budget,
        "memory": memory}
    log("MultiServer on the card, 64 requests (48 GoogLeNet-224 gold, 16 "
        "ResNet50-224 best_effort), every answer == the tenant's "
        "Session.run; host clock; card bytes allocated beside the ZU2 "
        "plan's DDR bytes (not the same quantity): "
        + json.dumps(res["multitenant"]))

    # (c) drift on the GoogLeNet tenant against the tune phase's profile
    dp = ms.attach_drift("googlenet", profile=prof, every=16)
    _, prep_s = timed(dp.prepare)
    g_img = imgs["googlenet"]
    for i in range(16):                  # 16 launches: one sampling pass
        ms.submit("googlenet", g_img[i % 8]).result(timeout=300)
    if dp.n_sampled != 1:
        raise AssertionError(f"drift sampled {dp.n_sampled} times over 16 "
                             f"served launches (every=16)")
    _, pass_s = timed(dp.sample)
    rep = dp.report()
    halved = dataclasses.replace(prof, coef=tuple(2 * c for c in prof.coef))
    bad = DriftProfiler.from_session(sessions["googlenet"], profile=halved,
                                     registry=MetricsRegistry())
    bad.sample()
    bad_rep = bad.report()
    if rep.drifted or not bad_rep.drifted:
        raise AssertionError(
            f"drift under the card's own profile {rep.drifted} (aggregate "
            f"{rep.aggregate}, band {rep.band}); under halved rates "
            f"{bad_rep.drifted} (aggregate {bad_rep.aggregate})")
    by_kind: dict = {}
    for u in rep.units:
        by_kind.setdefault(u.kind, []).append(abs(u.deviation))
    res["drift"] = {
        "drifted": rep.drifted, "aggregate_deviation": rep.aggregate,
        "band": rep.band, "profile_deviation": rep.profile_deviation,
        "units_sampled": len(rep.units), "units_skipped": len(rep.skipped),
        "median_abs_deviation_by_kind": {
            k: float(np.median(v)) for k, v in by_kind.items()},
        "sampling_pass_s": pass_s, "prepare_s": prep_s,
        "halved_rates": {"drifted": bad_rep.drifted,
                         "aggregate_deviation": bad_rep.aggregate}}
    log("drift on the GoogLeNet-224 tenant (CUDA-event device time per "
        "unit against the tune phase's profile): " + json.dumps(res["drift"]))

    # (d) the scrape endpoint mid-run, and the dump CLI against it
    http = ms.serve_metrics()
    futs = [ms.submit(name, imgs[name][i % 8])
            for i, name in enumerate(stream[:32])]
    text, scrape_s = timed(lambda: urllib.request.urlopen(
        http.url("/metrics"), timeout=30).read().decode())
    in_flight = sum(not f.done() for f in futs)
    [f.result(timeout=300) for f in futs]
    fams = parse_openmetrics(text)
    needed = [("serve_requests", {"model": "googlenet"}),
              ("serve_requests", {"model": "resnet50"}),
              ("slo_burn_rate", {"model": "googlenet", "window": "fast"}),
              ("drift_median_deviation", {"model": "googlenet"}),
              ("drift_tripped", {"model": "googlenet"})]
    for fam, labels in needed:
        if not find_samples(fams, fam, **labels):
            raise AssertionError(f"scrape lacks {fam}{labels}")
    explain = json.loads(urllib.request.urlopen(
        http.url("/explain/googlenet"), timeout=30).read().decode())
    if "drift" not in explain or not explain["drift"]["units"]:
        raise AssertionError("/explain/googlenet has no drift section")
    snap_path = os.path.join(OUT, "serve_snapshot.json")
    dump = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.dump", "--url",
         http.url("/").rstrip("/"), "--out", snap_path],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    if dump.returncode != 0:
        raise AssertionError(f"repro_torch.obs.dump: {dump.stderr[-2000:]}")
    with open(snap_path) as f:
        snap = json.load(f)
    res["export"] = {"scrape_ms": 1e3 * scrape_s,
                     "requests_in_flight_at_scrape": in_flight,
                     "families": len(fams), "bytes": len(text),
                     "dump_families": snap["n_families"],
                     "explain_drift_units": len(explain["drift"]["units"])}
    log("OpenMetrics scrape of the MultiServer over loopback (strict parse, "
        "host clock): " + json.dumps(res["export"]))

    # (e) admission control and the SLO burn alert
    ms.remove_model("resnet50")
    ms.add_model("resnet50", compiled["resnet50"], max_queue=4,
                 session_kw={"device": dev})
    key = "serve.rejected{model=resnet50}"
    before = REGISTRY.get(key).value if REGISTRY.get(key) else 0.0
    accepted, shed = [], 0
    for i in range(64):
        try:
            accepted.append(ms.submit("resnet50", imgs["resnet50"][i % 8]))
        except AdmissionError:
            shed += 1
    [f.result(timeout=300) for f in accepted]
    if not shed or REGISTRY.get(key).value - before != shed:
        raise AssertionError(f"{shed} requests shed, serve.rejected moved "
                             f"{REGISTRY.get(key).value - before}")
    ms.add_model("googlenet_tight", compiled["googlenet"], slo="gold",
                 target_p99_ms=0.5, session_kw={"device": dev})
    for i in range(12):
        ms.submit("googlenet_tight", g_img[i % 8]).result(timeout=300)
    burn = ms.stats()["burn"]["googlenet_tight"]
    tight = [d for d in flight.dumps() if d["reason"] == "slo_violation"
             and d["tenant"] == "googlenet_tight"]
    alerts = REGISTRY.get("slo.alerts{class=gold,model=googlenet_tight}")
    if not alerts or not tight or not os.path.exists(tight[-1]["path"]):
        raise AssertionError(f"no burn alert or flight dump for a 0.5 ms "
                             f"target: burn {burn}, dumps {len(tight)}")
    res["admission"] = {"submitted": 64, "shed": shed,
                        "accepted": len(accepted)}
    res["slo"] = {"target_p99_ms": 0.5, "burn": burn,
                  "alerts": alerts.value, "dump": os.path.basename(
                      tight[-1]["path"]),
                  "dump_records": len(tight[-1]["records"])}
    log("admission and SLO burn on the card: " + json.dumps(
        {"admission": res["admission"], "slo": res["slo"]}))
    ms.close()
    return res


def wait_quiet(fleet, timeout_s: float = 30.0) -> None:
    """Until no request, unanswered probe or strike is open on any replica
    for three monitor ticks in a row: the kernels' counts are then
    final."""
    t0, calm = time.perf_counter(), 0
    while calm < 3:
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"fleet not quiet: {fleet.stats()}")
        st = fleet.stats()
        quiet = st["pending"] == 0 and all(
            (r.probe is None or r.probe[0].done()) and r.strikes == 0
            and not r.inflight and r.server.pending == 0
            for r in fleet.replicas().values())
        calm = calm + 1 if quiet else 0
        time.sleep(fleet.check_interval_s)
    torch.cuda.synchronize()


def fleet_phase(art, want_imgs, want_outs, dump_dir, card0) -> dict:
    """(f) A two-replica GoogLeNet-224 fleet on the one card ``card0``
    under chaos."""
    from repro_torch.obs.events import EventLog
    from repro_torch.obs.flight import FlightRecorder
    from repro_torch.obs.metrics import MetricsRegistry
    from repro_torch.kernels.conv_fused import ops
    from repro_torch.runtime import ChaosInjector, Fleet

    per_launch = {"r0": GOOGLENET_LAUNCHES, "r1": GOOGLENET_LAUNCHES}
    imgs = want_imgs

    def burst(fleet, n=32):
        t0 = time.perf_counter()
        outs = [f.result(timeout=300) for f in
                [fleet.submit(imgs[i % len(imgs)]) for i in range(n)]]
        torch.cuda.synchronize()
        for i, got in enumerate(outs):
            outputs_equal(got, want_outs[i % len(imgs)], f"fleet answer {i}")
        return n / (time.perf_counter() - t0)

    rates = {}
    for n_rep in (1, 2):
        with Fleet(art, n_replicas=n_rep, devices=[card0],
                   registry=MetricsRegistry(), events=EventLog()) as fl:
            burst(fl, 8)                   # first batches of each size
            rates[n_rep] = burst(fl)
    log(f"fleet images/s on one card (host-bound; 32 requests at once): 1 "
        f"replica {rates[1]:.1f}, 2 replicas {rates[2]:.1f}")

    # batches of at most 2, so each replica launches at least 8 times in a
    # 32-request burst and r1's kill (after 4 healthy launches) fires
    events = EventLog()
    flight = FlightRecorder(dump_dir=dump_dir, events=events)
    fleet = Fleet(art, n_replicas=2, devices=[card0], flight=flight,
                  events=events, registry=MetricsRegistry(),
                  server_kw={"max_batch": 2})
    chaos = ChaosInjector().attach(fleet)
    counter: dict = {}
    for rid, r in fleet.replicas().items():
        count_launches(r.session, counter, rid)
    try:
        ops.reset_counts()               # ---- fleet path starts
        chaos.kill("r1", after_launches=4)
        burst(fleet)
        t0 = time.perf_counter()
        while "r1" in fleet.active_replicas():
            if time.perf_counter() - t0 > 30:
                raise AssertionError("r1 was not evicted after its kill")
            time.sleep(0.01)
        evicts = [e for e in events.records(kind="replica.evict")
                  if e.fields["replica"] == "r1"]
        dumps = [d for d in flight.dumps() if d["reason"] == "replica_evict"]
        if not evicts or not dumps or not os.path.exists(dumps[-1]["path"]):
            raise AssertionError("no replica.evict event or flight dump")
        chaos.heal("r1")
        if not fleet.wait_active("r1", timeout_s=60):
            raise AssertionError("r1 was not re-admitted after heal")
        canary = fleet.replicas()["r1"].session._launch(fleet._canary_x)
        if not fleet._canary_ok(canary):
            raise AssertionError("r1's canary != r0's on the card")
        chaos.poison("r0", 1)
        burst(fleet, 16)
        wait_quiet(fleet)
        launches = check_kernel_launches(counter, per_launch,
                                         "fleet under chaos")
        # ---- fleet path ends
        st = fleet.stats()
    finally:
        chaos.heal_all()
        fleet.close()
    errors = [r for r in flight.records() if r.status == "error"]
    if not errors or any(not r.error.startswith("ChaosError")
                         for r in errors):
        raise AssertionError("failed fleet attempts that were not injected: "
                             + json.dumps(sorted({r.error for r in errors})))
    if chaos.fired("poison") != 1 or not chaos.fired("kill"):
        raise AssertionError(f"chaos log {chaos.log}")
    res = {"images_per_s": {"1_replica": rates[1], "2_replicas": rates[2]},
           "requests": 48, "retries": st["retries"],
           "failed_attempts": len(errors),
           "evictions": {r: s["evictions"] for r, s in
                         st["replicas"].items()},
           "admissions": {r: s["admissions"] for r, s in
                          st["replicas"].items()},
           "evict_reason": evicts[0].fields["reason"],
           "duplicates_suppressed": st["duplicates_suppressed"],
           "chaos_fired": {k: chaos.fired(k) for k in ("kill", "poison")},
           "executor_launches": dict(counter), "kernel_launches": launches,
           "flight_dump": os.path.basename(dumps[-1]["path"])}
    log("fleet of 2 GoogLeNet-224 replicas on one card under chaos, every "
        "answer bit-exact, only ChaosErrors failed: " + json.dumps(res))
    return res


def serving_phase(models, prof, dev, card: str) -> dict:
    """The serving plane on the card (phase 9)."""
    import tempfile

    from repro_torch.zoo import ModelZoo

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="dnnvm-serve-") as tmp:
        from repro_torch.obs.flight import FlightRecorder

        compiled, zoo_res = zoo_phase(models, ModelZoo(
            os.path.join(tmp, "zoo")))
        log(f"model zoo on {card} (host seconds): " + json.dumps(zoo_res))
        flight = FlightRecorder(dump_dir=os.path.join(tmp, "flight"),
                                min_interval_s=0.5)
        fleet_imgs = quantized_images(models["googlenet"], 8, SEED + 12)
        res = multitenant_phase(compiled, models, prof, flight, dev)
        sess = compiled["googlenet"].session(device=dev)
        fleet_outs = [sess.run(x) for x in fleet_imgs]
        res["fleet"] = fleet_phase(compiled["googlenet"].artifact,
                                   fleet_imgs, fleet_outs,
                                   os.path.join(tmp, "fleet"),
                                   torch.device("cuda", 0))
        res["zoo"] = zoo_res
    res["seconds"] = time.perf_counter() - t_phase
    log(f"serving phase took {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------- phase 14
# The paper's other CNNs and its second FPGA target: each (model, planning
# target) not served above, at 224 and batch 1.  A model is calibrated once
# on the card and its two plans share the QuantizedModel.  YOLO-lite runs
# at 256: at 224 its reorg meets a 7x7 map, which neither package can
# split in two (the reference's int8_ops.reorg fails on the same reshape);
# at 256 it lowers the same plans (an 8-stage chain and two single stages
# under ZU2, one 10-stage chain under ZU9).
ZOO_IMG = {"yolo_lite": 256}
ZOO_PLANS = [("vgg16", "ZU2"), ("vgg16", "ZU9"), ("resnet152", "ZU2"),
             ("resnet152", "ZU9"), ("yolo_lite", "ZU2"), ("yolo_lite", "ZU9"),
             ("googlenet", "ZU9"), ("resnet50", "ZU9")]
ZOO_REQUESTS = 16        # images served by Session.run and by the Server
ZOO_REPS = 5             # CUDA-event repetitions of an image's chain launches


def named_chain(launch, g) -> str | None:
    """What a chain launch is called in the log where it is one the slice
    names: a chain of 8 stages or more, or an fc lowered as a chain on a
    flattened input of more than 4,096 values (VGG16's fc6)."""
    nodes = "+".join(launch.nodes)
    if len(launch.stages) >= 8:
        return f"{len(launch.stages)}-stage chain {nodes}"
    c_in = int(np.prod(g.shape(launch.in_name)[1:]))
    if launch.fc_reshape and c_in > 4096:
        return f"fc chain {nodes} (c_in {c_in})"
    return None


def count_ref_nodes() -> tuple:
    """A counter of the nodes the executor runs on its ref path (its
    fallbacks), and the function that undoes the count."""
    from repro_torch.core import executor

    inner = executor._int8_node
    counter = {"nodes": 0}

    def counted(*a, **kw):
        counter["nodes"] += 1
        return inner(*a, **kw)

    executor._int8_node = counted
    return counter, lambda: setattr(executor, "_int8_node", inner)


def zoo_plan(name, target, m, gen, dev, card) -> dict:
    """One (model, target) plan on the card: every distinct chain launch
    against the plain version, the compiled session against ``ref``
    (``validate.bit_exact``), launches and fallbacks per image against the
    program, ``Session.run`` p50/p99, ``Server`` images/s, and the chain
    kernel's device ms per image beside its bound."""
    from repro_torch import hw
    from repro_torch.core import lower, pathsearch, quantize, validate
    from repro_torch.kernels.conv_fused import ops
    from repro_torch.runtime import Session

    g, qm = m["g"], m["qm"]
    what = f"{name}-{m['img']} under {target}"
    plan_dev = getattr(hw, target)
    s = pathsearch.search(g, plan_dev)
    prog = lower.lower_strategy(g, s, qm)
    chains = [lc for lc in prog.launches() if lc.kind == "chain"]
    want_launches = {"fused_chain": len(chains),
                     "fused_horizontal": len(prog.launches()) - len(chains)}
    want_ref_nodes = sum(len(fb.nodes) for fb in prog.fallbacks())
    # every distinct chain launch against its plain version, weights packed
    # once as the executor passes them; each call must launch the kernel
    seen, named = set(), []
    for launch in chains:
        key = (launch.stages, tuple(g.shape(launch.in_name)))
        if key in seen:
            continue
        seen.add(key)
        prep = ops.prepare_launch(launch, qm, dev)
        args, kw = chain_args(launch, g, prep, gen, dev)
        want = ops.fused_chain_plain(*args, **kw)
        before = ops.LAUNCHES["fused_chain"]
        got = ops.fused_chain(*args, **kw, packed=prep["packed"])
        if ops.LAUNCHES["fused_chain"] != before + 1:
            raise AssertionError(f"{what}: chain {launch.nodes} did not "
                                 f"launch the kernel")
        check_equal(got, want, f"{what}: chain {launch.nodes}")
        label = named_chain(launch, g)
        if label:
            named.append(label)
    log(f"phase 14, {what}: fused_chain == plain on "
        f"{len(seen)} distinct chain launches, the kernel launched for "
        f"each; among them {named or 'none named'}")
    served = (served_batch_check(chains, g, qm, gen, dev, what)
              if (name, target) == ("vgg16", "ZU2") else None)

    xq = quantize.quantize_to(m["x"], qm.f_a["data"])
    imgs = quantized_images(m, ZOO_REQUESTS, SEED + 14)
    sess, compile_s = timed(lambda: Session(g, s, plan_dev, qm, device=dev))
    rep = validate.bit_exact(g, qm, xq, sess.artifact, device=dev)
    if not rep.bit_exact:
        raise AssertionError(f"{what}: fused != ref on the card (max "
                             f"|diff| {rep.max_abs_diff})")
    ref_nodes, undo = count_ref_nodes()
    try:
        ops.reset_counts()                  # ---- main path starts here
        out = sess.run(imgs[0])
        torch.cuda.synchronize()
        per_image, plain = conv_launches(), dict(ops.PLAIN_CALLS)
        # ---- main path ends here
    finally:
        undo()
    if (per_image != want_launches or any(plain.values())
            or ref_nodes["nodes"] != want_ref_nodes):
        raise AssertionError(
            f"{what}: launches per image {per_image} (program "
            f"{want_launches}), ref-path nodes {ref_nodes['nodes']} (program "
            f"{want_ref_nodes}), plain calls {plain}")
    for k, v in out.items():
        if not (v.device.type == dev.type
                and bool(torch.isfinite(v.float()).all())):
            raise AssertionError(f"{what}: output {k} {v}")
    lat = []
    for _ in range(2):
        for x in imgs:
            t0 = time.perf_counter()
            sess.run(x)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
    lat.sort()
    server = sess.serve(max_batch=8, max_latency_s=5e-3)
    t0 = time.perf_counter()
    futs = [server.submit(x) for x in imgs]
    answers = [f.result(timeout=300) for f in futs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = server.stats()
    server.close()
    for i, (x, ans) in enumerate(zip(imgs, answers)):
        outputs_equal(ans, sess.run(x), f"{what}: server answer {i}")
    # the chain kernel over one image's chain launches, back to back
    runs, nbytes, macs, bound = [], 0, 0, 0.0
    for launch in chains:
        prep = ops.prepare_launch(launch, qm, dev)
        args, kw = chain_args(launch, g, prep, gen, dev)
        runs.append((args, kw, prep["packed"]))
        b, mc = chain_work(launch, args, kw)
        nbytes, macs = nbytes + b, macs + mc
        bound += max(1e3 * b / MEM_BW, 1e3 * 2 * mc / INT8_PEAK)

    def image():
        for args, kw, pk in runs:
            ops.fused_chain(*args, **kw, packed=pk)
    chain_ms = device_ms(image, reps=ZOO_REPS)
    res = {"card": card, "launches_per_image": per_image,
           "fallbacks_per_image": len(prog.fallbacks()),
           "ref_path_nodes_per_image": ref_nodes["nodes"],
           "chain_lengths": {str(k): v for k, v in sorted(
               Counter(len(lc.stages) for lc in chains).items())},
           "named_chains": named, "distinct_chains_checked": len(seen),
           "bit_exact": rep.bit_exact, "compile_s": compile_s,
           "run_p50_ms": 1e3 * lat[len(lat) // 2],
           "run_p99_ms": 1e3 * lat[min(len(lat) - 1, int(0.99 * len(lat)))],
           "server_images_per_s": ZOO_REQUESTS / wall,
           "server_batches": stats["batch_histogram"],
           "chain_ms_per_image": chain_ms, "chain_bound_ms": bound,
           "chain_bound_by": ("bytes" if nbytes / MEM_BW
                              >= 2 * macs / INT8_PEAK else "operations"),
           "chain_bytes": nbytes, "chain_macs": macs}
    if served:
        res["served_batch"] = served
    if name == "vgg16":
        res["int8_gop_per_image"] = 2 * macs / 1e9
        res["int8_top_per_s"] = 2 * macs / (chain_ms * 1e-3) / 1e12
    return res


SERVED_BATCH = 64    # the batch vgg16-224.zu2.offline-q128 serves


def served_batch_check(chains, g, qm, gen, dev, what: str) -> dict:
    """Every chain launch of the plan at the benchmark's served batch, at
    the chooser's tile there (blocks of several images, ragged groups,
    ring stages), against the plain version on the same inputs; some
    launch must take more than one image a block and some conv stage must
    run through the weight ring."""
    from repro_torch.kernels.conv_fused import ops

    n, rings, tiles = SERVED_BATCH, 0, []
    for launch in chains:
        prep = ops.prepare_launch(launch, qm, dev)
        args, kw = chain_args(launch, g, prep, gen, dev, n=n)
        in_shape = (n,) + tuple(g.shape(launch.in_name)[1:])
        oh, ow, oc, c_in, oc_list = ops.launch_geometry(
            launch, in_shape, [w.shape[-1] for w in prep["weights"]])
        tile = ops.choose_chain_tile(launch.stages, oh, ow, oc, c_in, n,
                                     oc_list)
        before = ops.LAUNCHES["fused_chain_ring_stages"]
        got = ops.fused_chain(*args, **kw, packed=prep["packed"])
        rings += ops.LAUNCHES["fused_chain_ring_stages"] - before
        check_equal(got, ops.fused_chain_plain(*args, **kw),
                    f"{what}: chain {launch.nodes} at batch {n}, tile {tile}")
        tiles.append(list(tile))
        del args, got
    if rings == 0 or max(t[3] for t in tiles) < 2:
        raise AssertionError(f"{what} at batch {n}: {rings} ring stages, "
                             f"tiles {tiles}")
    log(f"phase 14, {what}: fused_chain == plain at batch {n} on "
        f"{len(chains)} chain launches, {rings} ring stages, tiles {tiles}")
    return {"batch": n, "launches_checked": len(chains),
            "ring_stages": rings, "tiles": tiles}


def zoo_cnn_phase(models, dev, card: str) -> dict:
    """Phase 14: the eight plans of ``ZOO_PLANS`` on the card."""
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED + 14)
    res: dict = {}
    calibrated: dict = {}
    for name, target in ZOO_PLANS:
        if name not in calibrated:
            if name in models:
                calibrated[name] = models[name]
            else:
                t0 = time.perf_counter()
                calibrated[name] = prepare_model(name, dev,
                                                 ZOO_IMG.get(name, IMG))
                log(f"phase 14: calibrated {name}-{calibrated[name]['img']} "
                    f"on the card in "
                    f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        r = zoo_plan(name, target, calibrated[name], gen, dev, card)
        r["seconds"] = time.perf_counter() - t0
        res[f"{name}-{calibrated[name]['img']} {target}"] = r
        log(f"phase 14, {name}-{calibrated[name]['img']} under {target} on "
            f"{card}: "
            f"{json.dumps(r)}")
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 14 took {res['seconds']:.1f} s")
    return res


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


def conv_launches() -> dict:
    """The conv kernels' launch counts: ``ops.LAUNCHES`` without its count
    of the conv stages the chain launches ran through the weight ring."""
    from repro_torch.kernels.conv_fused import ops

    return {k: ops.LAUNCHES[k] for k in ("fused_chain", "fused_horizontal")}


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
    # phase 13a holds the TP=2 prefill of the same weights against these
    torch.save({"fp32": ref.cpu(), "flash_bf16": logits.cpu()},
               os.path.join(OUT, GRANITE_REF))
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
        q, k = scan.expand_heads(q, k, v)       # Zamba2's one-head q and k
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
    want_launches = dict.fromkeys(launches, 0)
    want_launches["ssm_scan"] = _n_scans(cfg)
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


# ---------------------------------------------------------------- phase 10
SEAMLESS = "seamless-m4t-large-v2"
SEAMLESS_PREFILL = (4, 2048)        # batch, frames + tokens (ENC_FRACTION)
SEAMLESS_DEPTH = {"n_layers": 2, "enc_layers": 2}


@torch.inference_mode()
def seamless_phase(dev, card: str) -> dict:
    """Seamless-m4t-large-v2 served at full width and depth (phase 10)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.nn import encdec

    cfg = configs.get(SEAMLESS)
    t0 = time.perf_counter()
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _flat(params))
    log(f"{SEAMLESS} at full width and depth on the card: {n_params} "
        f"parameters (bf16) drawn in {time.perf_counter() - t0:.1f} s")
    B, S = SEAMLESS_PREFILL
    se = int(S * api.ENC_FRACTION["prefill"])
    sd = S - se
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    frames = torch.randn((B, se, cfg.d_model), generator=gen, device=dev)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, sd)), device=dev)
    prefill = serve.make_prefill_step(cfg)
    prefill(params, {"frames": frames[:, :64], "tokens": tokens[:, :8]})

    reset_all_counts()                        # ---- main path starts here
    logits, prefill_s = timed(lambda: prefill(
        params, {"frames": frames, "tokens": tokens}))
    launches, plain = all_counts()            # ---- main path ends here
    if any(launches.values()) or any(plain.values()):
        raise AssertionError(f"{SEAMLESS} prefill runs no kernel: launches "
                             f"{launches}, plain calls {plain}")
    if tuple(logits.shape) != (B, sd, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"bad prefill logits {tuple(logits.shape)}")
    del logits
    log(f"{SEAMLESS} prefill {B}x{S} ({se} frames + {sd} tokens): "
        f"{prefill_s * 1e3:.1f} ms, {B * S / prefill_s:.0f} positions/s")

    prompt = rng.integers(0, cfg.vocab, (B, 128))
    serve.serve_loop(cfg, params, prompt[:, :8], 4, dev)      # warm-up
    reset_all_counts()
    served = serve.serve_loop(cfg, params, prompt, 32, dev)
    if any(all_counts()[0].values()) or any(all_counts()[1].values()) \
            or served["tokens"].shape != (B, 32) \
            or not ((0 <= served["tokens"]).all()
                    and (served["tokens"] < cfg.vocab).all()):
        raise AssertionError(f"{SEAMLESS} serve loop: "
                             f"{served['tokens'].shape}, counts "
                             f"{all_counts()}")
    pbd_tps = B * 127 / served["prefill_s"]
    dec_tps = B * 32 / served["decode_s"]
    log(f"{SEAMLESS} serve loop (batch {B}, {api.SEAMLESS_DECODE_ENC_LEN}-"
        f"frame cross cache): prefill-by-decode of 127 tokens {pbd_tps:.1f} "
        f"tokens/s, 32 greedy steps {dec_tps:.1f} tokens/s "
        f"({served['decode_s'] / 32 * 1e3:.2f} ms/step)")
    del params
    torch.cuda.empty_cache()

    # full width, cut depth, fp32: teacher-forced decode against prefill,
    # the cross cache filled from the encoder's output
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype="float32", **SEAMLESS_DEPTH)
    p32 = api.init_params(cfg32, torch.Generator(device=dev).manual_seed(
        SEED + 1), dev)
    fr, short = frames[:, :256], tokens[:, :128]
    enc = encdec.encode(cfg32, p32, fr)
    full = encdec.decode_train(cfg32, p32, enc, short)
    cache = encdec.init_cache(cfg32, B, short.shape[1], fr.shape[1], dev,
                              enc_out=enc, params=p32)
    dec = []
    for t in range(short.shape[1]):
        lg, cache = api.decode_step(cfg32, p32, cache, short[:, t], t)
        dec.append(lg)
    err_dec = float((torch.stack(dec, 1) - full).abs().max())
    if not err_dec <= FP32_DECODE_TOL:
        raise AssertionError(f"{SEAMLESS} fp32 decode vs prefill: {err_dec}"
                             f" > {FP32_DECODE_TOL}")
    log(f"{SEAMLESS} full width, 2+2 layers, fp32: teacher-forced decode vs "
        f"prefill ({B}x128 against 256 frames) max |diff| {err_dec} "
        f"(largest |logit| {float(full.abs().max())})")
    del p32, cache, enc, full, dec
    torch.cuda.empty_cache()
    return {"card": card, "params": n_params, "prefill_ms": prefill_s * 1e3,
            "prefill_positions_per_s": B * S / prefill_s,
            "prefill_frames": se, "prefill_tokens": sd,
            "prefill_by_decode_tokens_per_s": pbd_tps,
            "decode_tokens_per_s": dec_tps, "fp32_decode_err": err_dec}


def _flat(tree) -> list:
    from repro_torch.core.tree import leaves

    return leaves(tree)


# ---------------------------------------------------------------- phase 11
# the scan backward's cases: the model shapes at a training microbatch of
# 2 x 2048, a ragged S and K != V
BW_CASES = {
    "xlstm train": (2, 2048, 4, 1024, 1024, False),
    "zamba2 train": (2, 2048, 32, 64, 128, True),
    "ragged S=200": (4, 200, 4, 64, 96, False),
    "K != V": (2, 256, 2, 40, 24, False),
    # one rank's heads in the TP = 2 prefills of phase 13
    "xlstm TP=2 rank prefill": (4, 2048, 2, 1024, 1024, False),
    "zamba2 TP=2 rank prefill": (4, 2048, 16, 64, 128, True),
}
# fp32 route's gradients against plain autograd through
# chunked_linear_scan, relative to each gradient's largest value (row by
# row for dq, dk, dv; over the whole (B, S, H) tensor for d log_a): the
# forward's 2e-4 (the JAX package's Pallas tolerance).  Each gradient is one
# fp32 scan, d log_a a sum over S of their products; the H100 gave at most
# 2.6e-5.  A whole fp32 train step of Zamba2 (12c) carries that rounding
# through the model to every gradient and, by one Adam step, every
# parameter: its leaves are held at 1e-3 of their largest value (2.2e-4
# measured)
BW_FP32_TOL = 2e-4
STEP_FP32_TOL = 1e-3
# bf16 and fp16 routes: each gradient no farther from the fp32 one than
# 1.25 times the plain autograd's in the same dtype
BW_VS_PLAIN = 1.25
GRAD_NAMES = ("dq", "dk", "dv", "dlog_a")


def leaf_rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def grad_rel_err(got, want) -> float:
    """Row-relative for a (B, S, H, X) gradient (``row_rel_err``), and
    relative to the largest |value| of the whole tensor for d log_a."""
    from repro_torch.kernels.ssm_scan import ops as scan

    if want.dim() == 4:
        return scan.row_rel_err(got, want)
    return leaf_rel_err(got, want)


def bw_inputs(case, dtype, dev, seed):
    """Leaves q0, k0 (one head where the case broadcasts them), v, log_a
    requiring grad, the q, k the scan sees (expanded over the heads), and
    the upstream gradient dy."""
    b, s, h, dk, dv, bcast = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    hq = 1 if bcast else h
    q0, k0 = ((torch.randn((b, s, hq, dk), generator=gen, device=dev)
               / dk ** 0.5).to(dtype).requires_grad_(True) for _ in range(2))
    v = torch.randn((b, s, h, dv), generator=gen, device=dev).to(
        dtype).requires_grad_(True)
    la = torch.nn.functional.logsigmoid(torch.randn(
        (b, s, h), generator=gen, device=dev)).requires_grad_(True)
    dy = torch.randn((b, s, h, dv), generator=gen, device=dev).to(dtype)
    return (q0, k0, v, la), (q0.expand(b, s, h, dk), k0.expand(b, s, h, dk)),\
        dy


def scan_grads(case, dtype, dev, seed, plain: bool, scan_fn=None):
    """(dq0, dk0, dv, d log_a) of <scan(q, k, v, log_a), dy>: through the
    wrapper (the kernels and ``ScanFunction`` on the card), through
    ``ScanFunction`` with ``scan_fn`` in place of ``kernel_scan`` or, with
    ``plain``, through ``chunked_linear_scan`` under autograd."""
    from repro_torch.kernels.ssm_scan import ops as scan
    from repro_torch.nn.recurrent import chunk_for, chunked_linear_scan

    leaves_, (q, k), dy = bw_inputs(case, dtype, dev, seed)
    v, la = leaves_[2], leaves_[3]
    if plain:
        y = chunked_linear_scan(q, k, v, la, chunk=chunk_for(case[1]))[0]
    elif scan_fn is not None:
        y = scan.ScanFunction.apply(q, k, v, la, scan_fn)
    else:
        y = scan.ssm_scan(q, k, v, la, chunk=chunk_for(case[1]))
    return torch.autograd.grad(y, leaves_, dy)


def bw_work(case, elem_bytes: int) -> tuple[int, int]:
    """(bytes, FLOPs) the backward needs, the least work of the function
    (dq0, dk0, dv, d log_a) of (q0, k0, v, log_a, dy): each input read once
    and each gradient written once in its own dtype (q0, k0 and their
    gradients on one head where the case broadcasts them; log_a and
    d log_a fp32); the step-by-step recurrence's backward, 10 K V per step
    and head (2 K V each: recomputing S_t, dq_t = S_t dy_t, dS_t = q_t
    dy_t^T + a_{t+1} dS_{t+1}, dk_t = dS_t v_t, dv_t = dS_t^T k_t), and 4 K
    for d log_a's sum of q . dq - k . dk."""
    b, s, h, dk, dv, bcast = case
    hq = 1 if bcast else h
    nbytes = (elem_bytes * (4 * b * s * hq * dk + 3 * b * s * h * dv)
              + 2 * 4 * b * s * h)
    return nbytes, 10 * b * s * h * dk * dv + 4 * b * s * h * dk


def bw_impl_work(case, elem_bytes: int) -> tuple[int, int]:
    """(bytes, FLOPs) of the bf16 backward as ``kernel_backward``'s kernels
    issue them, for comparison with ``bw_work`` (the function's least
    work).  Operands count per head as the kernels read them (a one-head q
    or k at stride 0 too: its repeats may come from L2), once per column
    slab for the X and Z of a state pass and once in all for its W.  The
    two intra kernels read (q, k), (dy, v) and log_a and write P and D
    (bf16 hi and lo, 16 KB a (head, chunk)) and the coefficients; the dq, dv and dk
    passes read D, P, D once per slab; dq and dk write their row dots, and
    the d log_a kernel reads them.  FLOPs: the tensor cores' products,
    the hi/lo halves counted (``ssm_scan_bw.cu``'s note): a pass contracting
    Kc into Vo columns does 8 Kc Vo per step (the state's term and its
    update) plus its intra product, 2.5 Vo T per step with T = 64 (10 of 16
    blocks below the diagonal, two halves); an intra kernel 1.25 Kc T per
    step."""
    from repro_torch.kernels.ssm_scan import ops as scan

    b, s, h, dk, dv, _ = case
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    vts = scan.bw_slabs(b, h, dk, dv, n_sm, torch.bfloat16)
    e, T = elem_bytes, scan.CHUNK
    rows = b * s * h
    recs = b * h * -(-s // T)
    scratch = recs * T * T * 4          # one P or D: hi and lo halves
    coef = recs * scan.COEF * 4
    nbytes = (2 * rows * (dk + dv) * e + 2 * 4 * rows    # intra kernels
              + 2 * scratch + coef)
    flops = 1.25 * rows * T * (dk + dv)
    for kc, vo, vt, dots in ((dv, dk, vts[0], True), (dk, dv, vts[1], False),
                             (dv, dk, vts[2], True)):
        slabs = -(-vo // vt)
        nbytes += (slabs * (2 * rows * kc * e + scratch + coef)
                   + 2 * rows * vo * e)                # W in, out
        if dots:
            nbytes += rows * vo * e + 4 * rows * slabs  # R in, dots out
        flops += 8 * rows * kc * vo + 2.5 * rows * vo * T
    parts = -(-dk // vts[0]) + -(-dk // vts[2])
    nbytes += 4 * rows * parts + 4 * rows                # d log_a kernel
    return int(nbytes), int(flops)


def _leaf_grads(grads, case):
    """``plain_backward``'s (dq, dk, dv, d log_a) as the leaves' gradients:
    dq and dk summed over the heads where the case broadcasts q and k."""
    dq, dk, dv, dla = grads
    if case[5]:
        dq, dk = dq.sum(2, keepdim=True), dk.sum(2, keepdim=True)
    return dq, dk, dv, dla


def scan_backward_phase(dev) -> dict:
    """The scan's backward on the card (phase 11): every route's kernels
    against plain autograd and ``plain_backward``, then the bf16 route
    timed at both model shapes."""
    from repro_torch.kernels.ssm_scan import ops as scan
    from repro_torch.nn.recurrent import chunk_for, chunked_linear_scan

    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {}

    def passes(dtype, case, seed):
        leaves_, (q, k), dy = bw_inputs(case, dtype, dev, seed)
        with torch.no_grad():
            return _leaf_grads(scan.plain_backward(
                q, k, leaves_[2], leaves_[3], dy), case)

    for i, (name, case) in enumerate(BW_CASES.items()):
        want = scan_grads(case, torch.float32, dev, SEED + i, plain=True)
        reset_all_counts()
        got = scan_grads(case, torch.float32, dev, SEED + i, plain=False)
        launches, plain = all_counts()
        if launches["ssm_scan_backward"] != 1 or \
                launches["ssm_scan"] != 1 or any(plain.values()):
            raise AssertionError(f"scan backward {name}: launches "
                                 f"{launches}, plain calls {plain}")
        p32 = passes(torch.float32, case, SEED + i)
        rel = {g: grad_rel_err(a, w) for g, a, w in zip(GRAD_NAMES, got,
                                                        want)}
        rel_p = {g: grad_rel_err(a, w) for g, a, w in zip(GRAD_NAMES, got,
                                                          p32)}
        errs[f"{name} float32"] = {
            "vs_autograd": rel, "vs_passes": rel_p,
            "max_abs": max(float((a - w).abs().max())
                           for a, w in zip(got, want))}
        if not all(e <= BW_FP32_TOL for e in (*rel.values(),
                                              *rel_p.values())) or not all(
                bool(torch.isfinite(a).all()) for a in got):
            raise AssertionError(f"scan backward {name} fp32: {rel}, "
                                 f"against plain_backward {rel_p} > "
                                 f"{BW_FP32_TOL}")
        del p32
        for dtype in (torch.bfloat16, torch.float16):
            kern = scan_grads(case, dtype, dev, SEED + i, plain=False)
            ref = scan_grads(case, dtype, dev, SEED + i, plain=True)
            same = passes(dtype, case, SEED + i)
            e_k, e_p, e_s = ({g: grad_rel_err(a, w) for g, a, w in
                              zip(GRAD_NAMES, x, want)}
                             for x in (kern, ref, same))
            errs[f"{name} {str(dtype)[6:]}"] = {"kernel": e_k, "plain": e_p,
                                               "plain_backward": e_s}
            bad = [g for g in GRAD_NAMES
                   if not e_k[g] <= BW_VS_PLAIN * min(e_p[g], e_s[g])]
            if bad or not all(bool(torch.isfinite(a).all()) for a in kern):
                raise AssertionError(
                    f"scan backward {name} {dtype}: {bad} farther from fp32 "
                    f"than {BW_VS_PLAIN} x plain autograd's or "
                    f"plain_backward's: kernel {e_k}, plain {e_p}, "
                    f"plain_backward {e_s}")
            del kern, ref, same
        del want, got
    log("ssm_scan backward kernels == plain autograd and plain_backward on "
        f"the card (fp32 within {BW_FP32_TOL} row-relative; bf16 and fp16 "
        f"against the fp32 gradients, kernel beside plain autograd and "
        f"plain_backward in the same dtype): " + json.dumps(errs))

    out = {"errors": errs}
    for arch, case in (("xlstm-1.3b", BW_CASES["xlstm train"]),
                       ("zamba2-1.2b", BW_CASES["zamba2 train"])):
        leaves_, (q, k), dy = bw_inputs(case, torch.bfloat16, dev, SEED)
        v, la = leaves_[2], leaves_[3]
        y = scan.ssm_scan(q, k, v, la, chunk=chunk_for(case[1]))
        ms = device_ms(lambda: torch.autograd.grad(
            y, leaves_, dy, retain_graph=True), reps=5)
        with torch.no_grad():
            kernel_ms = device_ms(lambda: scan.kernel_backward(
                q, k, v, la, dy), reps=5)
            trace = f"scan_backward_{arch}_trace.json"
            profile_device(lambda: scan.kernel_backward(q, k, v, la, dy), 5,
                           trace)
        y = chunked_linear_scan(q, k, v, la, chunk=chunk_for(case[1]))[0]
        plain_ms = device_ms(lambda: torch.autograd.grad(
            y, leaves_, dy, retain_graph=True), reps=3)
        del y
        nbytes, flops = bw_work(case, 2)
        impl_bytes, impl_flops = bw_impl_work(case, 2)
        t_bytes, t_ops = 1e3 * nbytes / MEM_BW, 1e3 * flops / BF16_PEAK
        rec = {"ms": ms, "kernel_backward_ms": kernel_ms,
               "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "flops": flops, "library_ms": None,
               "impl_bytes": impl_bytes, "impl_flops": impl_flops,
               "kernels_ms": kernel_means(os.path.join(OUT, trace))}
        out[arch] = rec
        log(f"ssm_scan backward at {arch}'s training shape {case[:5]}, bf16 "
            f"(ms: the gradient of q0, k0, v, log_a through ScanFunction, "
            f"the head sum included; kernel_backward_ms: its kernels alone; "
            f"kernels_ms: each kernel's mean device ms and event count in "
            f"a trace of 5 calls (scan_intra_kernel runs twice a call); "
            f"bound: the function's least work; impl_*: what the kernels "
            f"move and compute): " + json.dumps(rec))
        del leaves_, q, k, dy
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- phase 12
ZAMBA = "zamba2-1.2b"
TRAIN_BATCH = (4, 2048)         # rows, sequence
TRAIN_ACCUM = 2
TRAIN_STEPS = 8
CKPT_STEP = 4
# leaves that only the scan's gradient reaches in a Mamba2 layer (B, C and
# dt come out of w_bcdt; a_log sets the decay), beside its in/out
# projections: each layer's slice of each must have a nonzero gradient
MAMBA_LEAVES = ("w_in", "w_out", "w_bcdt", "a_log")
ZAMBA_DEPTH = {"n_layers": 1, "shared_attn_every": 1}
SEAMLESS_TRAIN = (2, 2048, 2)   # rows, frames + tokens, steps
XLSTM = "xlstm-1.3b"
XLSTM_TRAIN = (2, 2048, 2)      # rows, sequence, steps
# the leaves of an mLSTM block, each of whose layers' slices must have a
# nonzero gradient (w_qkg's q and k columns reach the loss only through the
# scan)
MLSTM_LEAVES = ("w_up", "w_qkg", "w_down")


def _named(tree, prefix="") -> dict:
    out = {}
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out.update(_named(tree[k], f"{prefix}{k}."))
        else:
            out[prefix + k] = tree[k]
    return out


def check_grads(grads, what: str) -> dict:
    """Every gradient leaf finite; the norm of each leaf, of which none may
    be zero (every leaf of these models is reached by the loss)."""
    norms = {n: float(g.float().norm()) for n, g in _named(grads).items()}
    bad = [n for n, g in _named(grads).items()
           if not bool(torch.isfinite(g).all())]
    zero = [n for n, v in norms.items() if not v > 0]
    if bad or zero:
        raise AssertionError(f"{what}: non-finite gradient leaves {bad}, "
                             f"zero-norm leaves {zero}")
    return norms


def zamba_training(dev, card: str) -> dict:
    """Zamba2-1.2B at full width and depth trained 8 steps (phase 12a)."""
    import tempfile

    from repro_torch import configs
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train

    cfg = configs.get(ZAMBA)
    B, S = TRAIN_BATCH
    state = train.init_state(cfg, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    data = SyntheticLM(vocab=cfg.vocab, batch=B, seq=S, family=cfg.family,
                       d_model=cfg.d_model, device=dev)
    step_fn = train.make_train_step(cfg, grad_accum=TRAIN_ACCUM)
    n_mamba = cfg.n_layers
    # a forward, its remat recompute and a backward per layer and microbatch
    per_step = {"ssm_scan_backward": n_mamba * TRAIN_ACCUM,
                "ssm_scan": 2 * n_mamba * TRAIN_ACCUM}
    losses, step_s, counts, batches = [], [], None, {}
    with tempfile.TemporaryDirectory() as tmp:
        store = CheckpointStore(tmp)
        for i in range(TRAIN_STEPS):
            batch = data.next()
            batches[i] = batch["tokens"]
            torch.cuda.synchronize()
            reset_all_counts()                # ---- main path starts here
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            launches, plain = all_counts()    # ---- main path ends here
            want = dict.fromkeys(launches, 0)
            want.update(per_step)
            if launches != want or any(plain.values()):
                raise AssertionError(f"{ZAMBA} train step {i + 1}: launches "
                                     f"{launches} (want {want}), plain calls"
                                     f" {plain}")
            counts = launches
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                raise AssertionError(f"{ZAMBA} step {i + 1}: loss {loss}")
            losses.append(loss)
            if i == 0:
                norms = check_grads(metrics["grads"], f"{ZAMBA} step 1")
                layer_norms = {n: metrics["grads"]["mamba"][n].float().flatten(
                    1).norm(dim=1) for n in MAMBA_LEAVES}
                dead = {n: int((v == 0).sum()) for n, v in
                        layer_norms.items() if not bool((v > 0).all())}
                if dead:
                    raise AssertionError(f"{ZAMBA}: Mamba2 layers with a zero "
                                         f"gradient: {dead}")
            del metrics
            if i + 1 == CKPT_STEP:
                t0 = time.perf_counter()
                store.save(state, step=CKPT_STEP, async_write=True,
                           extra={"data": data.state()})
                save_s = time.perf_counter() - t0
                saved = state
        t0 = time.perf_counter()
        store.wait()
        wait_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored, at = store.restore_latest(train.abstract_state(cfg), dev)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    diff = [n for n, (a, b) in enumerate(zip(_flat(saved), _flat(restored)))
            if a.dtype != b.dtype or not torch.equal(a, b)]
    resumed = SyntheticLM(vocab=cfg.vocab, batch=B, seq=S, family=cfg.family,
                          d_model=cfg.d_model, device=dev)
    resumed.seek(at)
    if at != CKPT_STEP or diff or not torch.equal(
            resumed.next()["tokens"], batches[CKPT_STEP]):
        raise AssertionError(f"{ZAMBA} checkpoint at step {at}: leaves "
                             f"{diff} differ, or the data cursor did not "
                             f"resume")
    n_leaves = len(_flat(saved))
    del saved, restored, resumed
    prof = profile_device(lambda: step_fn(state, data.batch_at(0)), 1,
                          "zamba2_train_step_trace.json")
    steady = step_s[1:]
    rec = {"card": card, "losses": losses, "step_s": step_s,
           "steps_per_s": len(steady) / sum(steady),
           "tokens_per_s": B * S * len(steady) / sum(steady),
           "launches_per_step": counts, "grad_norms_step1": norms,
           "checkpoint": {"leaves": n_leaves, "save_return_s": save_s,
                          "wait_s": wait_s, "restore_s": restore_s},
           "train_step_profile": prof}
    log(f"{ZAMBA} training at full width and depth ({B}x{S}, grad_accum "
        f"{TRAIN_ACCUM}, bf16 params and moments, fp32 grad buffers): "
        f"losses {losses}; {rec['steps_per_s']:.3f} steps/s, "
        f"{rec['tokens_per_s']:.0f} tokens/s after the first step; launches "
        f"per step {counts}; checkpoint at step {CKPT_STEP}: "
        f"{n_leaves} leaves restored bit-equal, data cursor resumed; "
        + json.dumps({k: rec[k] for k in ("checkpoint", "train_step_profile")}))
    del state, step_fn
    torch.cuda.empty_cache()
    return rec


def seamless_training(dev, card: str) -> dict:
    """Seamless-m4t-large-v2 at full width trained 2 steps (phase 12b)."""
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train

    cfg = configs.get(SEAMLESS)
    B, S, steps = SEAMLESS_TRAIN
    torch.cuda.reset_peak_memory_stats(dev)
    state = train.init_state(cfg, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    data = SyntheticLM(vocab=cfg.vocab, batch=B, seq=S, family=cfg.family,
                       d_model=cfg.d_model, device=dev)
    step_fn = train.make_train_step(cfg)
    losses, step_s = [], []
    for i in range(steps):
        batch = data.next()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"{SEAMLESS} step {i + 1}: loss {losses[-1]}")
        check_grads(metrics["grads"], f"{SEAMLESS} step {i + 1}")
        del metrics
    frames, tokens = batch["frames"].shape[1], batch["tokens"].shape[1]
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"{SEAMLESS} training at full width ({B}x{S}: {frames} frames + "
        f"{tokens} tokens; bf16 grads, bf16 moments): losses {losses}, every "
        f"gradient leaf finite and nonzero; step seconds {step_s}; peak "
        f"device memory {peak / 2**30:.1f} GiB")
    del state, step_fn, batch
    torch.cuda.empty_cache()
    return {"losses": losses, "step_s": step_s, "frames": frames,
            "tokens": tokens, "peak_bytes": peak}


def xlstm_training(dev, card: str) -> dict:
    """xLSTM-1.3B at full width and depth trained 2 steps (phase 12d): the
    mLSTM scans' backward under remat beside the sLSTM loops' autograd."""
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.nn import xlstm

    cfg = configs.get(XLSTM)
    B, S, steps = XLSTM_TRAIN
    n_mlstm = xlstm._counts(cfg)[1]
    per_step = {"ssm_scan_backward": n_mlstm, "ssm_scan": 2 * n_mlstm}
    torch.cuda.reset_peak_memory_stats(dev)
    state = train.init_state(cfg, generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev)
    data = SyntheticLM(vocab=cfg.vocab, batch=B, seq=S, family=cfg.family,
                       device=dev)
    step_fn = train.make_train_step(cfg)
    losses, step_s = [], []
    for i in range(steps):
        batch = data.next()
        torch.cuda.synchronize()
        reset_all_counts()                    # ---- main path starts here
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        launches, plain = all_counts()        # ---- main path ends here
        want = dict.fromkeys(launches, 0)
        want.update(per_step)
        if launches != want or any(plain.values()):
            raise AssertionError(f"{XLSTM} train step {i + 1}: launches "
                                 f"{launches} (want {want}), plain calls "
                                 f"{plain}")
        losses.append(float(metrics["loss"]))
        if not np.isfinite(losses[-1]):
            raise AssertionError(f"{XLSTM} step {i + 1}: loss {losses[-1]}")
        check_grads(metrics["grads"], f"{XLSTM} step {i + 1}")
        dead = {n: int((metrics["grads"]["mlstm"][n].float().flatten(1).norm(
            dim=1) == 0).sum()) for n in MLSTM_LEAVES}
        if any(dead.values()):
            raise AssertionError(f"{XLSTM}: mLSTM layers with a zero "
                                 f"gradient: {dead}")
        del metrics
    peak = torch.cuda.max_memory_allocated(dev)
    rec = {"card": card, "losses": losses, "step_s": step_s,
           "tokens_per_s": B * S / step_s[-1], "launches_per_step": launches,
           "peak_bytes": peak}
    log(f"{XLSTM} training at full width and depth ({B}x{S}, bf16 params, "
        f"grads in fp32 buffers, bf16 moments): losses {losses}, every "
        f"gradient leaf finite and nonzero; step seconds {step_s}; launches "
        f"per step {launches}; peak device memory {peak / 2**30:.1f} GiB")
    del state, step_fn, batch
    torch.cuda.empty_cache()
    return rec


def zamba_step_check(dev) -> dict:
    """One fp32 train step of Zamba2 at full width and a cut depth through
    the kernels, against the same step with the plain scan under autograd
    (phase 12c): gradients and updated params, leaf by leaf, at
    ``STEP_FP32_TOL``.  (The same step from a state carried from the JAX
    package is held to that package's step in the CPU tests: this machine
    has no jax.)"""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get(ZAMBA), dtype="float32",
                              **ZAMBA_DEPTH)
    state = train.init_state(cfg, generator=torch.Generator(
        device=dev).manual_seed(SEED + 1), device=dev)
    batch = SyntheticLM(vocab=cfg.vocab, batch=2, seq=512, family=cfg.family,
                        device=dev).next()
    step_fn = train.make_train_step(cfg)
    reset_all_counts()
    got, gm = step_fn(state, batch)
    launches = all_counts()[0]
    with plain_scan():
        want, wm = step_fn(state, batch)
    if launches["ssm_scan_backward"] != cfg.n_layers:
        raise AssertionError(f"{ZAMBA} cut-depth step: launches {launches}")
    errs = {"grad": {}, "param": {}}
    for n, g in _named(gm["grads"]).items():
        errs["grad"][n] = leaf_rel_err(g, _named(wm["grads"])[n])
    for n, p in _named(got["params"]).items():
        errs["param"][n] = leaf_rel_err(p, _named(want["params"])[n])
    worst = {k: max(v.values()) for k, v in errs.items()}
    if not all(e <= STEP_FP32_TOL for v in errs.values() for e in v.values()):
        raise AssertionError(f"{ZAMBA} cut-depth fp32 step, kernel vs plain "
                             f"scan: {errs}")
    log(f"{ZAMBA} full width, 1 layer + shared block, fp32: one train step "
        f"through the kernels against the plain scan under autograd, "
        f"leaf-relative max |diff|: grads {worst['grad']}, updated params "
        f"{worst['param']}; loss {float(gm['loss'])} vs {float(wm['loss'])}")
    del state, got, want, gm, wm
    torch.cuda.empty_cache()
    return worst


def training_phase(dev, card: str) -> dict:
    t0 = time.perf_counter()
    res = {"zamba2": zamba_training(dev, card),
           "seamless": seamless_training(dev, card),
           "zamba2_cut_depth_fp32": zamba_step_check(dev),
           "xlstm": xlstm_training(dev, card)}
    res["seconds"] = time.perf_counter() - t0
    log(f"training phase took {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------- phase 13
# The multi-device slice.  The driver's machine has one card, so the ranks
# share cuda:0 over gloo (NCCL refuses two ranks on one device): these runs
# prove the sharded code, the kernel at its per-rank shapes and the
# collectives' plumbing, not multi-card speed.  Every collective runs
# through the mesh's process groups on CUDA tensors.
MESH_SERVE = ((1, 2), ("data", "model"))      # (a): TP = 2
MESH_TRAIN = ((2, 2), ("data", "model"))      # (b), (d)
MESH_TRAIN_LAYERS = 4                         # (b): depth cut, full width
MESH_TRAIN_BATCH = (4, 2048, 2)               # rows, sequence, grad_accum
MESH_FP32_LAYERS = 4                          # (a): fp32 check at cut depth
MESH_PG_TIMEOUT_S = 60                        # a hung collective fails
# (b): the sharded step against the unsharded one, the reference's own
# tolerances (tests/test_multidevice.py:55, :87, :116)
MESH_LOSS_TOL = 5e-3
MESH_PARAM_RTOL, MESH_PARAM_ATOL = 5e-3, 5e-4
MESH_COMPRESS_REL_TOL = 0.05
SHARED = "ranks share one card"
MESH_DEVICE = "cuda"
GRANITE_REF = "granite_prefill_logits.pt"     # phase 5's, for 13a


def _granite(**kw):
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.get("granite-8b"), **kw)


def _peak_gib(dev) -> float:
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30


def _spy_kernels() -> dict:
    """Record the (q, k) shapes of every flash launch and the (q, v) shapes
    and q's head stride of every scan launch of this process."""
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.ssm_scan import ops as scan

    seen = {"flash": [], "scan": []}
    flash_call, scan_launch = flash.flash_attention, scan.launch

    def spy_flash(q, k, v, **kw):
        seen["flash"].append((tuple(q.shape), tuple(k.shape)))
        return flash_call(q, k, v, **kw)

    def spy_scan(q, k, v, log_a, vt):
        seen["scan"].append((tuple(q.shape), tuple(v.shape), q.stride(2)))
        return scan_launch(q, k, v, log_a, vt)

    flash.flash_attention, scan.launch = spy_flash, spy_scan
    return seen


def _rank_dev():
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def tp_serve_rank(rank, world, ref_path) -> dict:
    """(a) Granite-8B at full width and depth, TP = 2 on a (1, 2) mesh:
    the 4x2048 flash prefill, the serve loop, and the fp32 cut-depth
    check against the unsharded model on the same rank."""
    from repro_torch.launch import serve, shard
    from repro_torch.launch.hlo_analysis import (CommRecord,
                                                 collective_stats_from_comm)
    from repro_torch.launch.mesh import make_mesh, mesh_context
    from repro_torch.launch.train import place_state
    from repro_torch.models import api

    dev = _rank_dev()
    mesh = make_mesh(*MESH_SERVE, device_type=MESH_DEVICE)
    backend = torch.distributed.get_backend()
    cfg = _granite(attn_impl="flash")
    B, S = GRANITE_PREFILL[0], GRANITE_PREFILL[1]
    rng = np.random.default_rng(SEED)            # phase 5's draws
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device=dev)
    prompt = rng.integers(0, cfg.vocab, (B, 128))
    full = api.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                           dev)
    params = place_state(full, shard.param_specs(full, mesh), mesh)
    del full
    torch.cuda.empty_cache()
    prefill = serve.make_prefill_step(cfg)
    res = {"backend": backend, "mesh": list(mesh.shape)}
    with torch.no_grad(), mesh_context(mesh):
        prefill(params, {"tokens": tokens[:, :128]})            # warm-up
        seen = _spy_kernels()["flash"]
        torch.cuda.reset_peak_memory_stats(dev)
        reset_all_counts()                    # ---- main path starts here
        with CommRecord() as comm:
            logits, prefill_s = timed(lambda: prefill(params,
                                                      {"tokens": tokens}))
        launches, plain = all_counts()        # ---- main path ends here
        res["prefill_peak_gib"] = _peak_gib(dev)
        res.update(launches=launches, plain=plain,
                   flash_shapes=sorted(set(seen)), prefill_ms=prefill_s * 1e3,
                   prefill_collectives=collective_stats_from_comm(comm),
                   prefill_ops=sorted({e["op"] for e in comm.entries}))
        got = logits.full_tensor()
        del logits
        if rank == 0:
            ref = torch.load(ref_path)
            fp32 = ref["fp32"].to(dev)
            unsharded = ref["flash_bf16"].to(dev)
            res["err_vs_fp32"] = {
                "sharded": float((got.float() - fp32).abs().max()),
                "unsharded": float((unsharded.float() - fp32).abs().max())}
            res["sharded_vs_unsharded"] = float(
                (got.float() - unsharded.float()).abs().max()
                / unsharded.float().abs().max())
            res["argmax_agreement"] = float(
                (got.argmax(-1) == unsharded.argmax(-1)).float().mean())
            del fp32, unsharded, ref
        del got
        torch.cuda.empty_cache()
        serve.serve_loop(cfg, params, prompt[:, :8], 2, dev, mesh=mesh)
        torch.cuda.reset_peak_memory_stats(dev)
        loop = serve.serve_loop(cfg, params, prompt, 32, dev, mesh=mesh)
        res.update(tokens=loop["tokens"].tolist(),
                   prefill_by_decode_tokens_per_s=B * 127 / loop["prefill_s"],
                   decode_tokens_per_s=B * 32 / loop["decode_s"],
                   decode_peak_gib=_peak_gib(dev))
    del params
    torch.cuda.empty_cache()

    # fp32 at full width and MESH_FP32_LAYERS layers: the sharded model
    # (flash on each rank's heads) against the unsharded one with plain
    # attention.  Prefill logits within FP32_PREFILL_TOL; the unsharded
    # greedy tokens fed to both step by step (teacher-forced decode):
    # logits within FP32_PREFILL_TOL, and at each generated position the
    # same token wherever the unsharded top-2 margin exceeds twice the two
    # models' distance (a closer tie may flip on a last-bit difference;
    # those are counted).  The free-running greedy tokens are equal up to
    # their first difference, which must fall on such a tie.
    import dataclasses

    cfg32 = _granite(attn_impl="flash", n_layers=MESH_FP32_LAYERS,
                     dtype="float32")
    plain32 = dataclasses.replace(cfg32, attn_impl="xla")
    full = api.init_params(cfg32, torch.Generator(device=dev).manual_seed(
        SEED + 1), dev)
    toks = tokens[:, :512]
    plen, gen = 16, 8
    with torch.no_grad():
        want = serve.make_prefill_step(plain32)(full, {"tokens": toks})
        greedy = serve.serve_loop(plain32, full, prompt[:, :plen], gen, dev)
        params = place_state(full, shard.param_specs(full, mesh), mesh)
        with mesh_context(mesh):
            got = serve.make_prefill_step(cfg32)(params, {"tokens": toks})
            got = got.full_tensor()
            got_greedy = serve.serve_loop(cfg32, params, prompt[:, :plen],
                                          gen, dev, mesh=mesh)
        seq = torch.as_tensor(np.concatenate([prompt[:, :plen],
                                              greedy["tokens"]], 1),
                              device=dev)
        c_full = api.init_cache(plain32, B, seq.shape[1], dev)
        c_tp = serve.init_cache(cfg32, B, seq.shape[1], dev, mesh)
        dec_err, flips, ties, margins, dists = 0.0, 0, 0, [], []
        with mesh_context(mesh):
            for t in range(seq.shape[1] - 1):
                a, c_full = api.decode_step(plain32, full, c_full, seq[:, t],
                                            t)
                b, c_tp = api.decode_step(cfg32, params, c_tp, seq[:, t], t)
                b = b.full_tensor()
                dist = (a - b).abs().max(-1).values
                dec_err = max(dec_err, float(dist.max()))
                if t < plen - 1:            # a prompt position
                    continue
                top = torch.topk(a, 2, dim=-1).values
                margin = top[:, 0] - top[:, 1]
                tie = margin <= 2 * dist
                differ = a.argmax(-1) != b.argmax(-1)
                flips += int((differ & ~tie).sum())
                ties += int(tie.sum())
                margins.append(margin.tolist())
                dists.append(dist.tolist())
    res["fp32_prefill_err"] = float((got - want).abs().max())
    res["fp32_decode_err"] = dec_err
    res["fp32_token_flips"] = flips
    res["fp32_near_ties"] = ties
    res["fp32_min_margin"] = min(min(m) for m in margins)
    differ = np.argwhere(got_greedy["tokens"] != greedy["tokens"])
    res["fp32_greedy_equal"] = not len(differ)
    if len(differ):
        # the first generated step where the rows part, and its row: up to
        # there the two token streams are the same, so the teacher-forced
        # margin and distance of that step are the free-running ones
        step = int(differ[:, 1].min())
        row = int(differ[differ[:, 1] == step][0, 0])
        res["fp32_first_divergence"] = {
            "step": step, "row": row, "margin": margins[step][row],
            "distance": dists[step][row],
            "near_tie": margins[step][row] <= 2 * dists[step][row]}
    return res


def _train_batch(cfg, dev):
    rows, seq, _ = MESH_TRAIN_BATCH
    toks = np.random.default_rng(SEED + 2).integers(0, cfg.vocab,
                                                    (rows, seq + 1))
    t = torch.as_tensor(toks, device=dev)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _mesh_leaf_rel(a, b) -> float:
    """max |a - b| over max |b| of two DTensors, reduced on the mesh."""
    num = (a.float() - b.float()).abs().max().full_tensor()
    return float(num / b.float().abs().max().full_tensor().clamp_min(1e-30))


def train_rank(rank, world, ckpt_dir) -> dict:
    """(b) Granite-8B at full width and MESH_TRAIN_LAYERS layers on a (2, 2)
    mesh: the unsharded step (rank 0, first, then freed), then "auto",
    "late" and "late" with compression; (d) the state saved, ranks 2 and 3
    lost, restored onto (1, 2) by ranks 0-1 and stepped once more."""
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.core.tree import leaves
    from repro_torch.distributed.elastic import plan_mesh, remesh
    from repro_torch.launch import shard
    from repro_torch.launch.hlo_analysis import (CommRecord,
                                                 collective_stats_from_comm)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import (abstract_state, init_state,
                                          make_train_step, state_specs)

    dev = _rank_dev()
    cfg = _granite(n_layers=MESH_TRAIN_LAYERS)
    ga = MESH_TRAIN_BATCH[2]
    batch = _train_batch(cfg, dev)
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED)  # noqa: E731
    res = {}
    if rank == 0:                # the unsharded step, first, then freed
        state = init_state(cfg, generator=gen(), device=dev)
        new, m = make_train_step(cfg, grad_accum=ga)(state, batch)
        want = [t.cpu() for t in leaves(new["params"])]
        res["unsharded_loss"] = float(m["loss"])
        del state, new, m
        torch.cuda.empty_cache()
    torch.distributed.barrier()
    mesh = make_mesh(*MESH_TRAIN, device_type=MESH_DEVICE)
    data_group = mesh.get_group("data").group_name
    runs, grads = {}, {}
    for name, kw in (("auto", {}), ("late", {"grad_sync": "late"}),
                     ("late_compressed", {"grad_sync": "late",
                                          "compress": True})):
        state = init_state(cfg, generator=gen(), device=dev, mesh=mesh,
                           compress=kw.get("compress", False))
        step = make_train_step(cfg, grad_accum=ga, mesh=mesh, **kw)
        torch.cuda.reset_peak_memory_stats(dev)
        with CommRecord() as comm:
            (new, m), secs = timed(lambda: step(state, batch))
        if name != "auto":
            grads[name] = m["grads"]
        err = {"loss": float(m["loss"])}
        errs = []
        for i, t in enumerate(leaves(new["params"])):
            full = t.full_tensor()
            if rank == 0:
                w = want[i].to(dev)
                errs.append(not torch.allclose(
                    full.float(), w.float(), rtol=MESH_PARAM_RTOL,
                    atol=MESH_PARAM_ATOL))
                err.setdefault("param_max_abs_diff", 0.0)
                err["param_max_abs_diff"] = max(
                    err["param_max_abs_diff"],
                    float((full.float() - w.float()).abs().max()))
        err["params_outside_tol"] = sum(errs)
        runs[name] = {**err, "step_s": secs, "peak_gib": _peak_gib(dev),
                      "grad_sync": collective_stats_from_comm(
                          comm, "grad_sync", data_group),
                      "collectives": collective_stats_from_comm(comm),
                      "ops": sorted({e["op"] for e in comm.entries})}
        if name == "late_compressed":
            kept = new
        del new, m, state
        torch.cuda.empty_cache()
    res["runs"] = runs
    res["compressed_grad_rel"] = max(
        _mesh_leaf_rel(a, b) for a, b in zip(leaves(grads["late_compressed"]),
                                             leaves(grads["late"])))
    del grads
    torch.cuda.empty_cache()

    # (d) elastic restart from the compressed step's state: its int8 error
    # feedback (opt["err"], a partial sum over "data") rides along
    store = CheckpointStore(ckpt_dir, keep=1)
    t0 = time.perf_counter()
    store.save(kept, step=1)
    res["save_s"] = time.perf_counter() - t0
    saved = [t.full_tensor().cpu() for t in leaves(kept)]
    saved = saved if rank < 2 else None
    del kept
    torch.cuda.empty_cache()
    shape, axes = plan_mesh(2, model_size=MESH_TRAIN[0][1])
    small = remesh([0, 1], model_size=MESH_TRAIN[0][1],
                   device_type=MESH_DEVICE)
    res["plan"] = [list(shape), list(axes)]
    if rank >= 2:
        return res
    tmpl = abstract_state(cfg, compress=True)
    t0 = time.perf_counter()
    restored, at = store.restore_latest(
        tmpl, placements=shard.named(state_specs(tmpl, small), small))
    res["restore_s"] = time.perf_counter() - t0
    res["restored_bit_equal"] = all(
        torch.equal(a.full_tensor().cpu(), b)
        for a, b in zip(leaves(restored), saved))
    res["restored_mesh"] = list(small.shape)
    half = {k: v[:2] for k, v in batch.items()}
    (new, m), secs = timed(lambda: make_train_step(
        cfg, grad_accum=ga, grad_sync="late", mesh=small, compress=True)(
            restored, half))
    res["after_restore"] = {
        "step": at, "loss": float(m["loss"]), "step_s": secs,
        "finite": bool(torch.isfinite(m["loss"]))
        and all(bool(torch.isfinite(t.to_local()).all())
                for t in leaves(new["params"]))}
    return res


def nccl_rank(rank, world) -> dict:
    """(c) The late-sync step on a (1, 1) NCCL mesh of one rank against the
    unsharded step, and ``compressed_psum`` against ``quantize_ef``."""
    from repro_torch.core.tree import leaves
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import init_state, make_train_step
    from repro_torch.optim import compress

    dev = _rank_dev()
    cfg = _granite(n_layers=MESH_TRAIN_LAYERS)
    ga = MESH_TRAIN_BATCH[2]
    batch = _train_batch(cfg, dev)
    gen = lambda: torch.Generator(device=dev).manual_seed(SEED)  # noqa: E731
    new, m = make_train_step(cfg, grad_accum=ga)(
        init_state(cfg, generator=gen(), device=dev), batch)
    want = [t.clone() for t in leaves(new["params"])]
    want_g = [t.clone() for t in leaves(m["grads"])]
    want_loss = m["loss"].clone()
    del new, m
    torch.cuda.empty_cache()
    mesh = make_mesh((1, 1), ("data", "model"), device_type=MESH_DEVICE)
    new, m = make_train_step(cfg, grad_accum=ga, grad_sync="late", mesh=mesh)(
        init_state(cfg, generator=gen(), device=dev, mesh=mesh), batch)
    params_equal = all(torch.equal(a.to_local(), b)
                       for a, b in zip(leaves(new["params"]), want))
    grad_diff = [float((a.to_local() - b).abs().max())
                 for a, b in zip(leaves(m["grads"]), want_g)]
    grads_equal = not any(grad_diff)
    g = want_g[0]
    err = torch.randn(g.shape, generator=torch.Generator(device=dev)
                      .manual_seed(SEED), device=dev) * 1e-6
    got, got_err = compress.compressed_psum(g, mesh.get_group("data"), err)
    exp, exp_err = compress.quantize_ef({"g": g}, {"g": err})
    return {"backend": torch.distributed.get_backend(),
            "loss_equal": bool(torch.equal(m["loss"], want_loss)),
            "grad_max_abs_diff": grad_diff,
            "params_bit_equal": params_equal, "grads_bit_equal": grads_equal,
            "compressed_psum_bit_equal": bool(
                torch.equal(got, exp["g"]) and torch.equal(got_err,
                                                           exp_err["g"]))}


# 13e-13i: the other five families on the mesh.  13e-13h run TP = 2 on
# the (1, 2) mesh, one family after another in the same two ranks, each at
# full width (depth cut where the card's memory or the time limit forces
# it, MESH_FAMILIES' fields); 13i takes one (2, 2) late-sync step of three
# of them.  The unsharded references (bf16 with the kernels, fp32 plain)
# are computed first in this process and read by rank 0 from files.
MESH_FAMILIES = {
    "zamba2-1.2b": {},                                     # 13e, 38 layers
    "xlstm-1.3b": {},                                      # 13f, 42 + 6
    "qwen2-vl-7b": {"attn_impl": "flash"},                 # 13g, 28 layers
    "seamless-m4t-large-v2": {},                           # 13g, 24 + 24
    # 13h: 4 of 32 layers (the two ranks share the card; full depth is
    # about 93 GB of bf16 weights); at 2048 positions the 4096-slot window
    # masks nothing, so window 0 is the same function and takes flash
    "mixtral-8x7b": {"n_layers": 4, "attn_impl": "flash", "window": 0},
}
MESH_FAMILY_BATCH = (4, 2048)          # prefill rows, positions
MESH_FAMILY_PROMPT = (8, 8)            # serve loop: prompt, greedy steps
MESH_LOGIT_STRIDE = 8                  # logits held at every 8th position
# the flash and scan launches of one rank's prefill
MESH_FAMILY_LAUNCHES = {"zamba2-1.2b": {"ssm_scan": 38},
                        "xlstm-1.3b": {"ssm_scan": 42},
                        "qwen2-vl-7b": {"flash_attention": 28},
                        "seamless-m4t-large-v2": {},
                        "mixtral-8x7b": {"flash_attention": 4}}
# 13i: depths of the (2, 2) step.  Zamba2's 6 layers are the fewest that
# keep its shared block (applied every 6th); Mixtral's one layer is what
# four ranks' training state fits on one 80 GB card (about 10 GB a rank
# a layer: bf16 weights, fp32 gradient buffers, moments, activations)
MESH_TRAIN_FAMILIES = {"zamba2-1.2b": {"n_layers": 6},
                       "mixtral-8x7b": {"n_layers": 1},
                       "qwen2-vl-7b": {"n_layers": 4}}
MESH_ZAMBA_FP32 = DEPTH_CHECKS["zamba2-1.2b"]     # 13e's fp32 check
# 13e's fp32 TP = 2 prefill against the unsharded one, relative to the
# largest |logit|: the row-parallel products split their 4,096-term fp32
# sums in two, which reassociates them; at this model's residual stream
# (|x| about 118 under random weights) that moves a block's output by
# some 3e-4, and the shared block carries it to about 1.3e-4 on logits of
# 5, past an absolute 1e-4 (``block_out_diff`` is logged beside it)
MESH_FP32_REL_TOL = 1e-4
# 13h's fp32 check: Mixtral at full width and two layers (the routing
# and the experts' f split twice, each layer's flash launch on the
# rank's 16 / 4 heads), window 0 as in 13h
MESH_MIXTRAL_FP32 = {"n_layers": 2, "dtype": "float32", "attn_impl": "flash",
                     "window": 0}


def _card_memory() -> dict:
    """GiB this process holds on the card (after freeing its cache) and
    GiB free on the card, logged before a group of ranks starts."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    gib = 2 ** 30
    rec = {"this_process_allocated_gib": torch.cuda.memory_allocated() / gib,
           "this_process_reserved_gib": torch.cuda.memory_reserved() / gib,
           "card_free_gib": free / gib, "card_total_gib": total / gib}
    log("card memory before a rank group: " + json.dumps(rec))
    return rec


def _family_cfg(arch: str, fields: dict):
    import dataclasses

    from repro_torch import configs

    return dataclasses.replace(configs.get(arch), **fields)


def _family_batch(cfg, dev, rows: int, seq: int, seed: int) -> dict:
    """A prefill batch of ``rows`` x ``seq`` positions split as
    ``api.input_specs`` splits a prefill (Seamless: frames and tokens by
    ``ENC_FRACTION``; Qwen2-VL: patch embeddings and text), from a seeded
    numpy generator."""
    from repro_torch.models import api

    rng = np.random.default_rng(seed)

    def toks(n):
        return torch.as_tensor(rng.integers(0, cfg.vocab, (rows, n)),
                               device=dev)

    def feats(n):
        return torch.as_tensor(rng.standard_normal(
            (rows, n, cfg.d_model), dtype=np.float32),
            device=dev).to(torch.bfloat16)

    if cfg.family == "audio":
        se = int(seq * api.ENC_FRACTION["prefill"])
        return {"frames": feats(se), "tokens": toks(seq - se)}
    if cfg.family == "vlm":
        npat = min(cfg.n_patches, seq // 2)
        return {"patch_embeds": feats(npat), "tokens": toks(seq - npat)}
    return {"tokens": toks(seq)}


def _ref_path(arch: str, out_dir: str) -> str:
    return os.path.join(out_dir, f"mesh_ref_{arch}.pt")


@torch.inference_mode()
def mesh_family_refs(dev) -> dict:
    """The unsharded prefill of each MESH_FAMILIES model on this process's
    card, for 13e-13h: bf16 through the kernels and fp32 plain (plain scan,
    ``xla`` attention, TF32 off) on the same weights and batch, their
    logits at every MESH_LOGIT_STRIDE-th position saved for rank 0."""
    import dataclasses

    from repro_torch.launch import serve
    from repro_torch.models import api

    out = {}
    rows, seq = MESH_FAMILY_BATCH
    for arch, fields in MESH_FAMILIES.items():
        cfg = _family_cfg(arch, fields)
        params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(
            SEED), dev)
        batch = _family_batch(cfg, dev, rows, seq, SEED)
        prefill = serve.make_prefill_step(cfg)
        prefill(params, _family_batch(cfg, dev, 1, 256, SEED + 1))  # warm-up
        reset_all_counts()
        logits, secs = timed(lambda: prefill(params, batch))
        launches, plain = all_counts()
        bf16 = logits[:, ::MESH_LOGIT_STRIDE].float().cpu()
        del logits
        cfg32 = dataclasses.replace(cfg, dtype="float32", attn_impl="xla")
        p32 = _to(params, torch.float32)
        del params
        torch.cuda.empty_cache()
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with plain_scan():
                ref = serve.make_prefill_step(cfg32)(p32, batch)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        fp32 = ref[:, ::MESH_LOGIT_STRIDE].cpu()
        del ref, p32, batch
        torch.cuda.empty_cache()
        torch.save({"bf16": bf16, "fp32": fp32}, _ref_path(arch, OUT))
        out[arch] = {"unsharded_prefill_ms": secs * 1e3,
                     "unsharded_launches": {k: v for k, v in launches.items()
                                            if v},
                     "unsharded_plain_calls": sum(plain.values())}
        log(f"{arch} {fields}: unsharded references saved (bf16 prefill "
            f"{rows}x{seq} {secs * 1e3:.1f} ms, launches "
            f"{out[arch]['unsharded_launches']})")
    return out


def family_tp_rank(rank, world, out_dir) -> dict:
    """13e-13h: each MESH_FAMILIES model at TP = 2 on a (1, 2) mesh: the
    4x2048 prefill (kernel launches and shapes a rank, collectives by op,
    peak memory, the bf16 logits' distance to the fp32 prefill beside the
    unsharded bf16 prefill's), the serve loop on a ``cache_specs``-placed
    cache; for Zamba2 also the fp32 check at one layer against the
    unsharded model with the plain scan."""
    import dataclasses

    from repro_torch.launch import serve, shard
    from repro_torch.launch.hlo_analysis import (CommRecord,
                                                 collective_stats_from_comm)
    from repro_torch.launch.mesh import make_mesh, mesh_context
    from repro_torch.launch.train import place_state
    from repro_torch.models import api

    dev = _rank_dev()
    mesh = make_mesh(*MESH_SERVE, device_type=MESH_DEVICE)
    seen = _spy_kernels()
    rows, seq = MESH_FAMILY_BATCH
    plen, gen = MESH_FAMILY_PROMPT
    out = {}
    for arch, fields in MESH_FAMILIES.items():
        t_arch = time.perf_counter()
        cfg = _family_cfg(arch, fields)
        full = api.init_params(cfg, torch.Generator(device=dev).manual_seed(
            SEED), dev)
        params = place_state(full, shard.param_specs(full, mesh), mesh)
        del full
        torch.cuda.empty_cache()
        batch = _family_batch(cfg, dev, rows, seq, SEED)
        prefill = serve.make_prefill_step(cfg)
        res = {}
        with torch.no_grad(), mesh_context(mesh):
            prefill(params, _family_batch(cfg, dev, 1, 256, SEED + 1))
            for v in seen.values():
                v.clear()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_all_counts()                # ---- main path starts here
            with CommRecord() as comm:
                logits, secs = timed(lambda: prefill(params, batch))
            launches, plain = all_counts()    # ---- main path ends here
            res.update(prefill_ms=secs * 1e3, prefill_peak_gib=_peak_gib(dev),
                       launches={k: v for k, v in launches.items() if v},
                       plain=sum(plain.values()),
                       flash_shapes=sorted(set(seen["flash"])),
                       scan_shapes=sorted(set(seen["scan"])),
                       collectives=collective_stats_from_comm(comm))
            got = logits[:, ::MESH_LOGIT_STRIDE].full_tensor().float()
            del logits
            res["logits_shape"] = list(got.shape)
            res["logits_finite"] = bool(torch.isfinite(got).all())
            if rank == 0:
                ref = torch.load(_ref_path(arch, out_dir))
                fp32, bf16 = ref["fp32"].to(dev), ref["bf16"].to(dev)
                res["err_vs_fp32"] = {
                    "sharded": float((got - fp32).abs().max()),
                    "unsharded": float((bf16 - fp32).abs().max())}
                res["argmax_agreement"] = float(
                    (got.argmax(-1) == bf16.argmax(-1)).float().mean())
                res["logits_max_abs"] = float(fp32.abs().max())
                del fp32, bf16, ref
            del got
            torch.cuda.empty_cache()
            prompt = np.random.default_rng(SEED + 2).integers(
                0, cfg.vocab, (rows, plen))
            serve.serve_loop(cfg, params, prompt[:, :4], 2, dev, mesh=mesh)
            torch.cuda.reset_peak_memory_stats(dev)
            reset_all_counts()
            loop = serve.serve_loop(cfg, params, prompt, gen, dev, mesh=mesh)
            res.update(tokens=loop["tokens"].tolist(),
                       serve_plain=sum(all_counts()[1].values()),
                       prefill_by_decode_tokens_per_s=rows * (plen - 1)
                       / loop["prefill_s"],
                       decode_tokens_per_s=rows * gen / loop["decode_s"],
                       decode_peak_gib=_peak_gib(dev))
            if cfg.family == "ssm":
                res["slstm_ms"] = _slstm_times(cfg, params, dev)
        del params
        torch.cuda.empty_cache()
        if arch in MESH_FP32_CHECKS:
            res["fp32_check"] = MESH_FP32_CHECKS[arch](rank, mesh, dev)
        res["seconds"] = time.perf_counter() - t_arch
        out[arch] = res
    return out


def _slstm_times(cfg, params, dev) -> dict:
    """Host ms of one sLSTM block's loop over the 4x2048 prefill (the
    first block's weights, a seeded input): on the mesh (each rank's
    rows, the weights gathered once) and on the rank's card alone with
    the same weights whole."""
    from repro_torch.nn import layers as nnl
    from repro_torch.nn import recurrent as rec

    sp = {k: v[0] for k, v in params["slstm"].items()}
    rows, seq = MESH_FAMILY_BATCH
    x = torch.randn((rows, seq, cfg.d_model), generator=torch.Generator(
        device=dev).manual_seed(SEED), device=dev).to(sp["w_gates"].dtype)
    xd = nnl.replicate_like(x, sp["w_gates"])
    whole = {k: v.full_tensor() for k, v in sp.items()}
    rec.slstm_scan(xd[:, :16], sp)
    (_, _), mesh_s = timed(lambda: rec.slstm_scan(xd, sp))
    (_, _), alone_s = timed(lambda: rec.slstm_scan(x, whole))
    return {"mesh": mesh_s * 1e3, "one_card": alone_s * 1e3}


def _zamba_fp32_tp_check(rank, mesh, dev) -> dict:
    """Zamba2 at full width and one layer with its shared block, fp32, on
    4x512 tokens: the TP = 2 prefill (the fp32 route of the scan kernel on
    each rank's 16 heads) against the unsharded prefill through the same
    kernel, on rank 0 (``MESH_FP32_REL_TOL``); beside it the residual
    stream after the Mamba block sharded against unsharded, the unsharded
    kernel against the plain scan and the plain path's own spread (chunk
    64 against 128), the rounding this model amplifies."""
    from repro_torch.launch import serve, shard
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.launch.train import place_state
    from repro_torch.models import api
    from repro_torch.nn import layers as nnl
    from repro_torch.nn import zamba

    cfg = _family_cfg("zamba2-1.2b", dict(MESH_ZAMBA_FP32, dtype="float32"))
    full = api.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 1), dev)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(
        SEED + 3).integers(0, cfg.vocab, (MESH_FAMILY_BATCH[0], 512)),
        device=dev)}
    step = serve.make_prefill_step(cfg)

    def block_out(p):          # the residual stream after the Mamba block
        x = nnl.embed(batch["tokens"], p["embed"])
        return zamba._mamba_block(cfg, x, {k: v[0] for k, v in
                                           p["mamba"].items()}, 128)

    with torch.no_grad():
        params = place_state(full, shard.param_specs(full, mesh), mesh)
        with mesh_context(mesh):
            reset_all_counts()
            got = step(params, batch).full_tensor()
            launches = all_counts()[0]["ssm_scan"]
            got_block = block_out(params).full_tensor()
        res = {"launches": launches}
        if rank == 0:
            want_block = block_out(full)
            res["block_out_diff"] = float((got_block - want_block).abs().max())
            res["block_out_max_abs"] = float(want_block.abs().max())
            want = step(full, batch)
            with plain_scan():
                plain = step(full, batch)
            with plain_scan(chunk=64):
                spread = float((step(full, batch) - plain).abs().max())
            res.update(
                max_abs_diff=float((got - want).abs().max()),
                vs_unsharded_plain=float((got - plain).abs().max()),
                unsharded_kernel_vs_plain=float((want - plain).abs().max()),
                plain_chunk64_spread=spread,
                logits_max_abs=float(want.abs().max()))
    del full, params
    torch.cuda.empty_cache()
    return res


def _mixtral_fp32_tp_check(rank, mesh, dev) -> dict:
    """Mixtral at full width and two layers (``MESH_MIXTRAL_FP32``), fp32,
    on 4x512 tokens: the TP = 2 prefill (flash's fp32 route on each rank's
    heads, the routing and the experts on each rank's shard) against the
    unsharded prefill through the same kernel and against the unsharded
    model with plain attention, on rank 0 (``MESH_FP32_REL_TOL``)."""
    import dataclasses

    from repro_torch.launch import serve, shard
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.launch.train import place_state
    from repro_torch.models import api

    cfg = _family_cfg("mixtral-8x7b", MESH_MIXTRAL_FP32)
    full = api.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED + 1), dev)
    batch = {"tokens": torch.as_tensor(np.random.default_rng(
        SEED + 3).integers(0, cfg.vocab, (MESH_FAMILY_BATCH[0], 512)),
        device=dev)}
    step = serve.make_prefill_step(cfg)
    with torch.no_grad():
        params = place_state(full, shard.param_specs(full, mesh), mesh)
        if rank:
            del full
        torch.cuda.empty_cache()
        with mesh_context(mesh):
            reset_all_counts()
            got = step(params, batch).full_tensor()
            launches, plain = all_counts()
        del params
        res = {"launches": launches["flash_attention"],
               "plain": sum(plain.values())}
        if rank == 0:
            want = step(full, batch)
            xla = serve.make_prefill_step(dataclasses.replace(
                cfg, attn_impl="xla"))(full, batch)
            res.update(max_abs_diff=float((got - want).abs().max()),
                       vs_unsharded_plain=float((got - xla).abs().max()),
                       unsharded_kernel_vs_plain=float(
                           (want - xla).abs().max()),
                       argmax_agreement=float(
                           (got.argmax(-1) == xla.argmax(-1)).float().mean()),
                       logits_max_abs=float(xla.abs().max()))
            del full
    torch.cuda.empty_cache()
    return res


# the fp32 TP = 2 checks of 13e and 13h, each on its own cut-depth model
MESH_FP32_CHECKS = {"zamba2-1.2b": _zamba_fp32_tp_check,
                    "mixtral-8x7b": _mixtral_fp32_tp_check}


def family_train_rank(rank, world) -> dict:
    """13i: one (2, 2) ``grad_sync="late"`` step (``grad_accum=2``, a 4x2048
    batch from ``SyntheticLM``) of each MESH_TRAIN_FAMILIES model at full
    width: the loss, every gradient leaf finite and nonzero (checked on
    the mesh), the scan's launches and backward calls on this rank, the
    step's seconds, peak memory and collectives."""
    from repro_torch.core.tree import leaves
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.hlo_analysis import (CommRecord,
                                                 collective_stats_from_comm)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import init_state, make_train_step

    dev = _rank_dev()
    mesh = make_mesh(*MESH_TRAIN, device_type=MESH_DEVICE)
    rows, seq, ga = MESH_TRAIN_BATCH
    out = {}
    for arch, fields in MESH_TRAIN_FAMILIES.items():
        cfg = _family_cfg(arch, fields)
        state = init_state(cfg, generator=torch.Generator(
            device=dev).manual_seed(SEED), device=dev, mesh=mesh)
        torch.cuda.empty_cache()
        batch = SyntheticLM(vocab=cfg.vocab, batch=rows, seq=seq,
                            family=cfg.family, d_model=cfg.d_model,
                            n_patches=cfg.n_patches, device=dev).next()
        step = make_train_step(cfg, grad_accum=ga, grad_sync="late",
                               mesh=mesh)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_all_counts()
        with CommRecord() as comm:
            (new, m), secs = timed(lambda: step(state, batch))
        launches, plain = all_counts()
        grads = leaves(m["grads"])
        finite = [bool(torch.isfinite(g.to_local()).all()) for g in grads]
        # each leaf's largest |g| over the mesh
        peak = [float(g.float().abs().max().full_tensor()) for g in grads]
        out[arch] = {
            "loss": float(m["loss"]), "step_s": secs,
            "peak_gib": _peak_gib(dev), "plain": sum(plain.values()),
            "scan_launches": launches["ssm_scan"],
            "scan_backward_calls": launches["ssm_scan_backward"],
            "grad_leaves": len(grads), "grads_finite": all(finite),
            "zero_grad_leaves": sum(1 for p in peak if not p > 0),
            "collectives": collective_stats_from_comm(comm)}
        del state, new, m, grads
        torch.cuda.empty_cache()
    return out


def family_mesh_checks(refs, served, trained, card: str) -> dict:
    """The checks of 13e-13i on the ranks' results; logs each case."""
    res = {"refs": refs, "tp": {}, "train": trained}
    for arch, fields in MESH_FAMILIES.items():
        cfg = _family_cfg(arch, fields)
        want = dict(MESH_FAMILY_LAUNCHES[arch])
        heads = cfg.n_heads // MESH_SERVE[0][1]
        for r, ranks in enumerate(served):
            s = ranks[arch]
            if s["launches"] != want or s["plain"] or s["serve_plain"]:
                raise AssertionError(f"{arch} TP=2 rank {r}: launches "
                                     f"{s['launches']} (want {want}), plain "
                                     f"{s['plain']} + {s['serve_plain']}")
            if "ssm_scan" in want and {(q[2], v[2]) for q, v, _ in
                                       s["scan_shapes"]} != {(heads, heads)}:
                raise AssertionError(f"{arch} rank {r}: scan on heads "
                                     f"{s['scan_shapes']}, want {heads}")
            if arch == "zamba2-1.2b" and {st for _, _, st in
                                          s["scan_shapes"]} != {0}:
                raise AssertionError(f"{arch} rank {r}: q copied over the "
                                     f"heads {s['scan_shapes']}")
            if "flash_attention" in want and {
                    (q[2], k[2]) for q, k in s["flash_shapes"]} != {
                    (heads, cfg.n_kv_heads // MESH_SERVE[0][1])}:
                raise AssertionError(f"{arch} rank {r}: flash on "
                                     f"{s['flash_shapes']}")
            tok = np.asarray(s["tokens"])
            if not (s["logits_finite"] and tok.shape == (
                    MESH_FAMILY_BATCH[0], MESH_FAMILY_PROMPT[1])
                    and ((tok >= 0) & (tok < cfg.vocab)).all()):
                raise AssertionError(f"{arch} rank {r}: logits finite "
                                     f"{s['logits_finite']}, tokens "
                                     f"{tok.shape}")
        s = served[0][arch]
        e = s["err_vs_fp32"]
        if not e["sharded"] <= LOGITS_FLASH_VS_XLA * e["unsharded"]:
            raise AssertionError(f"{arch} TP=2 logits vs fp32: "
                                 f"{e['sharded']} > {LOGITS_FLASH_VS_XLA} x "
                                 f"{e['unsharded']} (unsharded)")
        if arch == "zamba2-1.2b":
            f = s["fp32_check"]
            if not (f["max_abs_diff"] <= MESH_FP32_REL_TOL
                    * f["logits_max_abs"] and f["launches"] == 1):
                raise AssertionError(f"{arch} fp32 TP=2 at one layer: {f}")
        if arch == "mixtral-8x7b":
            f = s["fp32_check"]
            if not (max(f["max_abs_diff"], f["vs_unsharded_plain"])
                    <= MESH_FP32_REL_TOL * f["logits_max_abs"]
                    and f["launches"] == MESH_MIXTRAL_FP32["n_layers"]
                    and f["plain"] == 0):
                raise AssertionError(f"{arch} fp32 TP=2 at two layers: {f}")
        res["tp"][arch] = {"fields": fields, "ranks": [
            {k: v for k, v in ranks[arch].items() if k != "tokens"}
            for ranks in served]}
        log(f"phase 13{'efggh'[list(MESH_FAMILIES).index(arch)]}, {arch} "
            f"{fields} TP=2 ({SHARED}, {card}): prefill "
            f"{MESH_FAMILY_BATCH[0]}x{MESH_FAMILY_BATCH[1]} "
            f"{[round(x[arch]['prefill_ms'], 1) for x in served]} ms a rank "
            f"(unsharded {refs[arch]['unsharded_prefill_ms']:.1f}); "
            f"launches a rank {s['launches']}, flash heads "
            f"{sorted({(q[2], k[2]) for q, k in s['flash_shapes']})}, scan "
            f"heads {sorted({(q[2], st) for q, _, st in s['scan_shapes']})}"
            f" (heads, q head stride); logits vs fp32 sharded "
            f"{e['sharded']}, unsharded {e['unsharded']} (largest |logit| "
            f"{s['logits_max_abs']}), argmax agreement "
            f"{s['argmax_agreement']}; decode "
            f"{s['decode_tokens_per_s']:.2f} tokens/s; collectives "
            f"{s['collectives']['counts']} bytes "
            f"{s['collectives']['bytes_by_op']}; peak "
            f"{s['prefill_peak_gib']:.2f} GiB a rank"
            + (f"; fp32 one layer: TP=2 vs unsharded (both on the kernel) "
               f"max |diff| {s['fp32_check']['max_abs_diff']}, vs the "
               f"unsharded plain scan {s['fp32_check']['vs_unsharded_plain']}"
               f" (the Mamba block's output "
               f"{s['fp32_check']['block_out_diff']} at |x| "
               f"{s['fp32_check']['block_out_max_abs']}; unsharded "
               f"kernel vs plain "
               f"{s['fp32_check']['unsharded_kernel_vs_plain']}, the plain "
               f"path's chunk-64 spread "
               f"{s['fp32_check']['plain_chunk64_spread']})"
               if arch == "zamba2-1.2b" else "")
            + (f"; fp32 two layers: TP=2 vs unsharded (both on flash) max "
               f"|diff| {s['fp32_check']['max_abs_diff']}, vs the unsharded "
               f"plain attention {s['fp32_check']['vs_unsharded_plain']} "
               f"(largest |logit| {s['fp32_check']['logits_max_abs']}; "
               f"unsharded flash vs plain "
               f"{s['fp32_check']['unsharded_kernel_vs_plain']}, argmax "
               f"agreement {s['fp32_check']['argmax_agreement']})"
               if arch == "mixtral-8x7b" else "")
            + (f"; one sLSTM block's loop (4x2048) {s['slstm_ms']} ms"
               if "slstm_ms" in s else ""))
    for arch, fields in MESH_TRAIN_FAMILIES.items():
        for r, ranks in enumerate(trained):
            t = ranks[arch]
            if not (np.isfinite(t["loss"]) and t["grads_finite"]
                    and t["zero_grad_leaves"] == 0 and t["plain"] == 0):
                raise AssertionError(f"13i {arch} rank {r}: {t}")
            if arch == "zamba2-1.2b":
                n = fields["n_layers"] * MESH_TRAIN_BATCH[2]
                if (t["scan_launches"], t["scan_backward_calls"]) != (
                        2 * n, n):
                    raise AssertionError(f"13i {arch} rank {r}: scan "
                                         f"{t['scan_launches']} launches, "
                                         f"{t['scan_backward_calls']} "
                                         f"backward launches, want "
                                         f"{2 * n}, {n}")
        t = trained[0][arch]
        log(f"phase 13i, {arch} {fields} on (2, 2), late sync, "
            f"grad_accum={MESH_TRAIN_BATCH[2]} ({SHARED}, {card}): loss "
            f"{[round(x[arch]['loss'], 4) for x in trained]}, step "
            f"{t['step_s']:.2f} s, {t['grad_leaves']} gradient leaves "
            f"finite and nonzero; scan launches / backward calls a rank "
            f"{[(x[arch]['scan_launches'], x[arch]['scan_backward_calls'])
                for x in trained]}; peak {t['peak_gib']:.2f} GiB a rank; "
            f"collectives "
            f"{t['collectives']['counts']}")
    return res


def mesh_phase(card: str) -> dict:
    """Phase 13: the multi-device slice on the card."""
    from repro_torch.launch.mesh import rank_backend, run_ranks

    t_phase = time.perf_counter()
    n_dev = torch.cuda.device_count()
    note = (f"{SHARED}: {MESH_SERVE[0]} and {MESH_TRAIN[0]} meshes over "
            f"{n_dev} card(s), {card}")
    res = {"note": note, "card": card}
    kw = dict(device_type=MESH_DEVICE, timeout_s=MESH_PG_TIMEOUT_S)

    t0 = time.perf_counter()
    served = run_ranks(tp_serve_rank, 2, (os.path.join(OUT, GRANITE_REF),),
                       **kw)
    res["tp_serve"] = {"seconds": time.perf_counter() - t0,
                       "ranks": served}
    cfg = _granite()
    per_rank = cfg.n_heads // 2, cfg.n_kv_heads // 2
    for r, s in enumerate(served):
        if s["backend"] != rank_backend(2, MESH_DEVICE):
            raise AssertionError(f"rank {r} ran {s['backend']}")
        if s["launches"].get("flash_attention") != cfg.n_layers or any(
                s["plain"].values()):
            raise AssertionError(f"TP prefill rank {r}: launches "
                                 f"{s['launches']}, plain {s['plain']}")
        shapes = {(q[2], k[2]) for q, k in s["flash_shapes"]}
        if shapes != {per_rank}:
            raise AssertionError(f"TP prefill rank {r}: flash on heads "
                                 f"{shapes}, want {per_rank}")
        if s["prefill_ops"] != ["all-reduce"]:
            raise AssertionError(f"TP prefill rank {r} issued "
                                 f"{s['prefill_ops']}: a weight gather")
        if not (s["fp32_prefill_err"] <= FP32_PREFILL_TOL
                and s["fp32_decode_err"] <= FP32_PREFILL_TOL
                and s["fp32_token_flips"] == 0
                and s.get("fp32_first_divergence", {"near_tie": True})[
                    "near_tie"]):
            raise AssertionError(
                f"fp32 TP rank {r}: prefill {s['fp32_prefill_err']}, "
                f"decode {s['fp32_decode_err']}, tokens flipped away from "
                f"a tie {s['fp32_token_flips']}, free-running tokens part "
                f"{s.get('fp32_first_divergence')}")
    e = served[0]["err_vs_fp32"]
    if not e["sharded"] <= LOGITS_FLASH_VS_XLA * e["unsharded"]:
        raise AssertionError(f"TP prefill logits vs fp32: {e['sharded']} > "
                             f"{LOGITS_FLASH_VS_XLA} x {e['unsharded']}")
    tok = np.asarray(served[0]["tokens"])
    if tok.shape != (GRANITE_PREFILL[0], 32) or not (
            (tok >= 0) & (tok < cfg.vocab)).all():
        raise AssertionError(f"TP serve loop tokens {tok.shape}")
    log(f"phase 13a, Granite-8B TP=2 ({note}): prefill "
        f"{GRANITE_PREFILL[0]}x{GRANITE_PREFILL[1]} "
        f"{served[0]['prefill_ms']:.1f} ms; {per_rank[0]} q / {per_rank[1]} "
        f"kv heads a rank, {cfg.n_layers} flash launches a rank; logits vs "
        f"fp32 sharded {e['sharded']}, unsharded {e['unsharded']}; "
        f"relative distance to the unsharded prefill "
        f"{served[0]['sharded_vs_unsharded']}, argmax agreement "
        f"{served[0]['argmax_agreement']}; decode "
        f"{served[0]['decode_tokens_per_s']:.1f} tokens/s; fp32 "
        f"{MESH_FP32_LAYERS} layers: prefill max |diff| "
        f"{served[0]['fp32_prefill_err']}, teacher-forced decode "
        f"{served[0]['fp32_decode_err']}, the unsharded greedy tokens kept "
        f"({served[0]['fp32_near_ties']} near ties in {4 * 8} generated "
        f"tokens, smallest top-2 margin {served[0]['fp32_min_margin']}), "
        f"free-running greedy tokens equal: "
        f"{served[0]['fp32_greedy_equal']}, first parting "
        f"{served[0].get('fp32_first_divergence')}")

    t0 = time.perf_counter()
    ckpt = os.path.join(OUT, "mesh_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    trained = run_ranks(train_rank, 4, (ckpt,), **kw)
    shutil.rmtree(ckpt, ignore_errors=True)
    res["train"] = {"seconds": time.perf_counter() - t0, "ranks": trained}
    t = trained[0]
    ga = MESH_TRAIN_BATCH[2]
    for name, run in t["runs"].items():
        if abs(run["loss"] - t["unsharded_loss"]) > MESH_LOSS_TOL or run[
                "params_outside_tol"]:
            raise AssertionError(f"(2, 2) {name} step vs unsharded: {run}")
    auto = t["runs"]["auto"]["grad_sync"]
    late = t["runs"]["late"]["grad_sync"]
    if auto["bytes_by_op"].get("all-reduce") != ga * late["bytes_by_op"].get(
            "all-reduce", -1):
        raise AssertionError(f"late sync bytes {late} vs auto {auto}")
    if not t["compressed_grad_rel"] < MESH_COMPRESS_REL_TOL:
        raise AssertionError(f"compressed grads {t['compressed_grad_rel']}")
    if not (t["restored_bit_equal"] and t["after_restore"]["finite"]
            and t["plan"] == [[1, 2], ["data", "model"]]):
        raise AssertionError(f"elastic restore: {t}")
    log(f"phase 13b/d, Granite-8B {MESH_TRAIN_LAYERS} layers on (2, 2) "
        f"({note}): loss unsharded {t['unsharded_loss']}, "
        + ", ".join(f"{n} {r['loss']} ({r['step_s']:.2f} s/step)"
                    for n, r in t["runs"].items())
        + f"; gradient all-reduce bytes over the data group: auto "
        f"{auto['bytes_by_op']['all-reduce']}, late "
        f"{late['bytes_by_op']['all-reduce']} (1/{ga}); compressed grads "
        f"rel {t['compressed_grad_rel']}; the compressed step's state (its "
        f"int8 error feedback included) restored onto (1, 2) bit-equal, "
        f"save {t['save_s']:.1f} s, restore {t['restore_s']:.1f} s")

    t0 = time.perf_counter()
    nccl = run_ranks(nccl_rank, 1, (), **kw)[0]
    res["nccl"] = {**nccl, "seconds": time.perf_counter() - t0}
    if nccl["backend"] != "nccl" or not all(
            nccl[k] for k in ("loss_equal", "params_bit_equal",
                              "grads_bit_equal",
                              "compressed_psum_bit_equal")):
        raise AssertionError(f"NCCL (1, 1): {nccl}")
    log(f"phase 13c: NCCL (1, 1) late-sync step bit-equal to the unsharded "
        f"one, compressed_psum bit-equal to quantize_ef")

    t0 = time.perf_counter()
    refs = mesh_family_refs(torch.device("cuda"))
    t1 = time.perf_counter()
    res["card_memory_before_families"] = _card_memory()
    served = run_ranks(family_tp_rank, 2, (OUT,), **kw)
    t2 = time.perf_counter()
    # four ranks' training states share the card: the allocator grows
    # segments in place rather than keeping freed blocks of each size
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    res["card_memory_before_family_train"] = _card_memory()
    trained = run_ranks(family_train_rank, 4, (), **kw)
    for arch in MESH_FAMILIES:
        os.remove(_ref_path(arch, OUT))
    res["families"] = family_mesh_checks(refs, served, trained, card)
    res["families"]["seconds"] = {"references": t1 - t0, "tp": t2 - t1,
                                  "train": time.perf_counter() - t2}
    log(f"phase 13e-13i took {time.perf_counter() - t0:.1f} s "
        f"({json.dumps(res['families']['seconds'])})")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"mesh phase took {res['seconds']:.1f} s")
    return res


def main() -> int:
    global OUT
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=OUT, help="directory for the per-launch "
                    "times and the profiler trace (default: smoke_out/)")
    args = ap.parse_args()
    OUT = os.path.abspath(args.out)
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
    _kernel_ops()[2].bw_library()
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
    serving = serving_phase(models, tuned.pop("profile"), dev, card)
    zoo_cnn = zoo_cnn_phase(models, dev, card)
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
    t0 = time.perf_counter()
    seamless = seamless_phase(dev, card)
    log(f"{SEAMLESS} serving on {card} ({time.perf_counter() - t0:.1f} s): "
        + json.dumps(seamless))
    scan_bw = scan_backward_phase(dev)
    training = training_phase(dev, card)
    zt = training["zamba2"]
    span = zt["train_step_profile"].get("device_span_ms_per_call")
    # the backward's kernels at the step's microbatch shape, times its
    # launches a step, over the profiled step's device span
    zt["scan_backward_share_of_step"] = (
        zt["launches_per_step"]["ssm_scan_backward"]
        * scan_bw["zamba2-1.2b"]["kernel_backward_ms"] / span
        if span else "not measured")
    log(f"{ZAMBA} train step: the scan backward's kernels take "
        f"{zt['scan_backward_share_of_step']} of the step's device span "
        f"({span} ms)")
    log(f"training on {card}: " + json.dumps(
        {k: v for k, v in training.items() if k != "zamba2"}))
    log(f"phases 2-12 took {time.perf_counter() - t_start:.1f} s")
    mesh = mesh_phase(card)
    os.remove(os.path.join(OUT, GRANITE_REF))
    log(f"phases 2-13 took {time.perf_counter() - t_start:.1f} s")

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
            "library_ms": t["library_ms"],
            "serving_plane_launches": {
                "multitenant": serving["multitenant"]["kernel_launches"][
                    name],
                "fleet": serving["fleet"]["kernel_launches"][name]}})
    kernels[0].update({
        "tuned_ms_per_image": tuned["chain_ms_per_image"]["tuned"],
        "untuned_ms_per_image": tuned["chain_ms_per_image"]["untuned"],
        "tuned_vs_untuned": "chain_kernel device ms per GoogLeNet-224 image "
                            "in a profiled Session.run of the calibrated "
                            "strategy: with the tile search's records, "
                            "without, and forced to each chain's fastest "
                            "non-default candidate",
        "forced_ms_per_image": tuned["chain_ms_per_image"]["forced"],
        "tuned_launches": tuned["tile_records_applied"],
        "zoo_plans": {
            plan: {k: r[k] for k in (
                "launches_per_image", "fallbacks_per_image", "chain_lengths",
                "named_chains", "chain_ms_per_image", "chain_bound_ms",
                "chain_bound_by", "run_p50_ms", "run_p99_ms",
                "server_images_per_s", "bit_exact")}
            for plan, r in zoo_cnn.items() if plan != "seconds"},
        "zoo_plans_of": "phase 14: launches, fallbacks and chain lengths "
                        "per image of each (model, planning target), batch "
                        "1; chain_ms_per_image is CUDA-event device time "
                        "of the image's chain launches back to back"})
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
        "library_ms": flash_t["library_ms"],
        "tp_prefill_launches_per_rank": [
            r["launches"]["flash_attention"]
            for r in mesh["tp_serve"]["ranks"]],
        "tp_prefill_heads_per_rank": mesh["tp_serve"]["ranks"][0][
            "flash_shapes"],
        "family_tp_prefill_launches_per_rank": {
            arch: [r["launches"].get("flash_attention", 0) for r in
                   mesh["families"]["tp"][arch]["ranks"]]
            for arch in ("qwen2-vl-7b", "mixtral-8x7b")},
        "family_tp_shapes_per_rank": {
            arch: mesh["families"]["tp"][arch]["ranks"][0]["flash_shapes"]
            for arch in ("qwen2-vl-7b", "mixtral-8x7b")}})
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
        "family_tp_prefill_launches_per_rank": {
            arch: [r["launches"].get("ssm_scan", 0) for r in
                   mesh["families"]["tp"][arch]["ranks"]]
            for arch in ("zamba2-1.2b", "xlstm-1.3b")},
        "family_tp_shapes_per_rank": {
            arch: mesh["families"]["tp"][arch]["ranks"][0]["scan_shapes"]
            for arch in ("zamba2-1.2b", "xlstm-1.3b")},
        "paths": {arch: {"launches": recurrent[arch]["launches"]["ssm_scan"],
                         "ms": scan_t[arch]["ms"],
                         "plain_ms": scan_t[arch]["plain_ms"],
                         "bound_ms": scan_t[arch]["bound_ms"]}
                  for arch in recurrent},
    })
    zb = scan_bw["zamba2-1.2b"]
    kernels.append({
        "name": "ssm_scan_backward", "route": "cuda", "source": SCAN_BW_SOURCE,
        "kernels": ["scan_intra_kernel x 2 (P, D) + scan_state_kernel x 3 "
                    "(dq forward, dv and dk in reverse) + scan_dla_kernel "
                    "(bf16, mma.sync with hi/lo splits; the main path)",
                    "ssm_scan_kernel x 3 + scan_dla_kernel (fp32 and fp16, "
                    "CUDA cores)"],
        "replaces": SCAN_REPLACES + " (its backward: the TPU kernel has "
                                    "none; the reference differentiates "
                                    "plain jnp)",
        "launches": training["zamba2"]["launches_per_step"][
            "ssm_scan_backward"],
        "launches_of": "one Zamba2-1.2B train step (phase 12a's last)",
        "max_abs_err": max(e["max_abs"] for n, e in
                           scan_bw["errors"].items() if "float32" in n),
        "max_abs_err_of": "fp32 gradients against autograd through "
                          "chunked_linear_scan, over BW_CASES",
        "ms": zb["ms"], "plain_ms": zb["plain_ms"],
        "bound_ms": zb["bound_ms"], "bound_by": zb["bound_by"],
        "library_ms": None,
        "function": "gradient of (q0, k0, v, log_a) through ScanFunction "
                    "(bf16, training microbatch 2x2048; ms at Zamba2-1.2B's "
                    "shape, both shapes under paths); bound_ms from the "
                    "function's least work, impl_bytes/impl_flops what the "
                    "kernels move and compute",
        "per_train_step": {
            arch: {"forward_launches": training[key][
                       "launches_per_step"]["ssm_scan"],
                   "backward_launches": training[key][
                       "launches_per_step"]["ssm_scan_backward"]}
            for arch, key in ((ZAMBA, "zamba2"), (XLSTM, "xlstm"))},
        "family_train_per_rank": {
            arch: [(r[arch]["scan_launches"],
                    r[arch]["scan_backward_calls"])
                   for r in mesh["families"]["train"]]
            for arch in ("zamba2-1.2b",)},
        "max_rel_err": scan_bw["errors"],
        "paths": {arch: scan_bw[arch] for arch in ("xlstm-1.3b",
                                                   "zamba2-1.2b")}})
    checked["artifact"] = served["artifact"]
    checked["tune"] = tuned
    checked["serving_plane"] = serving
    checked["zoo_cnn"] = zoo_cnn
    checked["flash_max_abs_err"] = flash_errs
    checked["ssm_scan_err"] = scan_errs
    checked["seamless"] = seamless
    checked["training"] = {k: v for k, v in training.items()
                           if k != "zamba2"}
    checked["mesh"] = mesh
    for r in mesh["tp_serve"]["ranks"]:
        r.pop("tokens")
    checked["training"]["zamba2"] = {
        k: v for k, v in training["zamba2"].items()
        if k not in ("train_step_profile", "grad_norms_step1")}
    print(json.dumps({"kernels": kernels, "checked": checked,
                      "card": card}), flush=True)
    print(smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
