"""The JAX reference's own fp32 rounding spread on a recurrent LM.

Runs the reference's prefill (``repro.launch.serve.make_prefill_step``) of
xLSTM or Zamba2 at full width, a cut depth and fp32 on random weights, with
the chunked linear scan at chunk 128 (the reference's), 64 and 1 (the
step-by-step recurrence), and prints the max |diff| of the chunk-64 and
chunk-1 logits to the chunk-128 ones beside the largest |logit|, as one
JSON line, on a 4x512 prompt.  The three runs differ only in the order of
their fp32 sums, so the spread is how far the model itself amplifies
last-bit differences of its scan: the PyTorch port's ``chip_smoke.py``
reads the same spread of its own plain path.  JAX only; on the CPU:

    PYTHONPATH=src JAX_PLATFORMS=cpu \\
        python tools/jax_scan_rounding_spread.py \\
        --arch zamba2-1.2b --layers 8
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs
from repro.launch import serve
from repro.models import api
from repro.nn import flags

BATCH, SEQ, SEED = 4, 512, 0    # the prompt of chip_smoke.py's fp32 checks


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="zamba2-1.2b",
                    choices=["xlstm-1.3b", "zamba2-1.2b"])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--shared-every", type=int, default=None,
                    help="Zamba2's shared_attn_every (default: the config's)")
    a = ap.parse_args()
    cfg = dataclasses.replace(configs.get(a.arch), n_layers=a.layers,
                              dtype="float32")
    if a.shared_every is not None:
        cfg = dataclasses.replace(cfg, shared_attn_every=a.shared_every)
    params = api.init_params(cfg, jax.random.PRNGKey(SEED))
    tokens = jnp.asarray(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (BATCH, SEQ)))
    chunk_for = flags.chunk_for
    logits = {}
    try:
        for chunk in (128, 64, 1):
            flags.chunk_for = lambda s, default=128, c=chunk: (c, False)
            step = jax.jit(serve.make_prefill_step(cfg))
            logits[chunk] = np.asarray(step(params, {"tokens": tokens}))
    finally:
        flags.chunk_for = chunk_for
    ref = logits[128]
    print(json.dumps({
        "arch": a.arch, "layers": a.layers,
        "shared_attn_every": cfg.shared_attn_every, "batch": BATCH,
        "seq": SEQ, "seed": SEED,
        "spread_chunk64": float(np.abs(logits[64] - ref).max()),
        "spread_chunk1": float(np.abs(logits[1] - ref).max()),
        "logits_max_abs": float(np.abs(ref).max())}))


if __name__ == "__main__":
    main()
