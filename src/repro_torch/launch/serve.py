# Ported from src/repro/launch/serve.py (jax -> torch).
"""Serving steps: prefill (logits over a full prompt batch) and decode
(one token against the KV/SSM state), plus a small batched-request loop.

    python -m repro_torch.launch.serve --arch granite-8b
    python -m repro_torch.launch.serve --arch xlstm-1.3b
    python -m repro_torch.launch.serve --arch zamba2-1.2b --smoke --device cpu
    python -m repro_torch.launch.serve --arch seamless-m4t-large-v2

Runs on CUDA unless ``--device cpu`` is given.  With DTensor params
(``shard.named(shard.param_specs(...))``) the steps run tensor-parallel,
and ``serve_loop(..., mesh=)`` places its KV cache by ``shard.cache_specs``
(kv heads over "model", batch over the data axes).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs import get as get_cfg
from repro_torch.configs.base import ArchConfig
from repro_torch.core.executor import resolve_device
from repro_torch.core.tree import tree_map
from repro_torch.launch import shard
from repro_torch.models import api
from repro_torch.nn import encdec
from repro_torch.nn.layers import gather_dim


def make_prefill_step(cfg: ArchConfig):
    """Prefill of every family: Seamless (``audio``) encodes
    ``batch["frames"]`` and decodes ``batch["tokens"]`` against it; the
    others run their ``forward`` (``ssm`` and ``hybrid`` take no patch
    embeddings, which a text batch does not carry)."""
    mod = api._mod(cfg)

    def prefill(params, batch):
        if cfg.family == "audio":
            enc_out = encdec.encode(cfg, params, batch["frames"])
            return encdec.decode_train(cfg, params, enc_out, batch["tokens"])
        return mod.forward(cfg, params, batch["tokens"],
                           batch.get("patch_embeds"))[0]

    return prefill


def make_serve_step(cfg: ArchConfig):
    def serve_step(params, cache, tokens, pos):
        logits, cache = api.decode_step(cfg, params, cache, tokens, pos)
        # vocab-sharded logits are gathered first: DTensor's argmax over a
        # sharded dim fails for a batch of one on a two-axis mesh
        next_tok = torch.argmax(gather_dim(logits, -1), dim=-1).to(
            torch.int32)
        if isinstance(next_tok, DTensor):     # (B,) ids: every rank's
            next_tok = next_tok.full_tensor()
        return next_tok, cache

    return serve_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device=None,
               mesh=None):
    """``api.init_cache``, placed on ``mesh`` by ``shard.cache_specs``
    where one is given (each rank keeps its shard of the zeros)."""
    cache = api.init_cache(cfg, batch, max_len, device)
    if mesh is None:
        return cache
    return tree_map(lambda t, n: n.place(t), cache,
                    shard.named(shard.cache_specs(cache, cfg, mesh), mesh))


def serve_loop(cfg: ArchConfig, params, prompt, gen_len: int, device=None,
               mesh=None):
    """``main``'s request loop: the prompt (B, P) is fed token by token
    through the decode step (teacher-forced prefill-by-decode, which fills
    the cache), then ``gen_len`` tokens are decoded greedily.  On ``mesh``
    (DTensor params) the cache is placed by ``shard.cache_specs``.

    Returns {"tokens": (B, gen_len) int32 numpy, "prefill_s", "decode_s"}
    (host seconds, each ending in a device synchronize).  Runs under
    ``inference_mode``, or ``no_grad`` on a mesh (DTensor ops cannot
    take inference tensors)."""
    with torch.no_grad() if mesh is not None else torch.inference_mode():
        return _serve_loop(cfg, params, prompt, gen_len, device, mesh)


def _serve_loop(cfg, params, prompt, gen_len, device, mesh):
    dev = resolve_device(device)
    b, plen = prompt.shape
    max_len = plen + gen_len
    cache = init_cache(cfg, b, max_len, dev, mesh)
    serve = make_serve_step(cfg)
    prompt = torch.as_tensor(np.asarray(prompt, np.int64), device=dev)
    t0 = time.perf_counter()
    for p in range(plen - 1):
        _, cache = serve(params, cache, prompt[:, p], p)
    _sync(dev)
    t1 = time.perf_counter()
    out = []
    tok = prompt[:, -1]
    for p in range(plen - 1, max_len - 1):
        tok, cache = serve(params, cache, tok, p)
        out.append(tok)
    out = torch.stack(out, 1).cpu().numpy()
    t2 = time.perf_counter()
    return {"tokens": out, "prefill_s": t1 - t0, "decode_s": t2 - t1}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_cfg(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    params = api.init_params(cfg, device=dev)        # seed 0
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
    res = serve_loop(cfg, params, prompt, args.gen_len, dev)
    B, toks = args.batch, (args.prompt_len + args.gen_len - 1) * args.batch
    dt = res["prefill_s"] + res["decode_s"]
    print(f"generated {args.gen_len} steps x {B} seqs "
          f"({toks / dt:.1f} tok/s incl. prefill-by-decode)")
    print("sample:", res["tokens"][0][:16])
    return res


if __name__ == "__main__":
    main()
