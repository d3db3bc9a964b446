# Ported from src/repro/launch/train.py (jax -> torch).
"""Training step factory + command-line entry point.

``make_train_step(cfg, ...)`` returns a (state, batch) -> (state, metrics)
function:

* gradient accumulation over ``grad_accum`` microbatches (a loop over row
  slices of the batch): the logits, the memory peak at a large vocab, only
  ever exist per microbatch;
* grads from ``torch.autograd.grad``, accumulated in ``grad_dtype`` buffers
  (fp32 by default), not in bf16 ``.grad``;
* AdamW (``optim.adamw``) over the parameter dictionary.

The state is ``{"params", "opt": {"m", "v", "step"}}``, nested dictionaries
of tensors; a step returns a new one.  On one card ``split_batch``'s
sharding constraint is the identity.  ``grad_sync="late"``, ``mesh=`` and
``state_specs`` need a process group and wait for the multi-device slice
(ROADMAP, Queue 1 item 8b).

CLI (CUDA unless ``--device cpu``):

    python -m repro_torch.launch.train --arch zamba2-1.2b --smoke \\
        --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get as get_cfg
from repro_torch.configs.base import ArchConfig
from repro_torch.core.executor import resolve_device
from repro_torch.core.tree import leaves, tree_map, unflatten
from repro_torch.models import api
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_moments

MULTI_DEVICE = ("needs a process group: it waits for the multi-device slice "
                "(ROADMAP, Queue 1 item 8b)")


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    grad_accum: int = 1, grad_dtype: str = "float32",
                    grad_sync: str = "auto", mesh=None):
    """grad_sync: "auto" (the only one on one card); "late" raises."""
    if grad_sync == "late" or mesh is not None:
        raise NotImplementedError(f"grad_sync='late' and mesh= {MULTI_DEVICE}")
    if grad_sync != "auto":
        raise ValueError(f"unknown grad_sync {grad_sync!r}")
    gdt = getattr(torch, grad_dtype)

    def value_and_grad(params, mb):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        with torch.enable_grad():
            loss = api.loss_fn(cfg, unflatten(params, flat), mb)
            grads = torch.autograd.grad(loss, flat)
        return loss.detach(), unflatten(params, grads)

    def accum_grads(params, batch):
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=gdt,
                                             device=p.device), params)
        lsum = 0.0
        for mb in split_batch(batch):
            l, g = value_and_grad(params, mb)
            tree_map(lambda a, b: a.add_(b.to(gdt)), acc, g)
            del g
            lsum = lsum + l
        return (tree_map(lambda a: a / grad_accum, acc), lsum / grad_accum)

    def split_batch(batch):
        """The batch as ``grad_accum`` microbatches of consecutive rows."""
        n = next(iter(batch.values())).shape[0]
        if n % grad_accum:
            raise ValueError(f"batch {n} does not split into {grad_accum} "
                             f"microbatches")
        m = n // grad_accum
        return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                for i in range(grad_accum)]

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        if grad_accum > 1:
            grads, lval = accum_grads(params, batch)
        else:
            lval, grads = value_and_grad(params, batch)
        new_params, new_opt = adamw_update(params, grads, opt, opt_cfg)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in leaves(grads)))
        return ({"params": new_params, "opt": new_opt},
                {"loss": lval, "grad_norm": gnorm, "step": new_opt["step"],
                 "grads": grads})

    return train_step


def init_state(cfg: ArchConfig, opt_cfg: AdamWConfig = AdamWConfig(),
               generator: torch.Generator | None = None, device=None):
    params = api.init_params(cfg, generator, device)
    return {"params": params, "opt": init_moments(params, opt_cfg)}


def abstract_state(cfg: ArchConfig, opt_cfg: AdamWConfig = AdamWConfig()):
    """The train state as ``meta`` tensors (no allocation)."""
    params = api.abstract_params(cfg)
    return {"params": params, "opt": init_moments(params, opt_cfg)}


def state_specs(state_abstract, mesh):
    raise NotImplementedError(f"state_specs {MULTI_DEVICE}")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_cfg(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    from repro_torch.data.pipeline import SyntheticLM

    data = SyntheticLM(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                       family=cfg.family, d_model=cfg.d_model,
                       n_patches=cfg.n_patches, device=dev)
    state = init_state(cfg, device=dev)                  # seed 0
    step_fn = make_train_step(cfg, grad_accum=args.grad_accum)
    ckpt, start = None, 0
    if args.checkpoint_dir:
        from repro_torch.checkpoint.store import CheckpointStore

        ckpt = CheckpointStore(args.checkpoint_dir)
        restored = ckpt.restore_latest(state, dev)
        if restored is not None:
            state, start = restored
            data.seek(start)
            print(f"restored checkpoint at step {start}")
    losses = []
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        state, metrics = step_fn(state, data.next())
        losses.append(float(metrics["loss"]))
        if (i + 1) % 10 == 0:
            dt = (time.perf_counter() - t0) / (i + 1 - start)
            print(f"step {i+1:5d} loss {losses[-1]:.4f}  "
                  f"{dt*1e3:.1f} ms/step")
        if ckpt and (i + 1) % args.checkpoint_every == 0:
            ckpt.save(state, step=i + 1, async_write=True)
    if ckpt:
        ckpt.save(state, step=args.steps)
        ckpt.wait()
    if losses:
        print(f"final loss {losses[-1]:.4f}")
    return {"state": state, "losses": losses, "start": start}


if __name__ == "__main__":
    main()
