# Ported from src/repro/launch/train.py (jax -> torch).
"""Training step factory + command-line entry point.

``make_train_step(cfg, ...)`` returns a (state, batch) -> (state, metrics)
function:

* gradient accumulation over ``grad_accum`` microbatches (a loop over row
  slices of the batch): the logits, the memory peak at a large vocab, only
  ever exist per microbatch;
* grads from ``torch.autograd.grad``, accumulated in ``grad_dtype`` buffers
  (fp32 by default), not in bf16 ``.grad``;
* AdamW (``optim.adamw``) over the parameter dictionary, with ZeRO-1
  moments on a mesh (``shard.moment_specs``);
* on a mesh, the gradient sync ``grad_sync`` names, optionally int8
  compressed (``optim.compress``).

The state is ``{"params", "opt": {"m", "v", "step"}}``, nested dictionaries
of tensors — DTensors placed by ``state_specs`` on a mesh (``init_state(...,
mesh=)``); a step returns a new one.  With ``compress=True`` the state also
holds the int8 error-feedback buffers, ``opt["err"]`` (``init_state(...,
compress=True)``), so checkpoints and re-meshing carry them.

CLI (CUDA unless ``--device cpu``):

    python -m repro_torch.launch.train --arch zamba2-1.2b --smoke \\
        --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed._functional_collectives as fc
from torch.distributed.tensor import DTensor

from repro_torch.configs import get as get_cfg
from repro_torch.configs.base import ArchConfig
from repro_torch.core.executor import resolve_device
from repro_torch.core.tree import leaves, tree_map, unflatten, unzip
from repro_torch.launch import shard
from repro_torch.launch.hlo_analysis import comm_label
from repro_torch.launch.mesh import (axis_names, data_axes, mesh_context,
                                     mesh_dims)
from repro_torch.models import api
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_moments
from repro_torch.optim.compress import compressed_psum, init_error


def make_train_step(cfg: ArchConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    grad_accum: int = 1, grad_dtype: str = "float32",
                    grad_sync: str = "auto", mesh=None,
                    compress: bool = False):
    """grad_sync (with ``mesh``; on one card only "auto" exists):
    "auto" — DTensor carries the placements: each microbatch's weight
             grads come out of autograd as partial sums over the data axes
             and are all-reduced into the fp32 buffers, once per
             MICROBATCH (what XLA does in the reference).
    "late" — the microbatch loop runs on each data rank's own rows with the
             params on the model axis only (the counterpart of
             ``shard_map`` over the data axes): grads accumulate locally
             and take ONE mean all-reduce over the data group per step —
             gradient all-reduce bytes / grad_accum.  ``compress=True``
             syncs them through ``compressed_psum`` instead (int8 payload,
             error feedback in ``state["opt"]["err"]``: each data rank's
             residual, a partial sum over the data axes).

    With a mesh, the batch may be plain tensors (the global batch, the same
    on every rank) or DTensors placed by ``shard.batch_specs``.  Microbatch
    i is the i-th slice of every data rank's own rows, so no rows move
    between ranks; the step's mean gradient is the global batch's either
    way."""
    if grad_sync not in ("auto", "late"):
        raise ValueError(f"unknown grad_sync {grad_sync!r}")
    if (grad_sync == "late" or compress) and mesh is None:
        raise ValueError(f"grad_sync={grad_sync!r}, compress={compress} "
                         f"need the mesh")
    if compress and grad_sync != "late":
        raise ValueError("compress=True syncs through grad_sync='late'")
    gdt = getattr(torch, grad_dtype)
    dp = data_axes(mesh) if mesh is not None else ()

    def value_and_grad(params, mb):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        with torch.enable_grad():
            loss = api.loss_fn(cfg, unflatten(params, flat), mb)
            grads = torch.autograd.grad(loss, flat)
        return loss.detach(), unflatten(params, grads)

    def accum_grads(params, batch, sync_each=False):
        acc = tree_map(lambda p: _zeros_like(p, gdt), params)
        lsum = 0.0
        for mb in split_batch(batch):
            l, g = value_and_grad(params, mb)
            with comm_label("grad_sync" if sync_each else "grad_shard"):
                g = tree_map(lambda a, b: _placed_like(b.to(gdt), a), acc, g)
            tree_map(lambda a, b: a.add_(b), acc, g)
            del g
            lsum = lsum + l
        return (tree_map(lambda a: a / grad_accum, acc), lsum / grad_accum)

    def split_batch(batch):
        """``grad_accum`` microbatches: slices of consecutive rows, each
        data rank's own where the batch is placed on a mesh."""
        n = _local(next(iter(batch.values()))).shape[0]
        if n % grad_accum:
            raise ValueError(f"batch of {n} rows per rank does not split "
                             f"into {grad_accum} microbatches")
        m = n // grad_accum
        return [{k: _rows(v, i * m, (i + 1) * m) for k, v in batch.items()}
                for i in range(grad_accum)]

    def placed_batch(batch):
        return {k: v if isinstance(v, DTensor) else shard.named(
            shard.batch_specs(v, mesh), mesh).place(v)
            for k, v in batch.items()}

    def late_grads(params, batch, err):
        """The local microbatch loop on the model axis, then one sync.
        Returns (grads, loss, new error buffers or None)."""
        sub = mesh["model"] if "model" in axis_names(mesh) else None
        local_params = tree_map(lambda p: _on_model_axis(p, sub), params)
        local_batch = {k: v.to_local() for k, v in batch.items()}
        with mesh_context(sub):
            acc, lval = accum_grads(local_params, local_batch)
        group = _data_group(mesh, dp)
        n = _dp_size(mesh)
        with comm_label("grad_sync"):
            if compress:
                synced, new_err = unzip(tree_map(
                    lambda a, e: compressed_psum(_local(a), group,
                                                 _local(e)), acc, err), 2)
                err = tree_map(lambda e, t: DTensor.from_local(
                    e, t.device_mesh, t.placements, shape=t.shape,
                    stride=t.stride()), new_err, err)
            else:
                synced = tree_map(lambda a: fc.all_reduce(
                    _local(a), "sum", group) / n, acc)
        lloc = _local(_full(lval))
        lval = fc.all_reduce(lloc, "sum", group) / n
        grads = tree_map(lambda g, p: DTensor.from_local(
            g, p.device_mesh, p.placements, shape=p.shape,
            stride=p.stride()), synced, params)
        return grads, lval, err

    def train_step(state, batch):
        params, opt = state["params"], state["opt"]
        if compress and "err" not in opt:
            raise ValueError("compress=True keeps its error feedback in the "
                             "state: init_state(..., compress=True)")
        with mesh_context(mesh):
            if mesh is not None:
                batch = placed_batch(batch)
            if grad_sync == "late":
                grads, lval, err = late_grads(params, batch, opt.get("err"))
            elif grad_accum > 1 or mesh is not None:
                grads, lval = accum_grads(params, batch,
                                          sync_each=mesh is not None)
            else:
                lval, grads = value_and_grad(params, batch)
            new_params, new_opt = adamw_update(params, grads, opt, opt_cfg)
        if "err" in opt:          # kept as it was by an uncompressed step
            new_opt["err"] = err if compress else opt["err"]
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in leaves(grads)))
        return ({"params": new_params, "opt": new_opt},
                {"loss": _full(lval), "grad_norm": _full(gnorm),
                 "step": _full(new_opt["step"]), "grads": grads})

    return train_step


# ----------------------------------------------------------- mesh helpers
def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _rows(t, a: int, b: int):
    """Rows [a, b) of each rank's own rows of ``t``."""
    if not isinstance(t, DTensor):
        return t[a:b]
    loc = t.to_local()[a:b]
    shape = (t.shape[0] * (b - a) // t.to_local().shape[0],) + tuple(
        t.shape[1:])
    return DTensor.from_local(loc, t.device_mesh, t.placements, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _zeros_like(p, dtype):
    if not isinstance(p, DTensor):
        return torch.zeros(p.shape, dtype=dtype, device=p.device)
    return DTensor.from_local(torch.zeros(p.to_local().shape, dtype=dtype,
                                          device=p.to_local().device),
                              p.device_mesh, p.placements, shape=p.shape,
                              stride=p.stride())


def _placed_like(g, ref):
    """A gradient with the placements of ``ref`` (its buffer): the model
    axis first (a partial sum there is reduce-scattered to the shard),
    then the data axes, whose partial sums are all-reduced on the shard."""
    if not isinstance(g, DTensor) or g.placements == ref.placements:
        return g
    dp = data_axes(ref.device_mesh)
    names = axis_names(ref.device_mesh)
    first = [p if n in dp else r
             for n, p, r in zip(names, g.placements, ref.placements)]
    if tuple(first) != tuple(g.placements):
        g = g.redistribute(ref.device_mesh, first)
    return g.redistribute(ref.device_mesh, ref.placements)


def _on_model_axis(p, sub):
    """A param placed on the whole mesh (replicated over the data axes) as
    a DTensor on the model axis alone (the same local shard), or its local
    tensor where the mesh has no model axis."""
    if sub is None:
        return p.to_local()
    names = axis_names(p.device_mesh)
    return DTensor.from_local(p.to_local(), sub,
                              [p.placements[names.index("model")]],
                              shape=p.shape, stride=p.stride())


def _data_group(mesh, dp):
    if len(dp) == 1:
        return mesh.get_group(dp[0])
    return mesh[dp]._flatten("dp").get_group()


def _dp_size(mesh) -> int:
    md = mesh_dims(mesh)
    n = 1
    for a in data_axes(mesh):
        n *= md[a]
    return n


def init_state(cfg: ArchConfig, opt_cfg: AdamWConfig = AdamWConfig(),
               generator: torch.Generator | None = None, device=None,
               mesh=None, compress: bool = False):
    """Seeded params and zero moments (and, with ``compress``, zero fp32
    error-feedback buffers ``opt["err"]``); on ``mesh``, each leaf placed
    by ``state_specs`` (every rank draws the same full tensors and keeps
    its shard)."""
    params = api.init_params(cfg, generator, device)
    state = {"params": params, "opt": _opt_state(params, opt_cfg, compress)}
    if mesh is None:
        return state
    return place_state(state, state_specs(state, mesh), mesh)


def place_state(state, specs, mesh):
    """Full tensors (the same on every rank) placed on ``mesh`` by
    ``specs``: each rank keeps its shard, nothing is sent."""
    return tree_map(lambda t, n: n.place(t), state, shard.named(specs, mesh))


def abstract_state(cfg: ArchConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                   compress: bool = False):
    """The train state as ``meta`` tensors (no allocation)."""
    params = api.abstract_params(cfg)
    return {"params": params, "opt": _opt_state(params, opt_cfg, compress)}


def _opt_state(params, opt_cfg: AdamWConfig, compress: bool) -> dict:
    opt = init_moments(params, opt_cfg)
    if compress:
        opt["err"] = init_error(params)
    return opt


def state_specs(state_abstract, mesh):
    """Sharding specs for the full train state (params TP, moments ZeRO-1,
    error-feedback buffers where the state has them: ``shard.error_specs``)."""
    opt = state_abstract["opt"]
    specs = {"m": shard.moment_specs(opt["m"], mesh),
             "v": shard.moment_specs(opt["v"], mesh),
             "step": shard.P()}
    if "err" in opt:
        specs["err"] = shard.error_specs(opt["err"], mesh)
    return {"params": shard.param_specs(state_abstract["params"], mesh),
            "opt": specs}


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
