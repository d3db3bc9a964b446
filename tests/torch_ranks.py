"""Rank programs of the port's multi-process CPU tests.

    python tests/torch_ranks.py CASE IN_DIR OUT_FILE

runs CASE on spawned gloo CPU ranks (``launch.mesh.run_ranks``; one thread
each, 60 s per collective) and pickles what rank 0 returns to OUT_FILE.
IN_DIR holds the inputs the test made with numpy and the JAX package
(``params.npz``: weights by "/"-joined path; ``batch.npz``).  This file
imports no jax: ``tests/test_torch_multidevice.py`` runs the reference.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import sys

import numpy as np
import torch

GRAD_ACCUM = 2
TRAIN_MESH = ((2, 2), ("data", "model"))
SERVE_MESH = ((1, 2), ("data", "model"))
# 4-way: the smoke config's 2 kv heads do not divide, and replicate
SERVE_MESH4 = ((1, 4), ("data", "model"))


def load_params(path: str) -> dict:
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            d = out
            *parents, leaf = key.split("/")
            for p in parents:
                d = d.setdefault(p, {})
            d[leaf] = torch.from_numpy(z[key].copy())
    return out


def train_cfg():
    from repro_torch import configs

    return dataclasses.replace(configs.get("smollm-360m").smoke(),
                               n_layers=2)


def serve_cfg():
    from repro_torch import configs

    return dataclasses.replace(configs.get("granite-8b").smoke(),
                               attn_impl="flash")


def _state(cfg, params, mesh, compress=False):
    from repro_torch.launch.train import place_state, state_specs
    from repro_torch.optim.adamw import AdamWConfig, init_moments
    from repro_torch.optim.compress import init_error

    state = {"params": params, "opt": init_moments(params, AdamWConfig())}
    if compress:
        state["opt"]["err"] = init_error(params)
    return place_state(state, state_specs(state, mesh), mesh)


def _full(tree):
    from repro_torch.core.tree import tree_map

    return tree_map(lambda t: t.full_tensor().numpy(), tree)


# ------------------------------------------------------------------- cases
def train(rank, world, in_dir):
    """The (2, 2) step three ways on one batch, then with each data rank's
    own rows from ``SyntheticLM(host_index=rank, host_count=dp)``."""
    from torch.distributed.tensor import DTensor, Shard, Replicate

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.hlo_analysis import (CommRecord,
                                                 collective_stats_from_comm)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import make_train_step

    cfg = train_cfg()
    mesh = make_mesh(*TRAIN_MESH, device_type="cpu")
    params = load_params(os.path.join(in_dir, "params.npz"))
    with np.load(os.path.join(in_dir, "batch.npz")) as z:
        batch = {k: torch.from_numpy(z[k]) for k in z.files}
    data_group = mesh.get_group("data").group_name
    out = {}
    for name, kw in (("auto", {}), ("late", {"grad_sync": "late"}),
                     ("late_compressed", {"grad_sync": "late",
                                          "compress": True})):
        step = make_train_step(cfg, grad_accum=GRAD_ACCUM, mesh=mesh, **kw)
        with CommRecord() as comm:
            new, metrics = step(_state(cfg, params, mesh,
                                       kw.get("compress", False)), batch)
        out[name] = {
            "loss": float(metrics["loss"]),
            "params": _full(new["params"]),
            "grads": _full(metrics["grads"]),
            "grad_sync": collective_stats_from_comm(comm, "grad_sync",
                                                    data_group)}
    dp = mesh.size(0)
    data_rank = mesh.get_local_rank("data")
    rows = SyntheticLM(vocab=cfg.vocab, batch=8, seq=32, host_index=data_rank,
                       host_count=dp, device="cpu").next()
    placed = {k: DTensor.from_local(v, mesh, [Shard(0), Replicate()],
                                    shape=(8,) + tuple(v.shape[1:]),
                                    stride=(v.shape[1], 1))
              for k, v in rows.items()}
    step = make_train_step(cfg, grad_accum=GRAD_ACCUM, grad_sync="late",
                           mesh=mesh)
    new, metrics = step(_state(cfg, params, mesh), placed)
    out["hosts"] = {"loss": float(metrics["loss"]),
                    "params": _full(new["params"])}
    return out


def serve(rank, world, in_dir):
    """Granite smoke (fp32) at TP = ``world`` (2 or 4): prefill logits and
    the serve loop's tokens, and the collectives of the prefill."""
    from repro_torch.launch import shard
    from repro_torch.launch.hlo_analysis import (CommRecord,
                                                 collective_stats_from_comm)
    from repro_torch.launch.mesh import make_mesh, mesh_context
    from repro_torch.launch.serve import make_prefill_step, serve_loop
    from repro_torch.launch.train import place_state

    cfg = serve_cfg()
    mesh = make_mesh(*(SERVE_MESH if world == 2 else SERVE_MESH4),
                     device_type="cpu")
    params = load_params(os.path.join(in_dir, "params.npz"))
    params = place_state(params, shard.param_specs(params, mesh), mesh)
    with np.load(os.path.join(in_dir, "batch.npz")) as z:
        tokens, prompt = torch.from_numpy(z["tokens"]), z["prompt"]
    with mesh_context(mesh), CommRecord() as comm:
        logits = make_prefill_step(cfg)(params, {"tokens": tokens})
    full = logits.full_tensor().numpy()
    with mesh_context(mesh):
        loop = serve_loop(cfg, params, prompt, 8, "cpu", mesh=mesh)
    local_heads = params["layers"]["wq"].to_local().shape[-1] // cfg.head_dim
    return {"logits": full, "tokens": loop["tokens"],
            "foreign_modules": sorted(m for m in sys.modules if m.split(
                ".")[0] in ("jax", "jaxlib", "repro")),
            "collectives": collective_stats_from_comm(comm),
            "ops": sorted({e["op"] for e in comm.entries}),
            "local_q_heads": local_heads}


def elastic(rank, world, in_dir):
    """Save the (2, 2) state, lose ranks 2 and 3, re-mesh ranks 0-1 as
    (1, 2), restore onto it (directly and through ``run_with_retries``)
    and take one more step.  The same for the state of an int8 compressed
    step, whose error-feedback buffers ride in the state: saved, restored
    and re-placed by ``reshard_state``; the step is pure (the same state
    twice gives the same buffers)."""
    from repro_torch.checkpoint.store import CheckpointStore
    from repro_torch.core.tree import leaves
    from repro_torch.distributed.elastic import (plan_mesh, remesh,
                                                 reshard_state)
    from repro_torch.distributed.health import RetryPolicy, run_with_retries
    from repro_torch.launch import shard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import (abstract_state, make_train_step,
                                          state_specs)

    cfg = train_cfg()
    mesh = make_mesh(*TRAIN_MESH, device_type="cpu")
    params = load_params(os.path.join(in_dir, "params.npz"))
    with np.load(os.path.join(in_dir, "batch.npz")) as z:
        batch = {k: torch.from_numpy(z[k]) for k in z.files}
    step = make_train_step(cfg, grad_accum=GRAD_ACCUM, mesh=mesh)
    state, _ = step(_state(cfg, params, mesh), batch)
    store = CheckpointStore(os.path.join(in_dir, "ckpt"))
    store.save(state, step=1)
    saved = [t.full_tensor() for t in leaves(state)]

    cstep = make_train_step(cfg, grad_accum=GRAD_ACCUM, grad_sync="late",
                            mesh=mesh, compress=True)
    cstate0 = _state(cfg, params, mesh, compress=True)
    cstate, _ = cstep(cstate0, batch)
    err_saved = [t.full_tensor() for t in leaves(cstate["opt"]["err"])]
    err_pure = all(torch.equal(a.full_tensor(), b) for a, b in zip(
        leaves(cstep(cstate0, batch)[0]["opt"]["err"]), err_saved))
    cstore = CheckpointStore(os.path.join(in_dir, "ckpt_err"))
    cstore.save(cstate, step=1)

    shape, axes = plan_mesh(2, model_size=2)
    small = remesh([0, 1], model_size=2, device_type="cpu")
    moved = reshard_state(cstate, state_specs(cstate, small), small)
    if rank >= 2:
        return None
    ctmpl = abstract_state(cfg, compress=True)
    crest, _ = cstore.restore_latest(ctmpl, placements=shard.named(
        state_specs(ctmpl, small), small))
    err_restored = [t.full_tensor() for t in leaves(crest["opt"]["err"])]
    err_moved = [t.full_tensor() for t in leaves(moved["opt"]["err"])]
    tmpl = abstract_state(cfg)
    placements = shard.named(state_specs(tmpl, small), small)
    restored, at = store.restore_latest(tmpl, placements=placements)
    equal = all(torch.equal(a.full_tensor(), b)
                for a, b in zip(leaves(restored), saved))
    calls = []

    def run(st, start):
        calls.append(start)
        return st, start

    via, start = run_with_retries(lambda: None, run, store, RetryPolicy(),
                                  tmpl, shardings=placements)
    via_equal = all(torch.equal(a.full_tensor(), b)
                    for a, b in zip(leaves(via), saved))
    half = {k: v[:4] for k, v in batch.items()}
    _, metrics = make_train_step(cfg, grad_accum=GRAD_ACCUM, mesh=small)(
        restored, half)
    _, cmetrics = make_train_step(cfg, grad_accum=GRAD_ACCUM,
                                  grad_sync="late", mesh=small,
                                  compress=True)(crest, half)
    return {"err_nonzero": all(bool(b.any()) for b in err_saved),
            "err_pure": err_pure,
            "err_restored_bit_equal": all(
                torch.equal(a, b) for a, b in zip(err_restored, err_saved)),
            "err_moved_bit_equal": all(
                torch.equal(a, b) for a, b in zip(err_moved, err_saved)),
            "err_placements": str(leaves(cstate["opt"]["err"])[0]
                                  .placements),
            "compressed_loss": float(cmetrics["loss"]),
"plan": (shape, axes), "mesh": tuple(small.shape),
            "step": at, "bit_equal": equal, "health_bit_equal": via_equal,
            "health_start": start, "calls": calls,
            "placements": str(leaves(restored)[0].placements),
            "loss": float(metrics["loss"])}


def compress(rank, world, in_dir):
    """``compressed_psum`` of rank r's row of ``g`` with error ``err``."""
    from repro_torch.optim.compress import compressed_psum

    with np.load(os.path.join(in_dir, "batch.npz")) as z:
        g, err = torch.from_numpy(z["g"][rank]), torch.from_numpy(
            z["err"][rank])
    import torch.distributed as dist

    mean, new_err = compressed_psum(g, dist.group.WORLD, err)
    gathered = [torch.empty_like(new_err) for _ in range(world)]
    dist.all_gather(gathered, new_err)
    return {"mean": mean.numpy(), "err": torch.stack(gathered).numpy()}


# ---------------------------------------------------------- every family
def family_cfg(arch: str, flash: bool = True):
    """The smoke config (fp32) of ``arch`` as the family tests run it:
    serving takes attention through flash (its plain version on the CPU)
    where the family's prefill may; training keeps the config's own
    attention (flash has no backward)."""
    from repro_torch import configs

    cfg = configs.get(arch).smoke()
    if flash and cfg.family in ("dense", "moe", "vlm"):
        cfg = dataclasses.replace(cfg, attn_impl="flash")
    return cfg


def _batch(in_dir, name="batch.npz"):
    with np.load(os.path.join(in_dir, name)) as z:
        return {k: torch.from_numpy(z[k]) for k in z.files}


def _spy_kernels():
    """Record the (q, v) shapes and q's head stride of every plain scan
    call, and the q and k shapes of every flash call, of this process."""
    from repro_torch.kernels.flash_attention import ops as flash
    from repro_torch.kernels.ssm_scan import ops as scan

    seen = {"scan": [], "flash": []}
    plain_scan, plain_flash = scan.chunked_linear_scan, flash.attention_ref

    def spy_scan(q, k, v, log_a, **kw):
        seen["scan"].append((tuple(q.shape), tuple(v.shape), q.stride(2)))
        return plain_scan(q, k, v, log_a, **kw)

    def spy_flash(q, k, v, **kw):
        seen["flash"].append((tuple(q.shape), tuple(k.shape)))
        return plain_flash(q, k, v, **kw)

    scan.chunked_linear_scan, flash.attention_ref = spy_scan, spy_flash
    return seen


def family_serve(rank, world, in_dir, arch):
    """TP = 2 on a (1, 2) mesh: the prefill's logits, the serve loop's
    tokens and each kernel's per-rank shapes."""
    from repro_torch.launch import shard
    from repro_torch.launch.mesh import make_mesh, mesh_context
    from repro_torch.launch.serve import make_prefill_step, serve_loop
    from repro_torch.launch.train import place_state

    cfg = family_cfg(arch)
    mesh = make_mesh(*SERVE_MESH, device_type="cpu")
    params = load_params(os.path.join(in_dir, "params.npz"))
    params = place_state(params, shard.param_specs(params, mesh), mesh)
    batch = _batch(in_dir)
    prompt = batch.pop("prompt").numpy()
    seen = _spy_kernels()
    with torch.no_grad(), mesh_context(mesh):
        logits = make_prefill_step(cfg)(params, batch).full_tensor()
    prefill_seen = {k: sorted(set(v)) for k, v in seen.items()}
    with mesh_context(mesh):
        loop = serve_loop(cfg, params, prompt, 8, "cpu", mesh=mesh)
    return {"logits": logits.numpy(), "tokens": loop["tokens"],
            "seen": prefill_seen,
            "foreign_modules": sorted(m for m in sys.modules if m.split(
                ".")[0] in ("jax", "jaxlib", "repro"))}


def family_train(rank, world, in_dir, arch):
    """One (2, 2) ``grad_sync="late"`` step: its loss, params and
    gradients."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import make_train_step

    cfg = family_cfg(arch, flash=False)
    mesh = make_mesh(*TRAIN_MESH, device_type="cpu")
    params = load_params(os.path.join(in_dir, "params.npz"))
    new, metrics = make_train_step(cfg, grad_accum=GRAD_ACCUM,
                                   grad_sync="late", mesh=mesh)(
        _state(cfg, params, mesh), _batch(in_dir, "train.npz"))
    return {"loss": float(metrics["loss"]), "params": _full(new["params"]),
            "grads": _full(metrics["grads"])}


CASES = {"train": (train, 4), "serve": (serve, 2), "serve4": (serve, 4),
         "elastic": (elastic, 4),
         "compress": (compress, 4),
         "family_serve": (family_serve, 2),
         "family_train": (family_train, 4)}


def main(argv=None) -> None:
    """CASE may name an arch after a colon (``family_serve:xlstm-1.3b``),
    which the rank program takes after IN_DIR."""
    case, in_dir, out_file = argv or sys.argv[1:]
    from repro_torch.launch.mesh import run_ranks

    case, *arch = case.split(":")
    fn, world = CASES[case]
    res = run_ranks(fn, world, (in_dir, *arch), device_type="cpu",
                    timeout_s=60, join_s=240)
    with open(out_file, "wb") as f:
        pickle.dump(res[0], f)


if __name__ == "__main__":
    main()
