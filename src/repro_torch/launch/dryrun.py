# Ported from src/repro/launch/dryrun.py (jax -> torch.distributed).
"""Multi-pod dry run: one step of every (arch x shape) cell on the
production meshes, recorded without a device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-8b \\
        --shape train_4k --mesh pod

The reference forces 512 host devices and lowers the SPMD program; here one
process joins a ``"fake"`` process group (``FakeStore``) of the production
mesh's world size as rank 0, the state and batch are ``meta`` DTensors
placed by the sharding rules, and the step runs for real on them: every op
propagates shapes and placements, every collective dispatches (and moves
nothing).  Per rank it records ``n_devices``, the state and batch bytes of
rank 0's shards (``argument_size_in_bytes``), the FLOPs of one step counted
on the local shards at full depth (``torch.utils.flop_counter``'s formulas,
so no layer secant is needed) and the collectives the step issued
(``hlo_analysis.collective_stats_from_comm``: ring-traffic bytes by op).
XLA's ``temp_size_in_bytes``, ``generated_code_size_in_bytes`` and its
cost analysis have no counterpart without a compiler and are absent.
Every family runs (the scan's ``meta`` route gives the recurrent ones
their shapes); a cell that fails gives a ``"status": "error"`` record
with the reason, as the reference's ``main`` writes its failures.

Records land in ``dryrun_out/<arch>__<shape>__<mesh>.json`` at the repo
root (``--out`` elsewhere).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import configs
from repro_torch.configs.base import SHAPES, ShapeCfg
from repro_torch.core.tree import leaves, tree_map
from repro_torch.launch import shard
from repro_torch.launch.hlo_analysis import (CommRecord,
                                             collective_stats_from_comm)
from repro_torch.launch.mesh import data_axes, make_mesh, mesh_context
from repro_torch.launch.serve import make_prefill_step, make_serve_step
from repro_torch.launch.train import (abstract_state, make_train_step,
                                      place_state, state_specs)
from repro_torch.models import api

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "../../../dryrun_out")
PRODUCTION = {"pod": ((16, 16), ("data", "model")),
              "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def grad_accum_for(cfg, shape) -> int:
    """Microbatch count: the reference's memory-feasibility boundary."""
    if shape.kind != "train":
        return 1
    if cfg.d_model >= 8192:
        return 64
    if cfg.d_model >= 3072:
        return 16
    return 8


class LocalFlops(TorchDispatchMode):
    """FLOPs of the ops each rank runs on its local shards: a DTensor op
    runs first (NotImplemented) and its local ops are counted with
    ``flop_counter``'s formulas."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        return out


def fake_world(n: int) -> None:
    """This process as rank 0 of a ``"fake"`` group of ``n`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def local_bytes(tree) -> int:
    return sum(t.to_local().nbytes if isinstance(t, DTensor) else t.nbytes
               for t in leaves(tree))


def _step(cfg, shape: ShapeCfg, mesh, ga: int):
    """(state, inputs, fn): one step of the cell on meta DTensors."""
    specs_in = api.input_specs(cfg, shape)
    batch = tree_map(lambda t, n: n.place(t), specs_in,
                     shard.named(shard.batch_specs(specs_in, mesh), mesh))
    if shape.kind == "train":
        st = abstract_state(cfg)
        state = place_state(st, state_specs(st, mesh), mesh)
        grad_dtype = "bfloat16" if cfg.d_model >= 8192 else "float32"
        step = make_train_step(cfg, grad_accum=ga, grad_dtype=grad_dtype,
                               mesh=mesh)
        return state, batch, lambda: step(state, batch)
    p_abs = api.abstract_params(cfg)
    params = place_state(p_abs, shard.param_specs(p_abs, mesh), mesh)
    if shape.kind == "prefill":
        prefill = make_prefill_step(cfg)
        return params, batch, lambda: prefill(params, batch)
    c_abs = api.abstract_cache(cfg, shape.global_batch, shape.seq_len)
    cache = place_state(c_abs, shard.cache_specs(c_abs, cfg, mesh), mesh)
    serve = make_serve_step(cfg)
    state = {"params": params, "cache": cache}
    return state, batch, lambda: serve(params, cache, batch["tokens"],
                                       shape.seq_len - 1)


def run_cell(arch: str, shape, mesh_kind: str, *, cfg=None,
             mesh=None) -> dict:
    """One cell's record.  ``shape`` is a ``SHAPES`` name or a
    ``ShapeCfg``; ``cfg`` and ``mesh`` override the arch's config and the
    production mesh (whose fake group this call joins)."""
    cfg = cfg or configs.get(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if mesh is None:
        dims, axes = PRODUCTION[mesh_kind]
        fake_world(math.prod(dims))
        mesh = make_mesh(dims, axes, "cpu")
    # microbatches slice each data rank's own rows (launch.train), so at
    # most one a row
    rows = shape.global_batch // math.prod(
        mesh.size(mesh.mesh_dim_names.index(a)) for a in data_axes(mesh))
    ga = max(1, min(grad_accum_for(cfg, shape), rows))
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_kind,
           "n_devices": mesh.size(), "kind": shape.kind, "status": "ok",
           "grad_accum": ga}
    t0 = time.time()
    with mesh_context(mesh):
        state, batch, fn = _step(cfg, shape, mesh, ga)
        rec["state_bytes"] = local_bytes(state)
        rec["batch_bytes"] = local_bytes(batch)
        rec["argument_size_in_bytes"] = rec["state_bytes"] + rec[
            "batch_bytes"]
        with torch.no_grad() if shape.kind != "train" else \
                torch.enable_grad(), CommRecord() as comm, \
                LocalFlops() as flops:
            fn()
    rec["step_flops"] = flops.flops
    rec["collectives"] = collective_stats_from_comm(comm)
    rec["seconds"] = round(time.time() - t0, 2)
    return rec


def save(rec: dict, out_dir: str = RESULTS_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"),
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)

    meshes = ("pod", "multipod") if args.mesh == "both" else (args.mesh,)
    cells = []
    if args.all:
        for name, cfg in configs.ARCHS.items():
            for sh in configs.shapes_for(cfg):
                cells.extend((name, sh, mk) for mk in meshes)
    else:
        cells.extend((args.arch, args.shape, mk) for mk in meshes)

    ok = fail = skipped = 0
    for arch, sh, mk in cells:
        path = os.path.join(args.out, f"{arch}__{sh}__{mk}.json")
        if args.skip_existing and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("status") == "ok":
                    skipped += 1
                    continue
        try:
            rec = run_cell(arch, sh, mk)
            ok += 1
        except Exception as e:
            rec = {"arch": arch, "shape": sh, "mesh": mk, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
            fail += 1
        save(rec, args.out)
        print(f"[{ok+fail+skipped}/{len(cells)}] {arch:24s} {sh:12s} "
              f"{mk:8s} {rec['status']}"
              + (f"  {rec['seconds']}s flops={rec['step_flops']:.3g} "
                 f"args={rec['argument_size_in_bytes']:.3g}B "
                 f"coll={rec['collectives']['total_bytes']:.3g}B"
                 if rec["status"] == "ok"
                 else f"  {rec.get('error', '')[:120]}"))
    print(f"done: {ok} ok, {fail} failed, {skipped} skipped")
    if fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
