# Ported from src/repro/launch/mesh.py (jax -> torch.distributed).
"""Device meshes on ``torch.distributed``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
an initialized process group, one rank per device.  Functions, not
module-level constants: importing this module touches no device and no
process group.  ``mesh_context`` (from ``distributed.mesh_state``, with
the axis helpers) sets the mesh that ``nn.layers.constrain`` reads;
outside it ``constrain`` is the identity.  ``run_ranks`` starts a
group of local ranks (spawned processes over a local TCP store).
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.distributed.mesh_state import (  # noqa: F401 (re-exported)
    axis_names, current_mesh, data_axes, mesh_context, mesh_dims, model_axis)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> DeviceMesh:
    """16x16 ranks ("data" x "model"); two pods add a "pod" axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_mesh(shape, axes, device_type: str | None = None) -> DeviceMesh:
    """A mesh of ``shape`` over every rank of the default process group,
    which must hold exactly ``prod(shape)`` ranks.  ``device_type`` is
    "cuda" unless the caller asks for "cpu"."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} vs axes {axes}")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, "
                         f"the process group has {world}")
    device_type = device_type or "cuda"
    gloo_cuda_all_gather(device_type)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


_GLOO_CUDA_LIB = []


def gloo_cuda_all_gather(device_type: str) -> None:
    """Where ranks share one card they cannot use NCCL (it refuses two ranks
    on one device) and the group is gloo over CUDA tensors.  There the
    functional all-gather (``_c10d_functional.all_gather_into_tensor``,
    which DTensor's Shard -> Replicate issues) segfaults in torch 2.11,
    while c10d's ``all_gather_into_tensor`` on the same group and the same
    CUDA tensors works (the other functional collectives work as they
    are).  For a gloo default group and a CUDA mesh this registers, once,
    a CUDA kernel for the functional op that issues c10d's.  The tensors
    stay on the card and the collective on the mesh's group."""
    if device_type != "cuda" or dist.get_backend() != "gloo" \
            or _GLOO_CUDA_LIB:
        return
    import torch
    from torch.distributed.distributed_c10d import _resolve_process_group

    def all_gather(inp, group_size: int, group_name):
        out = inp.new_empty((inp.shape[0] * group_size,) + tuple(
            inp.shape[1:]))
        dist.all_gather_into_tensor(out, inp.contiguous(),
                                    group=_resolve_process_group(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather, "CUDA")
    _GLOO_CUDA_LIB.append(lib)


# ------------------------------------------------------------ local ranks
def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_backend(world: int, device_type: str) -> str:
    """NCCL where every rank has a card of its own, else gloo (CPU ranks,
    or ranks sharing a card: NCCL refuses two ranks on one device)."""
    if device_type == "cuda":
        import torch

        if world <= torch.cuda.device_count():
            return "nccl"
    return "gloo"


def _rank_main(fn, rank, world, port, backend, device_type, timeout_s,
               args, results):
    import datetime
    import traceback

    import torch

    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    try:
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
        results.put((rank, "ok", fn(rank, world, *args)))
    except BaseException:
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, args=(), *, device_type: str = "cuda",
              timeout_s: float = 60.0, join_s: float = 600.0) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes joined by
    a process group over a local TCP store (``rank_backend``'s; each
    collective times out after ``timeout_s``).
    Rank r runs on ``cuda:{r % device_count}``.  Returns the ranks' return
    values in rank order; raises with the tracebacks if any rank fails or
    the group outlives ``join_s``, after stopping every process."""
    import queue
    import time

    import torch.multiprocessing as mp

    backend = rank_backend(world, device_type)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, port, backend, device_type,
                               timeout_s, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.monotonic() + join_s
    try:
        while len(out) + len(errors) < world:
            left = deadline - time.monotonic()
            try:
                rank, status, val = results.get(timeout=max(1.0, min(
                    left, 5.0)))
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if left <= 0 or dead:
                    errors.append(f"ranks ended without a result (exit "
                                  f"codes {[p.exitcode for p in procs]}) "
                                  f"or the group outlived {join_s} s")
                    break
                continue
            if status != "ok":
                errors.append(f"rank {rank}:\n{val}")
                break
            out[rank] = val
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
    if errors:
        raise RuntimeError("\n".join(errors))
    return [out[r] for r in range(world)]
