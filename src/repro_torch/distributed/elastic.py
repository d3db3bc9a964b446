# Ported from src/repro/distributed/elastic.py (jax -> torch.distributed).
"""Elastic re-meshing: rebuild the mesh from the ranks that remain and
re-place a checkpointed state onto it.

Policy: keep the "model" axis fixed (TP degree is baked into layouts and
kernel shapes) and shrink the data-parallel axes to the largest multiple
that still divides the surviving rank count — the standard elastic-DP
design.  Re-placement is ``distribute_tensor`` with the new placements (the
checkpoint format is topology-free, see ``checkpoint.store``).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.core.tree import tree_map
from repro_torch.launch.mesh import gloo_cuda_all_gather
from repro_torch.launch.shard import named


def plan_mesh(n_devices: int, model_size: int = 16,
              prefer_pods: bool = True) -> tuple[tuple, tuple]:
    """Largest (pod, data, model) grid with the fixed model axis."""
    if n_devices < model_size:
        raise ValueError(
            f"cannot keep TP={model_size} with only {n_devices} devices")
    dp = n_devices // model_size
    if prefer_pods and dp % 2 == 0 and dp >= 32:
        return (2, dp // 2, model_size), ("pod", "data", "model")
    return (dp, model_size), ("data", "model")


def remesh(ranks=None, model_size: int = 16,
           device_type: str | None = None) -> DeviceMesh:
    """A mesh over the surviving ``ranks`` (default: every rank of the
    process group) in ``plan_mesh``'s shape.  Every rank of the process
    group calls it, since each mesh dim's groups are made collectively; a
    rank outside the new mesh gets a mesh it is no member of."""
    ranks = list(range(dist.get_world_size())) if ranks is None \
        else list(ranks)
    shape, axes = plan_mesh(len(ranks), model_size)
    grid = torch.tensor(ranks[:math.prod(shape)]).reshape(shape)
    device_type = device_type or "cuda"
    gloo_cuda_all_gather(device_type)
    return DeviceMesh(device_type, grid, mesh_dim_names=axes)


def reshard_state(state, specs, new_mesh: DeviceMesh):
    """``state`` (full tensors or DTensors of another mesh) re-placed on
    ``new_mesh`` by ``specs`` (``train.state_specs``)."""
    def put(x, n):
        return n.place(x.full_tensor() if isinstance(x, DTensor) else x)

    return tree_map(put, state, named(specs, new_mesh))
