# Ported from src/repro/launch/shard.py (jax.sharding -> DTensor placements).
"""Sharding rules: per-dimension specs for params, optimizer state, caches
and batches on the ("pod",) "data" x "model" mesh, and their DTensor
placements.

Strategy, as in the reference: DP over ("pod", "data"); TP over "model" —
each parameter shards its largest model-divisible dimension (preferring
trailing dims); norms and other small vectors replicate.  ZeRO-1:
optimizer moments additionally shard one remaining dimension over "data".
Non-divisible cases (smollm's 15 heads, mixtral's 8 experts) fall back to
replication of that dim.

A spec is a ``P`` (``distributed.mesh_state``): one entry per leading
tensor dim, each None, a mesh axis name or a tuple of names (the
reference's ``PartitionSpec``, which the port cannot import).
``named(specs, mesh)`` turns specs into DTensor placements, one per mesh
dim: ``Shard(d)`` where tensor dim d names that mesh axis, ``Replicate()``
elsewhere, paired with the mesh as a ``Named`` — the counterpart of
``NamedSharding``.  ``error_specs`` adds what ``PartitionSpec`` cannot
say: the int8 error-feedback buffers are partial sums over the data axes.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                      distribute_tensor)

from repro_torch.core.tree import tree_map
from repro_torch.distributed.mesh_state import (  # noqa: F401 (re-exported)
    P, data_axes, mesh_dims, placements)

_REPLICATED_HINTS = ("ln", "bias", "a_log", "b_gates")


def _is_replicated(path: str) -> bool:
    leaf = path.split("/")[-1]
    return any(leaf.startswith(h) or leaf == h for h in _REPLICATED_HINTS)


def _stacked_dims(path: str) -> int:
    """Leading stacking axes (layer stacks, LoRA application stacks) that
    stay unsharded for per-layer slicing."""
    top = path.split("/")[0]
    return 1 if top in ("layers", "mlstm", "slstm", "mamba", "enc", "dec",
                        "lora") else 0


# Megatron row-parallel weights: shard the CONTRACTION (input) dim so the
# matmul reduces with one small activation all-reduce; sharding their output
# dim instead gathers the whole weight per use.
_ROW_PARALLEL = {"w2", "wo", "w_down", "w_out", "xwo"}


def param_spec(path: str, shape: tuple, model_size: int) -> P:
    if _is_replicated(path) or len(shape) <= 1:
        return P()
    leaf = path.split("/")[-1]
    if leaf in ("embed", "unembed") and shape[0] % model_size == 0:
        # vocab-parallel: logits reduce over shards instead of gathering
        # the table
        return P("model", *([None] * (len(shape) - 1)))
    lead = min(_stacked_dims(path), len(shape) - 1)
    dims = list(range(len(shape)))[lead:]
    order = list(reversed(dims))
    if leaf in _ROW_PARALLEL and len(dims) >= 2:
        order = [dims[-2], dims[-1]] + list(reversed(dims[:-2]))
    for d in order:
        if shape[d] % model_size == 0 and shape[d] >= model_size:
            spec = [None] * len(shape)
            spec[d] = "model"
            return P(*spec)
    return P()


def zero1_spec(pspec: P, shape: tuple, data_size: int, path: str = "") -> P:
    """Optimizer-moment spec: param spec + shard one more dim over "data"."""
    spec = list(pspec) + [None] * (len(shape) - len(pspec))
    for d in reversed(range(len(shape))):
        if spec[d] is None and shape[d] % data_size == 0 \
                and shape[d] >= data_size:
            spec[d] = "data"
            return P(*spec)
    return P(*spec)


def _with_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over nested dictionaries; the path joins the keys
    with "/" as the reference's ``tree_flatten_with_path`` names do."""
    return {k: _with_paths(fn, v, f"{prefix}{k}/") if isinstance(v, dict)
            else fn(f"{prefix}{k}", v) for k, v in tree.items()}


def param_specs(params_abstract, mesh) -> dict:
    msize = mesh_dims(mesh).get("model", 1)
    return _with_paths(lambda p, l: param_spec(p, tuple(l.shape), msize),
                       params_abstract)


def moment_specs(params_abstract, mesh) -> dict:
    md = mesh_dims(mesh)
    msize, dsize = md.get("model", 1), md.get("data", 1)
    return _with_paths(
        lambda p, l: zero1_spec(param_spec(p, tuple(l.shape), msize),
                                tuple(l.shape), dsize, p), params_abstract)


def error_specs(params_abstract, mesh) -> dict:
    """The int8 error-feedback buffers (``optim.compress``): each data rank
    keeps the residual of its own gradient, and the step's mean takes their
    sum, so a buffer is the param's spec on the model axis and a partial
    sum (``Partial()``) over the data axes."""
    dp = data_axes(mesh)
    return tree_map(lambda s: P(*s, partial=dp),
                    param_specs(params_abstract, mesh))


def _dp(mesh) -> tuple[tuple[str, ...], int]:
    dp = data_axes(mesh)
    md = mesh_dims(mesh)
    return dp, math.prod(md[a] for a in dp)


def batch_specs(batch_abstract, mesh):
    """Batch rows over the data axes where they divide, else replicated.
    Takes one tensor or a dictionary of them."""
    dp, dp_size = _dp(mesh)

    def spec(l):
        if l.ndim == 0 or l.shape[0] % dp_size or l.shape[0] < dp_size:
            return P(*([None] * l.ndim))
        return P(dp, *([None] * (l.ndim - 1)))

    return tree_map(spec, batch_abstract) if isinstance(
        batch_abstract, dict) else spec(batch_abstract)


def cache_specs(cache_abstract, cfg, mesh) -> dict:
    """KV caches (L,B,S,KV,D) / SSM states (L,B,H,K,V): batch over data
    axes; the kv-head dim over "model" when divisible, otherwise the
    sequence / state dim."""
    msize = mesh_dims(mesh).get("model", 1)
    dp, dp_size = _dp(mesh)

    def spec(l):
        s = [None] * l.ndim
        batch_sharded = (l.ndim >= 2 and l.shape[1] % dp_size == 0
                         and l.shape[1] >= dp_size)
        if batch_sharded:
            s[1] = dp          # (L, B, ...)
        if l.ndim >= 4 and l.shape[3] % msize == 0 and l.shape[3] >= msize:
            s[3] = "model"     # kv heads / ssm K dim
            if not batch_sharded and dp and l.shape[2] % dp_size == 0 \
                    and l.shape[2] >= dp_size:
                # batch too small (long_500k decode): shard the sequence
                # over the idle data axes
                s[2] = dp
        elif l.ndim >= 4 and l.shape[2] % msize == 0 and l.shape[2] >= msize:
            s[2] = "model"     # sequence (KV cache) / head state dim
        return P(*s)

    return tree_map(spec, cache_abstract)


class Named(NamedTuple):
    """A mesh and one placement per mesh dim (``NamedSharding``)."""
    mesh: DeviceMesh
    placements: tuple

    def place(self, t):
        """``t`` (a full tensor, the same on every rank) as a DTensor:
        each rank keeps its shard, nothing is sent.  Over a ``Partial``
        mesh dim the rank at coordinate 0 holds the value and the others
        zeros, so the sum is ``t`` to the bit."""
        if t.device.type != "meta":
            t = t.to(self.mesh.device_type)
        part = [i for i, p in enumerate(self.placements)
                if isinstance(p, Partial)]
        whole = [Replicate() if i in part else p
                 for i, p in enumerate(self.placements)]
        d = distribute_tensor(t, self.mesh, whole, src_data_rank=None)
        if not part:
            return d
        loc, coord = d.to_local(), self.mesh.get_coordinate()
        if coord is not None and any(coord[i] for i in part):
            loc = torch.zeros_like(loc)
        return DTensor.from_local(loc, self.mesh, self.placements,
                                  run_check=False, shape=d.shape,
                                  stride=d.stride())


def named(tree_specs, mesh):
    """Specs (one ``P`` or nested dictionaries of them) as ``Named``."""
    if isinstance(tree_specs, P):
        return Named(mesh, placements(tree_specs, mesh))
    return tree_map(lambda s: Named(mesh, placements(s, mesh)), tree_specs)
