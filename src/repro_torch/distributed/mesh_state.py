"""The mesh in effect and the placement vocabulary, below both the model
layers and the launchers.

``mesh_context`` sets the mesh that ``current_mesh`` returns (the
reference's ``jax.set_mesh``), which ``nn.layers.constrain`` reads; ``P``
is a partition spec (the reference's ``PartitionSpec``, which the port
cannot import) and ``placements`` turns one into DTensor placements on a
mesh.  ``launch.mesh`` and ``launch.shard`` re-export these names; this
module imports nothing of the package, so ``nn`` depends on no launcher.
"""
from __future__ import annotations

import contextlib
import threading

from torch.distributed.tensor import Partial, Replicate, Shard

_ACTIVE = threading.local()


@contextlib.contextmanager
def mesh_context(mesh):
    """``with mesh_context(mesh):`` makes ``mesh`` the one ``current_mesh``
    returns (the reference's ``jax.set_mesh``); nests."""
    prev = getattr(_ACTIVE, "mesh", None)
    _ACTIVE.mesh = mesh
    try:
        yield mesh
    finally:
        _ACTIVE.mesh = prev


def current_mesh():
    return getattr(_ACTIVE, "mesh", None)


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def model_axis(mesh) -> str:
    return "model"


def mesh_dims(mesh) -> dict:
    """{axis name: size}.  Reads only the names and the shape, so a stand-in
    with ``mesh_dim_names`` and ``shape`` plans without a process group."""
    return dict(zip(axis_names(mesh), tuple(mesh.shape)))


class P(tuple):
    """A partition spec: ``P(None, "model")``; ``P()`` replicates.  A
    one-name tuple entry is that name, as ``PartitionSpec`` has it.
    ``partial`` names mesh axes over which each rank holds a summand of
    the value (DTensor's ``Partial``), which ``PartitionSpec`` cannot
    say; it takes no part in equality."""

    def __new__(cls, *entries, partial: tuple = ()):
        spec = super().__new__(cls, (e[0] if isinstance(e, tuple) and
                                     len(e) == 1 else e for e in entries))
        spec.partial = tuple(partial)
        return spec

    def __repr__(self) -> str:
        tail = f"+partial{self.partial}" if self.partial else ""
        return f"P{tuple.__repr__(self)}{tail}"


def placements(spec: P, mesh) -> tuple:
    """One spec as DTensor placements on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim d names (a tuple entry shards d over several
    mesh dims, major to minor), ``Partial()`` on the mesh dims the spec
    holds partial, ``Replicate()`` on the others and on mesh dims of size 1
    (the same layout; DTensor cannot flatten a dim of size 1 that it holds
    sharded)."""
    out = []
    for name, size in mesh_dims(mesh).items():
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        if size > 1 and dims:
            out.append(Shard(dims[0]))
        elif size > 1 and name in getattr(spec, "partial", ()):
            out.append(Partial())
        else:
            out.append(Replicate())
    return tuple(out)
