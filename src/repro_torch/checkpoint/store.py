# Ported from src/repro/checkpoint/store.py (jax -> torch).
"""Async, crash-safe checkpointing in the reference's on-disk format.

    <dir>/step_<N>/
        index.json            leaf shapes/dtypes, step, the writing topology
        leaf_<i>_host0.npy    leaf i (one host: the full leaf)
        COMMITTED             written last — a checkpoint without it is
                              ignored on restore (crash-safe)

A state is nested dictionaries of tensors; leaf i is the i-th leaf in
sorted-key order (``core.tree.leaves``), which is the order
``jax.tree_util`` flattens dictionaries in, so a checkpoint written by
either package restores in the other.  bf16 leaves are stored as their
16-bit pattern (a uint16 view; npy has no bfloat16) with the true dtype in
the index, as the reference does.  ``save(..., async_write=True)`` copies
the leaves to host memory before it returns and writes them on a
background thread; every directory change (write, gc) holds one lock.
``restore`` rebuilds the state on a template (real or ``meta`` tensors) and
places it on a device, or with ``placements=`` (``shard.named(...)`` of the
state's specs) on a mesh: each full leaf becomes a DTensor there, whatever
mesh wrote it.  A state of DTensors is saved as full leaves
(``full_tensor()``, a collective every rank of the mesh joins), written by
rank 0; ``wait`` (and a synchronous save) then holds every rank until the
step is committed, so the format stays the reference's topology-free one.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core.executor import resolve_device
from repro_torch.core.tree import leaves, tree_map, unflatten

_NP_DTYPES = {"float32": np.float32, "float16": np.float16,
              "float64": np.float64, "int32": np.int32, "int64": np.int64,
              "int8": np.int8, "uint8": np.uint8, "bool": np.bool_}


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _encode(t: torch.Tensor) -> np.ndarray:
    """A host tensor as the array ``np.save`` writes: bf16 as its 16-bit
    pattern (uint16), since npy cannot represent bfloat16."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _decode(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    if arr.dtype.name != dtype_name:
        arr = arr.view(_NP_DTYPES[dtype_name])
    return torch.from_numpy(arr.copy())


class CheckpointStore:
    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._thread: threading.Thread | None = None
        # serializes every directory mutation (write + gc): a synchronous
        # save must not gc step dirs while a background write is in flight
        self._io_lock = threading.Lock()
        # guards the _thread handle so concurrent wait()s are idempotent
        self._state_lock = threading.Lock()
        self._barrier = False       # the last save was of DTensors

    # ------------------------------------------------------------------ save
    def save(self, state, step: int, async_write: bool = False,
             extra: dict | None = None) -> str:
        # a snapshot on the host, taken before save returns
        flat = leaves(state)
        distributed = any(isinstance(t, DTensor) for t in flat)
        host_leaves = [(t.full_tensor() if isinstance(t, DTensor) else t)
                       .detach().to("cpu", copy=True) for t in flat]
        path = os.path.join(self.root, f"step_{step:08d}")
        self._barrier = distributed
        if distributed and dist.get_rank() != 0:
            if not async_write:
                self.wait()
            return path

        def write():
            # one writer at a time: a sync save overlapping an async one
            # must not interleave directory mutations (or gc — below)
            with self._io_lock:
                tmp = path + ".tmp"
                os.makedirs(tmp, exist_ok=True)
                for i, arr in enumerate(host_leaves):
                    np.save(os.path.join(tmp, f"leaf_{i}_host0.npy"),
                            _encode(arr))
                index = {
                    "step": step,
                    "n_leaves": len(host_leaves),
                    "treedef": "sorted-key nested dict",
                    "shapes": [list(a.shape) for a in host_leaves],
                    "dtypes": [_dtype_name(t) for t in host_leaves],
                    "n_hosts": 1,
                    "extra": extra or {},
                }
                with open(os.path.join(tmp, "index.json"), "w") as f:
                    json.dump(index, f)
                with open(os.path.join(tmp, "COMMITTED"), "w") as f:
                    f.write("ok")
                if os.path.exists(path):
                    shutil.rmtree(path)
                os.replace(tmp, path)
                self._gc()

        if async_write:
            self.wait()
            with self._state_lock:
                self._thread = threading.Thread(target=write, daemon=True)
                self._thread.start()
        else:
            write()
            if distributed:
                self.wait()
        return path

    def wait(self) -> None:
        """Block until the outstanding background write (if any) finishes.
        Idempotent and safe under concurrent callers: the thread handle is
        claimed under a lock, so every waiter joins (or finds nothing) and
        a double wait is a no-op.  After a save of DTensors every rank of
        the process group calls it, and it returns once rank 0's write is
        committed."""
        with self._state_lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join()
        if self._barrier:
            self._barrier = False
            dist.barrier()

    def _gc(self) -> None:
        # only ever called from write(), under _io_lock: gc never races an
        # in-flight background write's tmp dir or commit rename
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.root):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.root, d, "COMMITTED")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def restore(self, step: int, template, device=None, *, placements=None):
        """The state saved at ``step``, shaped like ``template`` (nested
        dictionaries of tensors, ``meta`` ones included), on ``device``:
        by default the template's, or CUDA for a ``meta`` template; with
        ``placements`` (a tree of ``shard.Named`` like the template) each
        leaf a DTensor placed by its ``Named``.  Returns (state, step)."""
        path = os.path.join(self.root, f"step_{step:08d}")
        with open(os.path.join(path, "index.json")) as f:
            index = json.load(f)
        flat = leaves(template)
        if index["n_leaves"] != len(flat):
            raise ValueError(f"leaf count mismatch: checkpoint "
                             f"{index['n_leaves']} vs template {len(flat)}")
        if device is None and flat and flat[0].device.type != "meta":
            device = flat[0].device
        # placed leaves go to their mesh's device from the host
        dev = None if placements is not None else resolve_device(device)
        out = []
        for i, tmpl in enumerate(flat):
            arr = np.load(os.path.join(path, f"leaf_{i}_host0.npy"))
            t = _decode(arr, index["dtypes"][i])
            if tuple(t.shape) != tuple(tmpl.shape) or t.dtype != tmpl.dtype:
                raise ValueError(f"leaf {i}: checkpoint {t.dtype}"
                                 f"{tuple(t.shape)}, template {tmpl.dtype}"
                                 f"{tuple(tmpl.shape)}")
            out.append(t if dev is None else t.to(dev))
        state = unflatten(template, out)
        if placements is not None:
            state = tree_map(lambda t, n: n.place(t), state, placements)
        return state, index["step"]

    def restore_latest(self, template, device=None, *, placements=None):
        steps = self.steps()
        if not steps:
            return None
        return self.restore(steps[-1], template, device,
                            placements=placements)
