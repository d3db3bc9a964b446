# Ported from src/repro/data/pipeline.py (jax.numpy -> torch).
"""Deterministic, seekable synthetic data pipeline.

Every batch is a pure function of (seed, step): restarts resume
bit-identically from a checkpointed cursor, and each host slices its own
rows (per-host sharding).  Token streams follow a Zipfian-ish distribution
with local n-gram structure so losses decrease.  The numbers come from the
same numpy generator as the reference's, so a batch equals the
reference's element for element; it is handed over as tensors on
``device`` (CUDA unless the caller passes another).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.executor import resolve_device


class SyntheticLM:
    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 17,
                 family: str = "dense", d_model: int = 0, n_patches: int = 0,
                 host_index: int = 0, host_count: int = 1, device=None):
        if batch % host_count:
            raise ValueError(f"batch {batch} does not split over "
                             f"{host_count} hosts")
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed, self.step = seed, 0
        self.family, self.d_model, self.n_patches = family, d_model, n_patches
        self.host_index, self.host_count = host_index, host_count
        self.device = resolve_device(device)

    # ------------------------------------------------------------- cursor
    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def seek(self, step: int) -> None:
        self.step = int(step)

    # -------------------------------------------------------------- batches
    def _tokens(self, rng, rows: int, length: int) -> np.ndarray:
        # zipf-flavored marginals + shifted-copy structure => learnable
        z = rng.zipf(1.3, size=(rows, length)).astype(np.int64)
        t = z % self.vocab
        t[:, 1::2] = t[:, 0:-1:2]  # every odd position copies its neighbor
        return t.astype(np.int32)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_index]))
        rows = self.batch // self.host_count
        if self.family == "audio":
            se = max(8, self.seq // 2)
            sd = self.seq - se
            toks = self._tokens(rng, rows, sd + 1)
            return {"frames": self._t(rng.standard_normal(
                        (rows, se, self.d_model)).astype(np.float32)),
                    "tokens": self._t(toks[:, :-1]),
                    "labels": self._t(toks[:, 1:])}
        if self.family == "vlm" and self.n_patches:
            npat = min(self.n_patches, self.seq // 2)
            st = self.seq - npat
            toks = self._tokens(rng, rows, st + 1)
            return {"patch_embeds": self._t(rng.standard_normal(
                        (rows, npat, self.d_model)).astype(np.float32)),
                    "tokens": self._t(toks[:, :-1]),
                    "labels": self._t(toks[:, 1:])}
        toks = self._tokens(rng, rows, self.seq + 1)
        return {"tokens": self._t(toks[:, :-1]),
                "labels": self._t(toks[:, 1:])}

    def next(self) -> dict:
        b = self.batch_at(self.step)
        self.step += 1
        return b
