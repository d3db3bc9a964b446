"""The runtime supporter's unit of ownership: one compiled model, served.

Port of ``src/repro/runtime/session.py``.  A :class:`Session` binds one
(graph, strategy, device model, quantization) tuple to an
:class:`~repro_torch.core.executor.Int8Executor` on one ``torch.device``.
The strategy is lowered in-process to a ``GroupProgram`` at construction.

``run`` serves one request; ``run_batch`` stacks N queued requests into one
batched launch (one kernel grid covers all N images — the executor's batch
dimension is free); ``serve`` wraps the session in the dynamic-batching
:class:`~repro_torch.runtime.server.Server`.
"""
from __future__ import annotations

import contextlib

import torch


class Session:
    """Owns the lowered program and the executor for one compiled model."""

    def __init__(self, g, strategy, dev, qm, *, backend: str = "fused",
                 device=None):
        """``dev`` is the planning device model the strategy was searched
        under; ``device`` is where the executor runs (None: CUDA, which
        raises where CUDA is absent)."""
        from repro_torch.core import lower
        from repro_torch.core.executor import Int8Executor

        self.graph, self.qm, self.device_model = g, qm, dev
        self.program = lower.lower_strategy(g, strategy, qm)
        self.backend = backend
        # "fused" dispatches this session's program; "ref" walks the
        # strategy's groups node by node
        self.executor = Int8Executor(
            g, qm, strategy=self if backend == "fused" else strategy,
            backend=backend, device=device)
        self.device = self.executor.device
        self.outputs = [n.name for n in g if not g.consumers(n.name)]
        self.n_runs = 0
        self.images_served = 0
        self._launch_hook = None        # optional pre-launch hook

    # ------------------------------------------------------------- execution
    def _stack(self, xs, pad_to: int | None = None):
        rows = [torch.as_tensor(x).to(self.device) for x in xs]
        rows = [r[None] if r.dim() == 3 else r for r in rows]
        x = torch.cat(rows, dim=0)
        n = x.shape[0]
        if pad_to is not None and pad_to > n:
            # pad with zero images up to an allowed batch size: bounds the
            # number of distinct batch shapes served
            x = torch.cat([x, x.new_zeros((pad_to - n,) + tuple(x.shape[1:]))])
        return x, n

    def set_launch_hook(self, fn) -> None:
        """Install (or with None, clear) a pre-launch hook: called with the
        stacked input batch immediately before every executor launch.  An
        exception raised here fails the launch exactly as an executor fault
        would."""
        self._launch_hook = fn

    def _launch(self, x):
        """One executor launch, through the hook and on the session's
        device (the current CUDA device while it runs)."""
        if self._launch_hook is not None:
            self._launch_hook(x)
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            return self.executor(x)

    def run(self, x) -> dict:
        """One request; accepts (H, W, C) or (1, H, W, C) int8."""
        x = torch.as_tensor(x)
        out = self._launch(x[None] if x.dim() == 3 else x)
        self.n_runs += 1
        self.images_served += 1
        return out

    def run_batch(self, xs, pad_to: int | None = None) -> list[dict]:
        """Serve N queued requests as ONE batched launch; returns one output
        dict per request (leading batch dim 1, so results are directly
        comparable with per-request execution)."""
        from repro_torch.obs.trace import TRACER
        with TRACER.span("pad", cat="serve", track="batch", n=len(xs),
                         pad_to=pad_to):
            x, n = self._stack(xs, pad_to=pad_to)
        with TRACER.span("launch", cat="serve", track="batch",
                         batch=int(x.shape[0])):
            out = self._launch(x)
        self.n_runs += 1
        self.images_served += n
        return [{k: v[i:i + 1] for k, v in out.items()} for i in range(n)]

    # -------------------------------------------------------------- serving
    def serve(self, **kw):
        from repro_torch.runtime.server import Server
        return Server(self, **kw)

    def stats(self) -> dict:
        return {"n_runs": self.n_runs, "images_served": self.images_served,
                "backend": self.backend, "device": str(self.device),
                "fused_coverage": self.program.coverage,
                "n_launches": self.program.meta["n_launches"],
                "n_fallbacks": self.program.meta["n_fallbacks"]}
