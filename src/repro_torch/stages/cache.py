# Copied from src/repro/stages/cache.py; imports point at repro_torch.
"""LRU cache of compile-stage objects, keyed by stable content hashes.

One :class:`StageCache` holds all four stage tables (wrapped / lowered /
planned / compiled); each table is independently LRU-bounded so a many-model
server can keep dozens of cheap ``Wrapped`` stages resident while bounding
the artifact-bearing ``Compiled`` entries.  Hit/miss/eviction counts are
emitted into the shared metrics registry under ``stages.<stage>.*`` — the
zoo benchmark's "warm reopen compiles 0 stages" gate reads them.
"""
from __future__ import annotations

import threading
import time

STAGE_NAMES = ("wrapped", "lowered", "planned", "compiled")


class StageCache:
    """Thread-safe per-stage LRU memoization for the staged compile pipeline.

    ``get_or_build(stage, key, build)`` returns the cached stage object for
    ``key`` when present (LRU-refreshed) and otherwise calls ``build()``,
    stores the result, and returns it.  Keys are the stages' own content
    hashes, so equal inputs always share one stage object — the same
    contract ``PlanCache`` gives whole artifacts, pushed down to every
    intermediate stage.
    """

    def __init__(self, max_entries: int = 32, registry=None, events=None):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = max_entries
        self._tables: dict[str, dict] = {s: {} for s in STAGE_NAMES}
        self._lock = threading.Lock()
        if registry is None:
            from repro_torch.obs.metrics import REGISTRY
            registry = REGISTRY
        self._registry = registry
        self._events = events

    def _evt(self):
        if self._events is None:
            from repro_torch.obs.events import EVENTS
            self._events = EVENTS
        return self._events

    def _count(self, stage: str, what: str) -> None:
        self._registry.counter(f"stages.{stage}.{what}").inc()

    def get_or_build(self, stage: str, key, build):
        """(stage object, cache hit?) — ``build`` runs outside the lock."""
        table = self._tables[stage]
        with self._lock:
            obj = table.get(key)
            if obj is not None:
                table[key] = table.pop(key)        # refresh LRU position
        if obj is not None:
            self._count(stage, "hits")
            return obj, True
        t0 = time.perf_counter()
        obj = build()
        self._count(stage, "misses")
        self._evt().emit("compile.stage", stage=stage, key=str(key)[:16],
                         seconds=time.perf_counter() - t0,
                         message=f"built {stage} stage in "
                                 f"{time.perf_counter() - t0:.3f}s")
        evicted = 0
        with self._lock:
            table.pop(key, None)
            table[key] = obj
            while len(table) > self.max_entries:
                table.pop(next(iter(table)))
                evicted += 1
        for _ in range(evicted):
            self._count(stage, "evictions")
        if evicted:
            self._evt().emit("cache.evict", stage=stage, n=evicted,
                             message=f"stage cache evicted {evicted} "
                                     f"{stage} entr"
                                     f"{'y' if evicted == 1 else 'ies'}")
        return obj, False

    def stats(self) -> dict:
        with self._lock:
            return {s: len(t) for s, t in self._tables.items()}

    def clear(self) -> None:
        with self._lock:
            for t in self._tables.values():
                t.clear()

    def __len__(self) -> int:
        with self._lock:
            return sum(len(t) for t in self._tables.values())


# Shared default cache: ``stages.compile_model`` and the zoo's warm-reopen
# path memoize here unless handed their own.
STAGE_CACHE = StageCache()


def _through(cache: StageCache | None, stage: str, key, build):
    """Run ``build`` through ``cache`` when one is given (None = pure
    compute: ``asm.compile_strategy``'s thin-wrapper path)."""
    if cache is None:
        return build(), False
    return cache.get_or_build(stage, key, build)
