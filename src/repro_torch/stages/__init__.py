# Copied from src/repro/stages/__init__.py; imports point at repro_torch.
"""Staged compile pipeline: Wrapped -> Lowered -> Planned -> Compiled.

Each compiler phase is a first-class, content-hashed, individually-cacheable
object (the JaCe stage protocol adapted to DNNVM's phases), so partial
recompiles — re-tune tiles without re-running pathsearch, re-plan memory
for a different DDR budget without re-searching — reuse upstream stages,
and an on-disk model zoo can content-address object files (the
reference's ``zoo`` is not ported yet: ROADMAP, Queue 1 item 6).

    from repro_torch.stages import wrap, compile_model

    co = compile_model(g, qm, ZU2)                   # all four stages
    sess = co.session(device="cuda")

    w  = wrap(g, qm, ZU2)                            # or stage by stage
    lo = w.lower()                                   # search + lower
    pl = lo.plan(pin_input=True)                     # re-plan only
    co = pl.compile()
"""
from repro_torch.stages.cache import STAGE_CACHE, STAGE_NAMES, StageCache
from repro_torch.stages.pipeline import compile_model, source_key
from repro_torch.stages.stages import (Compiled, Lowered, Planned, Wrapped,
                                 artifact_stage_keys, wrap)

__all__ = [
    "Compiled", "Lowered", "Planned", "STAGE_CACHE", "STAGE_NAMES",
    "StageCache", "Wrapped", "artifact_stage_keys", "compile_model",
    "source_key", "wrap",
]
