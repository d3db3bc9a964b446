# Copied from src/repro/stages/pipeline.py; imports point at repro_torch.
"""One-call front end over the staged pipeline, with zoo integration.

``compile_model`` walks Wrapped -> Lowered -> Planned -> Compiled through a
``StageCache`` (the shared ``STAGE_CACHE`` by default), so a warm recompile
of identical inputs hits all four stage caches and compiles nothing.  Given
a ``repro_torch.zoo.ModelZoo`` it also consults the on-disk store first —
keyed by a *source* fingerprint (wrapped key + profile + partition + plan
knobs) that is computable before any search runs — and shelves fresh
compilations under their content address.
"""
from __future__ import annotations

from repro_torch.asm import artifact as _art
from repro_torch.stages.cache import STAGE_CACHE, StageCache
from repro_torch.stages.stages import Compiled, _INHERIT, _resolve_profile, wrap


def source_key(wrapped_key: str, profile_hash: str | None, host_sig: str,
               pin_input: bool, ddr_budget_bytes: int) -> str:
    """Fingerprint of compile-pipeline *inputs* (no search needed): what the
    zoo indexes so a reopen can find an artifact without recompiling."""
    return _art._sha(["source", wrapped_key, profile_hash or "analytic",
                      host_sig, bool(pin_input), int(ddr_budget_bytes),
                      _art.FORMAT_VERSION])


def compile_model(g, qm, dev, *, profile=None, device_of=None, strategy=None,
                  evaluator=None, enable_horizontal: bool = True,
                  pin_input: bool = False, ddr_budget_bytes: int | None = None,
                  cache: StageCache | None = _INHERIT, zoo=None,
                  name: str | None = None) -> Compiled:
    """Compile (or reopen) one model end to end through the staged pipeline.

    Returns the ``Compiled`` stage.  With ``zoo=`` the on-disk store is
    consulted before compiling (reopen = zero stages run) and fresh
    compilations are shelved into it under ``name``."""
    if cache is _INHERIT:
        cache = STAGE_CACHE
    resolved = _resolve_profile(profile)
    wrapped = wrap(g, qm, dev, cache=cache)

    host = (sorted(n.name for n in g
                   if n.op != "input" and device_of(n.name) != "acc")
            if device_of is not None else [])
    skey = source_key(wrapped.key,
                      resolved.hash() if resolved is not None else None,
                      _art._sha(host), pin_input,
                      int(ddr_budget_bytes or 0))

    from repro_torch.obs.events import EVENTS

    if zoo is not None and strategy is None:
        art = zoo.find_source(skey)
        if art is not None:
            EVENTS.emit("compile.model", model=name, source_key=skey[:16],
                        reopened=True,
                        message=f"model {name or skey[:16]} reopened from "
                                "zoo (0 stages run)")
            return Compiled.from_artifact(art)

    lowered = wrapped.lower(strategy=strategy, profile=resolved,
                            evaluator=evaluator, device_of=device_of,
                            enable_horizontal=enable_horizontal, cache=cache)
    compiled = lowered.plan(pin_input=pin_input,
                            ddr_budget_bytes=ddr_budget_bytes,
                            cache=cache).compile(cache=cache)
    if zoo is not None:
        zoo.put(compiled.artifact, name=name, source_key=skey)
    EVENTS.emit("compile.model", model=name, source_key=skey[:16],
                reopened=False,
                message=f"model {name or skey[:16]} compiled through the "
                        "staged pipeline")
    return compiled
