# Copied from src/repro/asm/__init__.py; imports point at repro_torch.
"""Assembler artifact layer (paper §3.2: "an assembler, a runtime supporter").

``compile_strategy`` lowers a path-searched execution strategy into an
addressed instruction stream (memory planner + ``core.isa``), audits it with
the simulator's hazard oracle, lowers the backend ``GroupProgram``
(``core.lower``: fused-launch descriptors + reasoned fallbacks), and packages
everything a runtime needs — instructions, program, execution groups,
quantization metadata, memory-plan summary — into a single serializable
:class:`CompiledArtifact` ("DNNVM object file", an npz, format v3).
``PLAN_CACHE`` memoizes compilation by (graph, device, strategy, quant) so
repeated serving requests reload plans instead of recompiling.
"""
from repro_torch.asm.artifact import (
    ArtifactError,
    CompiledArtifact,
    PlanCache,
    PlanResult,
    PLAN_CACHE,
    assemble_artifact,
    compile_strategy,
    device_of_artifact,
    graph_signature,
    load_artifact,
    plan_strategy,
    quant_signature,
    save_artifact,
    strategy_signature,
)

__all__ = [
    "ArtifactError", "CompiledArtifact", "PlanCache", "PlanResult",
    "PLAN_CACHE",
    "assemble_artifact", "compile_strategy", "device_of_artifact",
    "graph_signature", "load_artifact", "plan_strategy", "quant_signature",
    "save_artifact", "strategy_signature",
]
