# Copied from src/repro/memory/__init__.py; imports point at repro_torch.
"""Memory planning (paper §3.1 "data layouts" + §3.2 assembler support).

The paper describes DNNVM as "an integration of optimizers for graphs, loops
and data layouts, and an assembler"; this package is the data-layout half:

* ``liveness``  — activation lifetimes over the group execution order;
* ``ddr_alloc`` — first-fit interval allocation of DDR offsets with reuse;
* ``banks``     — ping/pong split of the B_in / B_out BRAM budgets (Eq. 6)
  for double buffering;
* ``planner``   — ties the three together into a :class:`MemoryPlan` the
  assembler (``core.isa``) threads into address-bearing instructions.
"""
from repro_torch.memory.banks import BankPlan, plan_banks
from repro_torch.memory.ddr_alloc import DDRPlan, Placement, first_fit
from repro_torch.memory.liveness import Interval, activation_intervals
from repro_torch.memory.planner import MemoryPlan, MemoryPlanError, plan_memory

__all__ = [
    "Interval", "activation_intervals",
    "DDRPlan", "Placement", "first_fit",
    "BankPlan", "plan_banks",
    "MemoryPlan", "MemoryPlanError", "plan_memory",
]
