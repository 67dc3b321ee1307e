"""repro_torch.resilience: deterministic fault injection, the port of the
JAX package's ``repro.resilience``.

``faults`` is the injection substrate (DESIGN.md §13): named sites, seeded
(site, nth-call) → raise/hang/corrupt/delay schedules, context-manager
scoped, null-cost when disabled. The degradation policies live where the
state lives (the train loop, the generator refresh, the serving engine,
checkpointing); this package only provides the levers that let a chaos
suite prove they work.
"""
from repro_torch.resilience.faults import (Fault, FaultPlan, FaultRegistry,
                                           InjectedFault, active, fire, inject,
                                           install, poison, random_plan)

__all__ = ["Fault", "FaultPlan", "FaultRegistry", "InjectedFault",
           "active", "fire", "inject", "install", "poison", "random_plan"]
