"""Seeded fault injection and graceful degradation (port of
``repro.faults``).

* ``plan``   — the ``FaultPlan`` registry and schedule (static, JSON-able).
* ``inject`` — deterministic message-site injection (dense rows, wire
               bit flips), replayable from ``(plan, attack_key)``.
* ``guard``  — fail-closed validity masks and the masked bucket operator
               that the plain masked rules and the kernels share.
"""
from repro_torch.faults.plan import (FAULTS, MESSAGE_FAULTS, PROCESS_FAULTS,
                                     TENSOR_FAULTS, WIRE_FAULTS, FaultPlan,
                                     FaultSpec, as_plan)
from repro_torch.faults import guard, inject  # noqa: F401

__all__ = ["FAULTS", "MESSAGE_FAULTS", "PROCESS_FAULTS", "TENSOR_FAULTS",
           "WIRE_FAULTS", "FaultPlan", "FaultSpec", "as_plan", "guard",
           "inject"]
