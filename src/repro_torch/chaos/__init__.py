"""Chaos layer of the port: deterministic seeded fault injection for the
sort service (the JAX package's ``repro.chaos``, copied).

    FaultPlan     — seeded schedule of injectable faults (capacity faults,
                    launch errors, poison rids, straggler delays, delta
                    fold corruption), threaded through SortConfig/
                    ServiceConfig hash-excluded like ``obs`` so faulted
                    configs share executor entries.
    ChaosError    — the exception injected launch faults raise (recovered
                    by failsink bisection like any organic error).
    resolve_chaos — duck-typed handle resolution for the driver layers.

See plan.py for the injection points and the determinism contract.
"""
from .plan import ChaosError, FaultPlan, resolve_chaos

__all__ = ["ChaosError", "FaultPlan", "resolve_chaos"]
