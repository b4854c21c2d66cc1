"""Elastic scaling, straggler mitigation and capacity-fault retry.

Host-level control plane (pure Python, the JAX package's
``repro.train.elastic`` copied; no tensor state):

* ``StragglerMonitor`` — per-step wall-time EWMA; a step exceeding
  ``threshold ×`` the EWMA marks the step slow. After ``patience``
  consecutive slow steps the driver is told to re-mesh without the slow
  hosts (the set of live hosts comes from the cluster's coordination
  service; here it is injected for tests).
* ``plan_remesh`` — given surviving device count, pick the largest
  (data × model) grid that preserves the model axis (TP degree must not
  change — parameter layout is tied to it) and shrinks data-parallelism;
  global batch is preserved via gradient-accumulation factor.
* ``retry_capacity`` — the BSP routing layers surface ``overflow`` flags
  (a sort may not drop keys); the driver retries the step with the next
  capacity tier (1.25× ladder) up to the exactness tier n/p.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.0
    patience: int = 3
    ewma: float = 0.0
    alpha: float = 0.1
    slow_streak: int = 0
    steps: int = 0

    def is_slow(self, seconds: float) -> bool:
        """Pure check: would this wall time count as a straggler now?

        Unlike :meth:`record` this neither advances the warmup nor moves
        the EWMA — callers that want to *count* slow events separately
        from the re-mesh signal (e.g. the service dispatcher's
        ``svc.straggler_flights``) check first, then record.
        """
        if self.steps <= 3 or self.ewma == 0:  # warmup: nothing to compare
            return False
        return seconds > self.threshold * self.ewma

    def record(self, seconds: float) -> bool:
        """Returns True if the driver should consider re-meshing."""
        self.steps += 1
        if self.steps <= 3:  # warmup
            self.ewma = seconds if self.ewma == 0 else self.ewma
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
            return False
        slow = seconds > self.threshold * self.ewma
        self.slow_streak = self.slow_streak + 1 if slow else 0
        if not slow:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * seconds
        return self.slow_streak >= self.patience


def plan_remesh(
    n_devices: int, model_axis: int, old_data_axis: int, global_batch: int
) -> Tuple[Tuple[int, int], int]:
    """((data, model), accumulation_factor) for the surviving device count.

    The model axis is pinned (weight layout); data parallelism shrinks to
    the largest power-of-two that fits; the lost throughput is recovered by
    gradient accumulation so the *global batch is invariant* across
    elasticity events (loss curves stay comparable).
    """
    if n_devices < model_axis:
        raise ValueError(
            f"cannot preserve model axis {model_axis} with {n_devices} devices"
        )
    data = n_devices // model_axis
    # largest power of two ≤ data
    d = 1
    while d * 2 <= data:
        d *= 2
    accum = max(1, old_data_axis // d)
    if global_batch % (d * accum):
        accum = old_data_axis // d  # keep divisibility; caller validates
    return (d, model_axis), accum


def retry_capacity(
    run_step: Callable[[float], Tuple[object, bool]],
    *,
    tiers: Optional[List[float]] = None,
) -> object:
    """Run ``run_step(capacity_factor)`` → (result, overflow); escalate
    through the capacity ladder until clean. The last tier is exact (no
    overflow is possible at pair_cap = n/p — Lemma 5.1's regime)."""
    tiers = tiers or [1.0, 1.25, 1.5625, float("inf")]
    for cf in tiers:
        result, overflow = run_step(cf)
        if not overflow:
            return result
    raise RuntimeError("capacity escalation exhausted (unreachable: last tier exact)")


@dataclasses.dataclass
class StepTimer:
    t0: float = 0.0

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return False
