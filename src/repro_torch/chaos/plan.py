"""FaultPlan — a deterministic, seeded schedule of injectable faults.

Host code, the JAX package's ``repro.chaos.plan`` copied: the draws hash
the same ``repr`` with the same blake2b, so one seed injects the same
faults in both packages.

The recovery machinery (capacity-tier ladder, failsink bisection, the
delta view's resort fallback) only earns trust when it is *exercised*:
production faults are rare and irreproducible, so the chaos layer makes
them cheap and exactly repeatable. A :class:`FaultPlan` is threaded
through ``SortConfig``/``ServiceConfig`` the same hash/compare-excluded
way as ``obs`` — a faulted config and a clean one are EQUAL, share
executor-registry entries, and run the *same stage callables*; every
injection is a host-side decision at a driver boundary:

* **capacity faults** — :meth:`fault_capacity` flips the host-read
  overflow decision of a non-terminal ladder rung in
  ``core.api.InFlightSort.wait``, forcing the whp→exact→allgather
  escalation exactly as a real oversampling fault would (the rung's
  device result is discarded; the next rung's result is byte-identical).
  The terminal rung is never faulted — innocents always complete.
* **launch faults** — :meth:`check_launch` raises :class:`ChaosError`
  from the dispatcher's plan/pack/launch path, exercising failsink
  bisection. ``poison_rids`` fault *every* dispatch containing the rid
  (terminal solo failure, the future carries a ``SortServiceError``
  naming it); ``transient_error_rate`` faults each distinct rid-set at
  most **once** (the retry/bisection recovers, innocents complete).
* **stragglers** — :meth:`straggle_delay` injects a host-side sleep at
  the flight's completion sync, feeding the dispatcher's
  ``train/elastic.StragglerMonitor`` wiring.
* **fold corruption** — :meth:`corrupt_fold` corrupts the sorted Δ run
  inside ``delta.SortedView.fold`` before the rank-merge; the view's
  post-merge monotonicity check catches it and falls back to a full
  resort from the preserved pre-fold state (byte-identity preserved).

Determinism: every rate-based decision is a pure hash of
``(seed, kind, key)`` — **independent of call order** — so a fixed seed
over a fixed workload injects the same faults on every run, which is what
lets the ``chaos`` bench table gate ``innocents_failed == 0`` and
``recovered_batches`` as exact-match identity fields. Explicit schedules
(``capacity_faults``, ``fail_batches``, ``straggle_flights``,
``corrupt_folds``) compose with the rates for targeted tests.

Injections are counted per kind in the process-wide metrics registry
(``chaos.injected{plan=<label>, kind=...}``); span/point emission rides
the *consumer's* tracer under ``cat="chaos"`` (the plan itself carries no
tracer — it must stay safe to share across services and sorts).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Dict, Optional, Sequence, Tuple

from .. import obs

__all__ = ["ChaosError", "FaultPlan", "resolve_chaos"]


class ChaosError(RuntimeError):
    """An injected (not organic) fault, raised from a driver boundary."""


def _draw(seed: int, kind: str, *key) -> float:
    """Uniform [0, 1) from a stable hash of (seed, kind, key).

    Order-independent by construction: the decision for a given key never
    depends on how many draws happened before it, so async scheduling
    cannot perturb the fault schedule.
    """
    h = hashlib.blake2b(
        repr((int(seed), kind) + tuple(key)).encode(), digest_size=8
    ).digest()
    return int.from_bytes(h, "big") / float(1 << 64)


@dataclasses.dataclass
class FaultPlan:
    """Seeded fault schedule; see the module docstring for the fault kinds.

    Rates are per-opportunity probabilities drawn deterministically from
    ``seed``; the explicit tuples force specific injection points (both
    compose). ``max_faults`` caps total injections across all kinds.
    """

    seed: int = 0
    # --- capacity faults: flip a non-terminal rung's overflow decision
    capacity_fault_rate: float = 0.0  # per (sort_seq, rung) opportunity
    capacity_fault_rungs: Tuple[int, ...] = (0,)  # rungs eligible for rate
    capacity_faults: Tuple[Tuple[int, int], ...] = ()  # explicit (sort, rung)
    # --- launch faults: raise ChaosError from the dispatch path
    poison_rids: Tuple[int, ...] = ()  # every dispatch with the rid faults
    transient_error_rate: float = 0.0  # per distinct rid-set, at most once
    fail_batches: Tuple[int, ...] = ()  # explicit batch launch seqs, once
    # --- stragglers: host-side sleep at the flight completion sync
    straggle_rate: float = 0.0  # per flight completion
    straggle_s: float = 0.0  # injected delay per straggled flight
    straggle_flights: Tuple[int, ...] = ()  # explicit flight seqs
    # --- delta fold corruption: corrupt the sorted Δ run pre-merge
    fold_corrupt_rate: float = 0.0  # per fold
    corrupt_folds: Tuple[int, ...] = ()  # explicit fold seqs
    max_faults: Optional[int] = None  # cap on total injections (None: off)

    def __post_init__(self) -> None:
        self.label = obs.next_instance("chaos")
        self._injected_total = 0
        self._fired_sets: set = set()  # rid-sets already transiently failed
        self._fired_batches: set = set()  # explicit batch seqs already fired
        self._sort_seq = itertools.count()
        self._batch_seq = itertools.count()
        self._flight_seq = itertools.count()
        self._fold_seq = itertools.count()

    # ----------------------------------------------------------- counting
    def _count(self, kind: str) -> None:
        self._injected_total += 1
        obs.metrics().counter(
            "chaos.injected", plan=self.label, kind=kind
        ).inc()

    def _budget_ok(self) -> bool:
        return self.max_faults is None or self._injected_total < self.max_faults

    @property
    def injected(self) -> Dict[str, int]:
        """kind -> injection count (view over the metrics registry)."""
        return {
            str(lbl["kind"]): c.value
            for lbl, c in obs.metrics().collect(
                "chaos.injected", plan=self.label
            )
        }

    @property
    def injected_total(self) -> int:
        return self._injected_total

    # --------------------------------------------------- sequence handles
    # The drivers key faults by *stable sequence numbers* they draw at the
    # relevant boundary; under FIFO single-threaded dispatch the sequences
    # are deterministic, and the hashed draws are order-independent anyway.
    def next_sort(self) -> int:
        return next(self._sort_seq)

    def next_batch(self) -> int:
        return next(self._batch_seq)

    def next_flight(self) -> int:
        return next(self._flight_seq)

    def next_fold(self) -> int:
        return next(self._fold_seq)

    # ------------------------------------------------------ fault queries
    def fault_capacity(self, sort_seq: int, rung: int) -> bool:
        """Force a capacity fault at (sort_seq, rung)? Called only for
        non-terminal rungs (the driver never faults the last rung)."""
        hit = (int(sort_seq), int(rung)) in self.capacity_faults or (
            rung in self.capacity_fault_rungs
            and self.capacity_fault_rate > 0
            and _draw(self.seed, "cap", sort_seq, rung)
            < self.capacity_fault_rate
        )
        if hit and self._budget_ok():
            self._count("capacity_fault")
            return True
        return False

    def check_launch(self, batch_seq: int, rids: Sequence[int]) -> None:
        """Raise :class:`ChaosError` if this dispatch should fault.

        Poison rids fault unconditionally (terminal once solo); explicit
        ``fail_batches`` and the transient rate fault each key at most
        once, so failsink recovery always converges.
        """
        poisoned = sorted(set(rids) & set(self.poison_rids))
        if poisoned and self._budget_ok():
            self._count("poison")
            raise ChaosError(
                f"injected poison fault (rid {poisoned[0]} in batch)"
            )
        if (
            batch_seq in self.fail_batches
            and batch_seq not in self._fired_batches
            and self._budget_ok()
        ):
            self._fired_batches.add(batch_seq)
            self._count("launch_error")
            raise ChaosError(f"injected launch fault (batch {batch_seq})")
        key = tuple(sorted(int(r) for r in rids))
        if (
            self.transient_error_rate > 0
            and key not in self._fired_sets
            and _draw(self.seed, "launch", key) < self.transient_error_rate
            and self._budget_ok()
        ):
            self._fired_sets.add(key)
            self._count("launch_error")
            raise ChaosError(
                f"injected transient launch fault (rids {list(key)})"
            )

    def straggle_delay(self, flight_seq: int) -> float:
        """Seconds of injected host delay before this flight's sync."""
        hit = flight_seq in self.straggle_flights or (
            self.straggle_rate > 0
            and _draw(self.seed, "straggle", flight_seq) < self.straggle_rate
        )
        if hit and self.straggle_s > 0 and self._budget_ok():
            self._count("straggle")
            return float(self.straggle_s)
        return 0.0

    def corrupt_fold(self, fold_seq: int) -> bool:
        """Corrupt this fold's sorted Δ run (pre-merge)?"""
        hit = fold_seq in self.corrupt_folds or (
            self.fold_corrupt_rate > 0
            and _draw(self.seed, "fold", fold_seq) < self.fold_corrupt_rate
        )
        if hit and self._budget_ok():
            self._count("fold_corruption")
            return True
        return False


def resolve_chaos(handle) -> Optional[FaultPlan]:
    """Duck-typed chaos resolution, mirroring ``obs.resolve_tracer``.

    Accepts a :class:`FaultPlan` (or anything exposing its query surface)
    or None. Config fields hold the handle as ``Optional[object]`` so the
    core layer never imports chaos at type level.
    """
    if handle is None:
        return None
    if hasattr(handle, "fault_capacity") and hasattr(handle, "check_launch"):
        return handle
    raise TypeError(
        f"chaos handle {handle!r} lacks the FaultPlan query surface"
    )
