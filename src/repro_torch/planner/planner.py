"""CapacityPlanner — fingerprint buckets → (starting tier, oversampling),
adapted by observed traffic.

The planner closes the loop the paper's analysis opens: the whp bounds say
what capacity *should* suffice, the :class:`repro_torch.core.TierStats` counters
say what actually did. Per fingerprint bucket (:func:`fingerprint.bucket_key`)
the planner keeps a **rung offset** over the analytic plan:

    rung 0   start at the segment-aware planned capacity (capacity.py)
    rung 1   the same bound ×2 (the ladder's planned2 scale, pre-applied)
    rung 2   start at exact — the unplanned rule, now the *learned* last resort

A bucket whose empirical starting-tier fault rate exceeds ``fault_target``
is promoted one rung (its whp story is empirically false — stop paying the
wasted attempt); a bucket that stays clean for ``probe_after`` consecutive
batches is probed one rung down (maybe the traffic got tamer). Promotion
and probing reset the bucket's counters so the new rung is judged on its
own evidence.

History persists as JSON (``path=``), so a restarted service starts where
traffic left off: the acceptance test shows a fresh planner re-loading a
fault-ridden bucket's history starts it at the promoted rung.

Writes are atomic (tmp file + rename) and **merge-on-save**: before
writing, :meth:`save` re-reads the current file and folds in what other
processes learned since this planner loaded — union of buckets, the
*higher* rung on conflict (the capacity-safe direction), and the other
side's counter deltas (disk minus the snapshot taken at load) accumulated
onto same-rung entries. Several services sharing one history path
therefore pool their traffic instead of last-write-wins clobbering each
other; the residual race window (read → rename without a lock) can lose
at most one save's worth of *observations*, never whole buckets.

The planner also exposes the generic primitives (:meth:`rung_for` /
:meth:`observe`) that ``bsp_sort_safe`` uses as an
optional policy: the same bucket→rung learning over their own capacity
ladders, with the bucket keyed by shape + algorithm only (no segment
structure to exploit there).

Planned capacities are quantized to eighths of ``n_per_proc`` (≥ one
pad_align step), so across arbitrary traffic the executor registry sees at
most ~8 planned route configs per (p, n_per_proc) shape — the compiled-
callable cache stays O(log n buckets × tiers); asserted by the soak test.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import warnings
from typing import Dict, Optional, Sequence

import numpy as np

from .. import obs
from ..core.types import round_up

from .capacity import planned_cap_for
from .fingerprint import Fingerprint, bucket_key, fingerprint_arrays

#: planner rungs over the analytic plan (see module docstring)
N_RUNGS = 3


#: route="radix" is picked when the estimated busiest range-bucket share is
#: within this factor of the perfect 1/p (see fingerprint.radix_share) —
#: balanced-enough integer keys skip the splitter superstep entirely.
RADIX_SKEW = 3.0

#: route="delta" is picked when the sampled in-order adjacent-pair share
#: (fingerprint.sampled_sortedness) is at least this high: ~0.9 means
#: roughly ≤5% of keys are out of place, where the fold's Δ-sized device
#: work beats every full-ladder route. Shuffled streams score ~0.5 and
#: never qualify. A wrong verdict costs only speed — the delta route is
#: byte-identical to the ladder by construction.
DELTA_SORTED_MIN = 0.90

#: near-sorted batches below this size take the ladder anyway — the fold's
#: fixed host split + merge overhead dominates tiny sorts.
DELTA_MIN_KEYS = 512


@dataclasses.dataclass(frozen=True)
class PlanDecision:
    """One batch's dispatch plan, also the record() correlation token."""

    bucket: str  # fingerprint bucket the learning is keyed by
    layout: str  # packing layout ("striped" / "contiguous")
    pair_capacity: str  # starting tier mode: "planned" | "whp" | "exact"
    pair_cap_override: Optional[int]  # planned capacity (keys), quantized
    omega: Optional[float]  # solved oversampling regulator
    rung: int  # learned rung this plan started at
    # distribution route: "sample" (splitter pipeline, capacity fields
    # above apply), "radix" (count-then-distribute — the launch driver
    # sizes the single rung from the true counts, so the capacity fields
    # are moot and retries are impossible by construction), or "delta"
    # (near-sorted single-segment batch: only the out-of-place Δ routes
    # through the h-relation, then one rank merge — repro_torch.delta).
    route: str = "sample"

    @property
    def start_tier(self) -> str:
        return self.route if self.route in ("radix", "delta") else self.pair_capacity


def _quantize_cap(cap: int, n_per_proc: int, pad_align: int = 8) -> int:
    """Round up to an eighth-of-n_per_proc step (bounded distinct values)."""
    step = max(pad_align, n_per_proc // 8)
    return min(n_per_proc, round_up(cap, step))


class CapacityPlanner:
    def __init__(
        self,
        path: Optional[str] = None,
        *,
        fault_target: float = 0.05,
        min_attempts: int = 8,
        probe_after: int = 32,
    ) -> None:
        self.path = path
        self.fault_target = float(fault_target)
        self.min_attempts = int(min_attempts)
        self.probe_after = int(probe_after)
        #: bucket -> {"rung", "attempts", "faults", "clean"}
        self.history: Dict[str, Dict[str, int]] = {}
        # telemetry — registry counters under this planner's instance label;
        # the legacy attribute names are read-only property views below
        self.label = obs.next_instance("planner")
        reg = obs.metrics()
        self._plans = reg.counter("planner.plans", planner=self.label)
        self._radix_plans = reg.counter("planner.radix_plans", planner=self.label)
        self._delta_plans = reg.counter("planner.delta_plans", planner=self.label)
        self._promotions = reg.counter("planner.promotions", planner=self.label)
        self._probes = reg.counter("planner.probes", planner=self.label)
        self._dirty = False  # unsaved observations (see save_if_dirty)
        #: disk snapshot at load/last save — the merge-on-save baseline for
        #: computing what OTHER processes observed since (see save)
        self._base: Dict[str, Dict[str, int]] = {}
        if path is not None and os.path.exists(path):
            # persistence is telemetry, not dispatch (mirrors the warn-only
            # save path): a corrupt/truncated/stale-format history must not
            # keep a service from coming up — start fresh and re-learn
            try:
                with open(path) as f:
                    self.load_json(f.read())
            except (OSError, ValueError, KeyError, TypeError) as e:
                warnings.warn(f"planner history at {path!r} unusable ({e}); "
                              "starting fresh")
                self.history = {}
        self._base = {k: dict(v) for k, v in self.history.items()}

    # ----------------------------------------------- legacy telemetry views
    @property
    def plans(self) -> int:
        """plan() calls."""
        return self._plans.value

    @property
    def radix_plans(self) -> int:
        """Plans routed count-then-distribute."""
        return self._radix_plans.value

    @property
    def delta_plans(self) -> int:
        """Plans routed to the near-sorted fold path."""
        return self._delta_plans.value

    @property
    def promotions(self) -> int:
        return self._promotions.value

    @property
    def probes(self) -> int:
        return self._probes.value

    # ------------------------------------------------------------ learning
    def _entry(self, bucket: str) -> Dict[str, int]:
        e = self.history.get(bucket)
        if e is None:
            e = self.history[bucket] = {
                "rung": 0, "attempts": 0, "faults": 0, "clean": 0
            }
        return e

    def rung_for(self, bucket: str, n_rungs: int = N_RUNGS) -> int:
        """The learned starting rung for ``bucket`` (clamped to the ladder)."""
        return min(self._entry(bucket)["rung"], max(0, n_rungs - 1))

    def observe(self, bucket: str, faulted: bool, n_rungs: int = N_RUNGS) -> None:
        """Feed one outcome: did the bucket's starting tier overflow?

        Promotion: empirical fault rate above ``fault_target`` after
        ``min_attempts`` observations — the wasted starting attempt costs a
        full route execution, so a rung that faults is strictly worse than
        its successor. Probe: ``probe_after`` consecutive clean runs above
        rung 0 — one batch risks one retry to rediscover the cheap regime.
        """
        e = self._entry(bucket)
        self._dirty = True
        e["attempts"] += 1
        if faulted:
            e["faults"] += 1
            e["clean"] = 0
        else:
            e["clean"] += 1
        if (
            e["attempts"] >= self.min_attempts
            and e["faults"] / e["attempts"] > self.fault_target
            and e["rung"] < n_rungs - 1
        ):
            e["rung"] += 1
            e["attempts"] = e["faults"] = e["clean"] = 0
            self._promotions.inc()
        elif e["clean"] >= self.probe_after and e["rung"] > 0:
            e["rung"] -= 1
            e["attempts"] = e["faults"] = e["clean"] = 0
            self._probes.inc()

    # ------------------------------------------------------------ planning
    def plan(
        self,
        arrays: Sequence[np.ndarray],
        p: int,
        *,
        n_per_proc: Optional[int] = None,
        min_n_per_proc: int = 8,
        fingerprint: Optional[Fingerprint] = None,
    ) -> PlanDecision:
        """Plan one batch: fingerprint → bound → learned rung → decision.

        Single-segment batches keep the contiguous raw-int32 hot path but
        still get a *planned* capacity (the bound prices their constant
        sentinel pad tail, which the classic whp bound ignores — a batch
        just past a pow2 boundary concentrates ~n_p/2 pads per lane).
        Multi-segment batches are planned for the striped layout. Either
        way, a bound at or above ``exact`` — or a bucket promoted to the
        top rung — degenerates to the unplanned rule (start at exact).
        """
        fp = fingerprint or fingerprint_arrays(
            arrays, p, n_per_proc=n_per_proc, min_n_per_proc=min_n_per_proc
        )
        single = fp.n_segments <= 1
        bucket = bucket_key(fp)
        rung = self.rung_for(bucket)
        self._plans.inc()
        layout = "contiguous" if single else "striped"
        if (
            single
            and fp.int_key
            and fp.n_keys >= DELTA_MIN_KEYS
            and fp.sorted_frac >= DELTA_SORTED_MIN
        ):
            # near-sorted stream: fold, don't resort. Checked before radix —
            # a sorted uniform stream is also perfectly range-balanced, but
            # the fold's Δ-sized work beats even the radix route's single
            # full-size rung. Capacity fields are moot (the Δ sort runs its
            # own Δ-sized exact rung) and retries are impossible, mirroring
            # the radix contract.
            self._delta_plans.inc()
            return PlanDecision(bucket, layout, "exact", None, None, rung,
                                route="delta")
        if fp.int_key and fp.radix_share <= min(1.0, RADIX_SKEW / p):
            # balanced integer keys: count-then-distribute. No oversampling
            # to solve and no capacity to plan — the route's launch path
            # reads the exact counts off the prepared boundaries and the
            # ladder is one rung, so there is nothing for the fault
            # feedback to learn either (observe() still records the clean
            # run, keeping the bucket's probe counters truthful).
            self._radix_plans.inc()
            return PlanDecision(bucket, layout, "exact", None, None, rung,
                                route="radix")
        if rung >= N_RUNGS - 1:
            return PlanDecision(bucket, layout, "exact", None, None, rung)
        omega, cap = planned_cap_for(fp, single_segment=single)
        cap = _quantize_cap(cap << rung, fp.n_per_proc)
        if cap >= fp.n_per_proc:
            return PlanDecision(bucket, layout, "exact", None, None, rung)
        return PlanDecision(bucket, layout, "planned", cap, omega, rung)

    def record(self, decision: PlanDecision, faulted: bool) -> None:
        """Feed a dispatched batch's outcome back.

        ``faulted`` means the *starting* tier's attempt overflowed (i.e. the
        escalation driver retried at least once) — exact starts cannot
        fault on the pair capacity but still count as clean evidence for
        the probe-down counter. Persistence is deferred: callers flush the
        accumulated observations with :meth:`save_if_dirty` (the service
        does so once per flush, not once per batch).
        """
        self.observe(decision.bucket, faulted)

    # --------------------------------------------------------- persistence
    def to_json(self) -> str:
        return json.dumps(
            {
                "version": 1,
                "fault_target": self.fault_target,
                "buckets": self.history,
            },
            indent=1,
            sort_keys=True,
        )

    def load_json(self, text: str) -> None:
        data = json.loads(text)
        if data.get("version") != 1:
            raise ValueError(f"unknown planner history version {data.get('version')!r}")
        self.history = {
            k: {f: int(v[f]) for f in ("rung", "attempts", "faults", "clean")}
            for k, v in data["buckets"].items()
        }

    def _merge_disk(self, path: str) -> None:
        """Fold another process's on-disk observations into ``history``.

        Disk buckets unknown to us are adopted; on a shared bucket the
        higher rung wins (capacity-safe), and when rungs agree the disk
        side's counter *deltas* since our load snapshot are accumulated (so
        observations this planner already loaded are not double-counted).
        """
        try:
            with open(path) as f:
                other = CapacityPlanner()
                other.load_json(f.read())
        except (OSError, ValueError, KeyError, TypeError):
            return  # absent/corrupt: nothing to merge, overwrite cleanly
        for bucket, disk in other.history.items():
            own = self.history.get(bucket)
            if own is None:
                self.history[bucket] = dict(disk)
                continue
            if disk["rung"] > own["rung"]:
                self.history[bucket] = dict(disk)
            elif disk["rung"] == own["rung"]:
                base = self._base.get(bucket, {})
                for f_ in ("attempts", "faults", "clean"):
                    own[f_] += max(0, disk[f_] - base.get(f_, 0))

    def save(self, path: Optional[str] = None) -> str:
        """Atomically write the history JSON (tmp + rename), merge-on-save."""
        path = path or self.path
        if path is None:
            raise ValueError("no path configured for planner persistence")
        if os.path.exists(path):
            self._merge_disk(path)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".planner")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(self.to_json() + "\n")
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        self._dirty = False
        self._base = {k: dict(v) for k, v in self.history.items()}
        return path

    def save_if_dirty(self) -> bool:
        """Persist iff configured (``path``) and observations accumulated."""
        if self.path is None or not self._dirty:
            return False
        self.save()
        return True

    def telemetry(self) -> Dict[str, object]:
        return {
            "plans": self.plans,
            "radix_plans": self.radix_plans,
            "delta_plans": self.delta_plans,
            "buckets": len(self.history),
            "promotions": self.promotions,
            "probes": self.probes,
            "rungs": {k: v["rung"] for k, v in sorted(self.history.items())},
        }
