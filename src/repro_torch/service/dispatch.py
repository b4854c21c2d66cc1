"""Async dispatch queue: futures, in-flight batches, failsink isolation.

The JAX package's ``repro.service.dispatch``, ported: the same queue,
failsink, backoff, breaker, deadline and chaos logic, with launches on the
port's device (the card unless the service names another). Completion
copies each flight's flat keys and positions to the host once and splits
them there, so results are numpy arrays as in the JAX package.

The service's original ``flush`` was a barrier: every submitter stalled
while one batch's collectives ran, and the host sat idle between batches —
exactly the regularity the BSP model promises, wasted at the service layer.
This module restructures dispatch around three pieces:

* :class:`SortFuture` — ``submit()``'s return value. Created unresolved;
  ``result()`` drives the dispatcher until the request completes (or
  re-raises its failure). A future outlives the service's bounded
  unclaimed-result store: the result is cached on the future at resolution,
  so an evicted store entry is still claimable by the caller that holds the
  future. ``cancel()`` unpicks a not-yet-launched request — out of the
  service's pending list or out of its *formed* batch in the dispatcher
  queue (the batch re-forms without it) — and resolves the future with a
  :class:`SortCancelledError`; a launched request is past cancellation.

* :class:`Dispatcher` — a queue of formed batches plus up to
  ``max_in_flight`` *launched* ones. Launching a batch is host work
  (fingerprint → plan → pack) ending in :func:`segmented_sort_launch`,
  which dispatches the sort's first capacity rung to the device queue and
  returns without blocking — so while batch k's collectives execute, the
  dispatcher is already planning/packing/launching batch k+1 (CUDA's
  asynchronous launches provide the overlap — every host-to-device copy
  on the launch path is pinned and asynchronous, ``core.types.to_device``;
  ``overlapped_launches`` counts launches performed with another batch's
  device work outstanding). Completion
  (:meth:`Dispatcher.step`) blocks on the *oldest* flight only, resolves
  its futures, and feeds the planner its fault outcome — planner feedback
  is a completion callback, not a dispatch-path stall.
  :meth:`Dispatcher.run_pending` is the driver pump: callable from a
  thread or event loop, it expires overdue deadlines, launches
  backoff-due batches into free slots, and (optionally) completes
  flights — so deadline- and backoff-due work proceeds without any
  submitter blocking.

* **Failsink** per-request fault isolation. A batch that raises (backend
  error, ladder exhaustion, injected :class:`repro_torch.chaos.ChaosError`)
  used to crash-requeue every rid and re-raise at the submitter; one
  poison request could re-fail the whole queue forever. Now the
  dispatcher *bisects*: the failed batch is split in two and both halves
  re-formed and re-enqueued at the queue head, recursively, until the
  poison request stands alone. Every rid then gets exactly one solo
  retry (whether it arrived solo or was isolated by bisection — so a
  one-shot fault on the isolation dispatch never kills an innocent);
  if it still fails, its future resolves with a :class:`SortServiceError`
  naming the rid — every innocent rid in the original batch completes
  normally, and every future resolves (no rid is ever lost or silently
  requeued). Requests that rode a failsink re-dispatch carry a
  ``failsink=True`` telemetry mark on their result and future.

Failsink re-enqueues are wrapped in a **retry budget with exponential
backoff**: each re-dispatch generation waits
``failsink_backoff_s · 2^attempt`` (capped at ``failsink_backoff_max_s``)
before it is launch-eligible, and the pump *scans past* backing-off
entries — innocents from a bisected batch and fresh traffic never starve
behind the retry queue. A lineage that exhausts ``fault_retry_budget``
generations skips further bisection and explodes straight to per-rid solo
dispatches (isolation accelerates; innocents still complete). A **circuit
breaker** watches consecutive failures per pow2 bucket: at
``breaker_threshold`` the bucket degrades from fused-batch to per-request
exact sort for ``breaker_cooldown_s`` (``breaker_opened`` /
``breaker_degraded_batches`` telemetry) — a repeatedly-poisoned bucket
stops dragging innocents into its failing fused launches at all.

Chaos injection (``ServiceConfig.chaos`` — a ``repro_torch.chaos.FaultPlan``,
hash-excluded like ``obs``) exercises all of the above deterministically:
launch faults raise at the top of the launch path, straggler delays sleep
at the flight sync (feeding the ``train/elastic.StragglerMonitor`` wiring
— slow flights count in ``svc.straggler_flights``), and capacity faults
ride the plan into ``core.api.InFlightSort``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..chaos import ChaosError, resolve_chaos
from ..core.api import SortExecutor, TierStats
from ..core.segmented import (
    InFlightSegmentedSort,
    pack_segments,
    segmented_sort_launch,
)
from ..core.types import resolve_device
from ..delta import SortedView, near_sorted_sort_launch
from ..planner import CapacityPlanner

from .batch import Batch, BatchFormer


def plan_overrides(decision) -> Dict[str, object]:
    """The segmented sort's overrides for a planner decision (its route
    and starting capacity; ``route="delta"`` batches skip the segmented
    sort and do not come here)."""
    overrides: Dict[str, object] = {"pair_capacity": decision.pair_capacity}
    if decision.route == "radix":
        # count-then-distribute: the launch driver host-reads the exact
        # counts and runs ONE rung — radix batches report retries == 0
        # by construction
        overrides["route"] = "radix"
    elif decision.pair_capacity == "planned":
        overrides["pair_cap_override"] = decision.pair_cap_override
        overrides["omega"] = decision.omega
    return overrides


class SortServiceError(RuntimeError):
    """A service request (or batch) failed; ``rids`` names the victims."""

    def __init__(self, message: str, rids: Tuple[int, ...] = ()) -> None:
        super().__init__(message)
        self.rids = tuple(rids)


class SortTimeoutError(SortServiceError):
    """A request's ``deadline_s`` expired before its batch launched."""


class SortCancelledError(SortServiceError):
    """A request was cancelled before its batch launched."""


class SortFuture:
    """Handle for one submitted request; resolves to a ``RequestResult``.

    ``submit()`` returns immediately with one of these — nothing has been
    dispatched yet. ``result()`` blocks (driving the service's dispatcher)
    until the request's batch completes, then returns the request's
    :class:`repro_torch.service.RequestResult`; if the request failed past the
    failsink ladder, it re-raises the stored :class:`SortServiceError`.
    ``done()`` never blocks. The resolved result is cached here, so the
    future stays claimable even after the service's bounded unclaimed-result
    store evicted it.

    ``cancel()`` asks the service to unpick the request while it is still
    un-launched (pending, or formed-but-queued — the batch re-forms
    without it); on success the future resolves with a
    :class:`SortCancelledError` and returns True. A request whose batch
    already launched (or that already resolved) reports False and runs to
    completion normally. ``deadline_at`` (set by ``submit(deadline_s=…)``)
    is the perf_counter instant past which an *un-launched* request is
    expired with a :class:`SortTimeoutError` by the deadline sweeps.
    """

    def __init__(self, rid: int, drive: Callable[["SortFuture"], None]) -> None:
        self.rid = rid
        self.submitted_at = time.perf_counter()
        self.deadline_at: Optional[float] = None
        self.failsink = False  # rode a failsink re-dispatch
        self._drive = drive
        self._canceller: Optional[Callable[["SortFuture"], bool]] = None
        self._done = False
        self._result = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done

    def result(self):
        if not self._done:
            self._drive(self)
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self) -> Optional[BaseException]:
        if not self._done:
            self._drive(self)
        return self._exc

    def cancel(self) -> bool:
        """Unpick the request if it has not launched; True on success."""
        if self._done or self._canceller is None:
            return False
        return bool(self._canceller(self))

    def cancelled(self) -> bool:
        """Whether the future resolved via :meth:`cancel` (never blocks)."""
        return isinstance(self._exc, SortCancelledError)

    # internal — called by the dispatcher exactly once
    def _resolve(self, result) -> None:
        self._result = result
        self._done = True

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._done = True

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "done" if self._done else "pending"
        return f"SortFuture(rid={self.rid}, {state})"


@dataclasses.dataclass
class _Queued:
    """One formed batch waiting for a launch slot."""

    batch: Batch
    futures: Dict[int, SortFuture]
    failsink: bool  # this batch is a failsink re-dispatch
    attempt: int = 0  # failsink lineage generation (0 = fresh traffic)
    not_before: float = 0.0  # perf_counter backoff gate (0 = launchable)
    degraded: bool = False  # circuit-breaker per-request exact dispatch
    solo_retry: bool = False  # this IS the rid's one solo retry
    tid: Optional[str] = None  # trace timeline lane (traced runs only)
    t_enqueued: float = 0.0  # tracer clock at enqueue (traced runs only)


@dataclasses.dataclass
class _Flight:
    """One launched batch: device work in the queue, not yet awaited."""

    batch: Batch
    futures: Dict[int, SortFuture]
    failsink: bool
    decision: object  # planner PlanDecision (None when tier pinned)
    start_tier: str
    stats: TierStats  # isolated per batch; merged into the shared stats
    inflight: InFlightSegmentedSort
    attempt: int = 0  # failsink lineage generation
    degraded: bool = False
    solo_retry: bool = False
    t_wall: float = 0.0  # perf_counter at launch (straggler timing)
    tid: Optional[str] = None  # trace timeline lane (traced runs only)
    t_launched: float = 0.0  # tracer clock at launch end (traced runs only)


class Dispatcher:
    """Formed-batch queue + up to ``max_in_flight`` launched batches.

    Owns the batch-level dispatch pipeline (plan → pack → launch → await →
    resolve futures) and its telemetry; :class:`repro_torch.service.SortService`
    is a thin facade that forms batches into :meth:`enqueue` and claims
    results through the futures. Two completion callbacks connect the
    layers: ``on_result(future, keys, order, tier, n_per_proc)`` delivers
    one finished request, ``on_failure(future, exc)`` one terminal failure.
    ``device`` is where every launch, and every stream's view, runs.
    """

    def __init__(
        self,
        cfg,
        *,
        former: BatchFormer,
        executor: SortExecutor,
        planner: CapacityPlanner,
        stats: TierStats,
        on_result: Callable,
        on_failure: Callable,
        max_in_flight: int = 2,
        straggler_monitor=None,
        device=None,
    ) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.former = former
        self.executor = executor
        self.planner = planner
        self.stats = stats
        self.on_result = on_result
        self.on_failure = on_failure
        self.max_in_flight = max(1, int(max_in_flight))
        self._queue: Deque[_Queued] = collections.deque()
        self._flights: Deque[_Flight] = collections.deque()
        # failure-hardening knobs (ServiceConfig; getattr so a bare config
        # object without them keeps the legacy immediate-retry behaviour)
        self.backoff_base_s = float(getattr(cfg, "failsink_backoff_s", 0.0))
        self.backoff_max_s = float(
            getattr(cfg, "failsink_backoff_max_s", 1.0)
        )
        self.retry_budget = int(getattr(cfg, "fault_retry_budget", 8))
        self.breaker_threshold = int(getattr(cfg, "breaker_threshold", 4))
        self.breaker_cooldown_s = float(
            getattr(cfg, "breaker_cooldown_s", 30.0)
        )
        # circuit breaker: consecutive failures / open instant per bucket
        self._breaker_fails: Dict[int, int] = {}
        self._breaker_open_at: Dict[int, float] = {}
        # straggler wiring: flight wall times feed the EWMA monitor; slow
        # flights count in svc.straggler_flights (train/elastic's monitor
        # finally has a production call site)
        if straggler_monitor is None:
            from ..train.elastic import StragglerMonitor

            straggler_monitor = StragglerMonitor()
        self.stragglers = straggler_monitor
        # chaos injection plan (repro_torch.chaos.FaultPlan; hash-excluded on the
        # config like obs — None in production)
        self._chaos = resolve_chaos(getattr(cfg, "chaos", None))
        # telemetry — counters live in the process-wide metrics registry
        # under this dispatcher's instance label; the legacy attribute names
        # (launches, in_flight_peak, bucket_counts, ...) are read-only
        # property views over the same counters
        self.label = obs.next_instance("svc")
        reg = obs.metrics()
        self._launches = reg.counter("dispatch.launches", svc=self.label)
        self._overlapped = reg.counter(
            "dispatch.overlapped_launches", svc=self.label
        )
        self._in_flight_peak = reg.gauge("dispatch.in_flight_peak", svc=self.label)
        self._batches = reg.counter("dispatch.batches", svc=self.label)
        self._keys_sorted = reg.counter("dispatch.keys_sorted", svc=self.label)
        self._failsink_splits = reg.counter(
            "dispatch.failsink_splits", svc=self.label
        )
        self._failsink_solo_retries = reg.counter(
            "dispatch.failsink_solo_retries", svc=self.label
        )
        self._failsink_errors = reg.counter(
            "dispatch.failsink_errors", svc=self.label
        )
        self._failsink_resolved = reg.counter(
            "dispatch.failsink_resolved", svc=self.label
        )
        self._recovered_batches = reg.counter(
            "dispatch.recovered_batches", svc=self.label
        )
        self._straggler_flights = reg.counter(
            "svc.straggler_flights", svc=self.label
        )
        self._breaker_opened = reg.counter(
            "dispatch.breaker_opened", svc=self.label
        )
        self._breaker_degraded = reg.counter(
            "dispatch.breaker_degraded_batches", svc=self.label
        )
        self._budget_exceeded = reg.counter(
            "dispatch.retry_budget_exceeded", svc=self.label
        )
        self._cancelled = reg.counter("dispatch.cancelled_rids", svc=self.label)
        self._timeouts = reg.counter(
            "dispatch.deadline_timeouts", svc=self.label
        )
        # queue→form→launch→flight timeline (ServiceConfig.obs; off by
        # default — every tracer touch below is guarded)
        self._tracer = obs.resolve_tracer(getattr(cfg, "obs", None))
        # per-key-space standing views: repeat submits against the same
        # logical stream fold into the stream's SortedView instead of
        # resorting its whole history (see fold_stream)
        self._stream_views: Dict[object, SortedView] = {}
        self._stream_offsets: Dict[object, int] = {}

    # ----------------------------------------------- legacy telemetry views
    @property
    def launches(self) -> int:
        return self._launches.value

    @property
    def overlapped_launches(self) -> int:
        """Launches performed while another batch's device work flew."""
        return self._overlapped.value

    @property
    def in_flight_peak(self) -> int:
        return self._in_flight_peak.value

    @property
    def batches_dispatched(self) -> int:
        return self._batches.value

    @property
    def keys_sorted(self) -> int:
        return self._keys_sorted.value

    @property
    def bucket_counts(self) -> Dict[int, int]:
        """n_per_proc -> completed batches (view over the registry)."""
        return {
            int(lbl["bucket"]): c.value
            for lbl, c in obs.metrics().collect(
                "dispatch.batches_by_bucket", svc=self.label
            )
        }

    @property
    def start_tiers(self) -> Dict[str, int]:
        """starting tier -> completed batches (view over the registry)."""
        return {
            str(lbl["tier"]): c.value
            for lbl, c in obs.metrics().collect(
                "dispatch.start_tier", svc=self.label
            )
        }

    @property
    def failsink_splits(self) -> int:
        """Batch bisections after a failure."""
        return self._failsink_splits.value

    @property
    def failsink_solo_retries(self) -> int:
        """Solo re-dispatches of a failed rid."""
        return self._failsink_solo_retries.value

    @property
    def failsink_errors(self) -> int:
        """Rids terminally failed past failsink."""
        return self._failsink_errors.value

    @property
    def failsink_resolved(self) -> int:
        """Rids completing on a failsink re-dispatch."""
        return self._failsink_resolved.value

    @property
    def recovered_batches(self) -> int:
        """Batches that completed on a failsink re-dispatch."""
        return self._recovered_batches.value

    @property
    def straggler_flights(self) -> int:
        """Flights the EWMA straggler monitor marked slow."""
        return self._straggler_flights.value

    @property
    def breaker_opened(self) -> int:
        """Circuit-breaker open events (bucket degraded to per-request)."""
        return self._breaker_opened.value

    @property
    def cancelled_rids(self) -> int:
        """Requests unpicked from a formed batch before launch."""
        return self._cancelled.value

    @property
    def deadline_timeouts(self) -> int:
        """Formed-but-unlaunched requests expired past their deadline."""
        return self._timeouts.value

    # ------------------------------------------------------------- queue
    @property
    def idle(self) -> bool:
        return not self._queue and not self._flights

    @property
    def in_flight(self) -> int:
        return len(self._flights)

    def _breaker_is_open(self, bucket: int) -> bool:
        """Open-circuit check with time-based half-open: past the cooldown
        the bucket readmits fused batches (a clean completion then resets
        the failure streak; another failure re-opens)."""
        t = self._breaker_open_at.get(bucket)
        if t is None:
            return False
        if time.perf_counter() - t >= self.breaker_cooldown_s:
            del self._breaker_open_at[bucket]
            self._breaker_fails[bucket] = 0
            return False
        return True

    def _make_queued(
        self,
        batch: Batch,
        futures: Dict[int, SortFuture],
        *,
        failsink: bool = False,
        attempt: int = 0,
        not_before: float = 0.0,
        degraded: bool = False,
        solo_retry: bool = False,
    ) -> _Queued:
        tr = self._tracer
        return _Queued(
            batch=batch,
            futures=futures,
            failsink=failsink,
            attempt=attempt,
            not_before=not_before,
            degraded=degraded,
            solo_retry=solo_retry,
            tid=tr.next_tid("batch") if tr is not None else None,
            t_enqueued=tr.now() if tr is not None else 0.0,
        )

    def enqueue(
        self,
        batch: Batch,
        futures: Dict[int, SortFuture],
        *,
        failsink: bool = False,
        front: bool = False,
    ) -> None:
        if (
            not failsink
            and len(batch.rids) > 1
            and self._breaker_is_open(batch.n_per_proc)
        ):
            # degraded mode: the bucket's fused launches keep failing, so
            # stop fusing — every request dispatches solo at the exact
            # capacity (the never-fails tier) until the breaker cools down
            self._breaker_degraded.inc()
            if self._tracer is not None:
                self._tracer.point(
                    "breaker_degrade",
                    cat="dispatch",
                    tid="main",
                    bucket=batch.n_per_proc,
                    n_rids=len(batch.rids),
                )
            for rid, arr in zip(batch.rids, batch.arrays):
                for solo in self.former.form([(rid, arr)]):
                    self._queue.append(
                        self._make_queued(
                            solo, {rid: futures[rid]}, degraded=True
                        )
                    )
            return
        item = self._make_queued(batch, futures, failsink=failsink)
        if front:
            self._queue.appendleft(item)
        else:
            self._queue.append(item)

    def unpick(self, rid: int) -> bool:
        """Remove one rid from a *queued* (not launched) batch.

        The batch re-forms without it — remaining rids keep their place in
        the queue (their pow2 bucket may shrink). Returns False when the
        rid is not in the queue (pending at the service, launched, done).
        """
        for idx, item in enumerate(self._queue):
            if rid not in item.futures:
                continue
            del self._queue[idx]
            rest = [
                (r, a)
                for r, a in zip(item.batch.rids, item.batch.arrays)
                if r != rid
            ]
            repl = [
                dataclasses.replace(
                    item,
                    batch=b,
                    futures={r: item.futures[r] for r in b.rids},
                )
                for b in self.former.form(rest)
            ]
            for b in reversed(repl):
                self._queue.insert(idx, b)
            return True
        return False

    def cancel_rid(self, rid: int) -> bool:
        """Cancellation entry: :meth:`unpick` plus the cancelled counter."""
        if self.unpick(rid):
            self._cancelled.inc()
            return True
        return False

    def expire_deadlines(self, now: Optional[float] = None) -> int:
        """Fail formed-but-unlaunched requests whose deadline passed.

        Each victim is unpicked from its queued batch (the batch re-forms)
        and its future resolves with a :class:`SortTimeoutError` naming
        the rid. Launched requests are never expired — their device work
        is already paid for, and completing is strictly better.
        """
        now = time.perf_counter() if now is None else now
        victims = [
            fut
            for q in self._queue
            for fut in q.futures.values()
            if fut.deadline_at is not None
            and now >= fut.deadline_at
            and not fut.done()
        ]
        n = 0
        for fut in victims:
            if not self.unpick(fut.rid):
                continue
            self._timeouts.inc()
            self.on_failure(
                fut,
                SortTimeoutError(
                    f"request rid={fut.rid} expired un-launched "
                    f"(deadline passed before its batch got a slot)",
                    rids=(fut.rid,),
                ),
            )
            n += 1
        return n

    # ---------------------------------------------------------- dispatch
    def _resolve_batch(self, batch: Batch, degraded: bool = False):
        """(packed, sort overrides, decision) for one formed batch."""
        if degraded:
            # circuit-breaker fallback: per-request exact sort — no planner
            # (nothing fused to learn from), no sub-exact rung to fault
            packed = pack_segments(
                batch.arrays,
                self.cfg.p,
                n_per_proc=batch.n_per_proc,
                min_n_per_proc=self.cfg.min_n_per_proc,
            )
            return packed, {"pair_capacity": "exact"}, None
        if self.cfg.pair_capacity != "auto":  # explicit pin: every batch starts there
            packed = pack_segments(
                batch.arrays,
                self.cfg.p,
                n_per_proc=batch.n_per_proc,
                min_n_per_proc=self.cfg.min_n_per_proc,
            )
            return packed, {"pair_capacity": self.cfg.pair_capacity}, None
        decision = self.planner.plan(
            batch.arrays,
            self.cfg.p,
            n_per_proc=batch.n_per_proc,
            min_n_per_proc=self.cfg.min_n_per_proc,
        )
        packed = pack_segments(
            batch.arrays,
            self.cfg.p,
            n_per_proc=batch.n_per_proc,
            min_n_per_proc=self.cfg.min_n_per_proc,
            layout=decision.layout,
        )
        if decision.route == "delta" and len(batch.arrays) == 1:
            # near-sorted solo batch: no packing — the delta launch splits
            # the stream on host and routes only the out-of-place Δ through
            # the h-relation (repro_torch.delta). pump() branches on packed=None.
            return None, {"route": "delta"}, decision
        return packed, plan_overrides(decision), decision

    def _next_launchable(self, now: float) -> Optional[int]:
        """Queue index of the first launch-eligible batch, scanning *past*
        backing-off failsink retries — innocents never starve behind them."""
        for idx, item in enumerate(self._queue):
            if item.not_before <= now:
                return idx
        return None

    def pump(self) -> None:
        """Launch queued batches into free in-flight slots (non-blocking).

        The host-side plan/pack/launch of a later batch runs while earlier
        flights' collectives execute on the device — this loop is the
        overlap the async restructure exists for. Backoff-gated failsink
        retries are skipped (not waited on) until their ``not_before``
        instant passes.
        """
        tr = self._tracer
        while self._queue and len(self._flights) < self.max_in_flight:
            idx = self._next_launchable(time.perf_counter())
            if idx is None:
                return  # everything queued is backing off
            item = self._queue[idx]
            del self._queue[idx]
            if tr is not None:
                tr.add_span(
                    "queue",
                    item.t_enqueued,
                    cat="dispatch",
                    tid=item.tid,
                    n_rids=len(item.batch.rids),
                    failsink=item.failsink,
                )
            t_form = tr.now() if tr is not None else 0.0
            try:
                if self._chaos is not None:
                    # injected launch faults (poison rids / transient
                    # errors) raise ChaosError here — recovered by the
                    # same failsink path as organic launch failures
                    self._chaos.check_launch(
                        self._chaos.next_batch(), item.batch.rids
                    )
                packed, overrides, decision = self._resolve_batch(
                    item.batch, degraded=item.degraded
                )
                if tr is not None:
                    if packed is not None:
                        tr.add_span(
                            "form",
                            t_form,
                            cat="dispatch",
                            tid=item.tid,
                            n_per_proc=packed.n_per_proc,
                            layout=packed.layout,
                            n_keys=packed.n_keys,
                        )
                    # the fused sort traces onto the same Tracer (its own
                    # sortN lane; the launch span below links the two)
                    overrides["obs"] = self.cfg.obs
                if self._chaos is not None and packed is not None:
                    # capacity-fault injection rides the sort config the
                    # same hash-excluded way as obs (core.api strips it
                    # before any executor key)
                    overrides["chaos"] = self._chaos
                batch_stats = TierStats()  # isolates this batch's outcome
                t_launch = tr.now() if tr is not None else 0.0
                if packed is None:  # route="delta": near-sorted solo batch
                    inflight = near_sorted_sort_launch(
                        item.batch.arrays[0],
                        self.cfg.p,
                        min_n_per_proc=self.cfg.min_n_per_proc,
                        executor=self.executor,
                        stats=batch_stats,
                        obs_handle=overrides.get("obs"),
                        device=self.device,
                    )
                else:
                    inflight = segmented_sort_launch(
                        packed,
                        algorithm=self.cfg.algorithm,
                        local_sort=self.cfg.local_sort,
                        merge=self.cfg.merge,
                        seed=self.cfg.seed,
                        stats=batch_stats,
                        executor=self.executor,
                        device=self.device,
                        **overrides,
                    )
            except Exception as exc:  # launch-time failure: same failsink
                self._handle_failure(item, exc)
                continue
            start_tier = (
                overrides["route"]
                if overrides.get("route") in ("radix", "delta")
                else overrides["pair_capacity"]
            )
            if tr is not None:
                tr.add_span(
                    "launch",
                    t_launch,
                    cat="dispatch",
                    tid=item.tid,
                    start_tier=start_tier,
                    sort_tid=getattr(
                        getattr(inflight, "flight", None), "trace_tid", None
                    ),
                )
            self._launches.inc()
            if len(self._flights) >= 1:
                self._overlapped.inc()
            self._flights.append(
                _Flight(
                    batch=item.batch,
                    futures=item.futures,
                    failsink=item.failsink,
                    decision=decision,
                    start_tier=start_tier,
                    stats=batch_stats,
                    inflight=inflight,
                    attempt=item.attempt,
                    degraded=item.degraded,
                    solo_retry=item.solo_retry,
                    t_wall=time.perf_counter(),
                    tid=item.tid,
                    t_launched=tr.now() if tr is not None else 0.0,
                )
            )
            self._in_flight_peak.set_max(len(self._flights))

    def step(self) -> bool:
        """Complete the oldest in-flight batch (blocking), refill the slots.

        Returns False when there was nothing to do. Completion order is
        launch order — FIFO, like the synchronous flush — so shared-stats
        accumulation and planner feedback see batches in the same order as
        before the async restructure. When everything queued is backing
        off and nothing flies, the step honours the earliest ``not_before``
        (sleeps up to it) instead of spinning — ``drain``/``drive`` make
        progress through backoff windows.
        """
        self.pump()
        if not self._flights and self._queue:
            delay = min(q.not_before for q in self._queue) - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            self.pump()
        if not self._flights:
            return False
        flight = self._flights.popleft()
        if self._chaos is not None:
            # injected straggler: host-side delay before the flight sync —
            # the flight wall below inflates, feeding the EWMA monitor
            delay = self._chaos.straggle_delay(self._chaos.next_flight())
            if delay > 0:
                if self._tracer is not None:
                    self._tracer.point(
                        "chaos_straggle",
                        cat="chaos",
                        tid=flight.tid or "main",
                        delay_s=delay,
                    )
                time.sleep(delay)
        try:
            # one host copy of the flight's flat keys and positions
            seg = flight.inflight.wait(host=True)
        except Exception as exc:
            self._handle_failure(flight, exc)
            self.pump()
            return True
        wall = time.perf_counter() - flight.t_wall
        if self.stragglers.is_slow(wall):
            self._straggler_flights.inc()
        self.stragglers.record(wall)
        if self._tracer is not None:
            self._tracer.add_span(
                "flight",
                flight.t_launched,
                cat="dispatch",
                tid=flight.tid,
                start_tier=flight.start_tier,
                tier=seg.tier,
                n_rids=len(flight.batch.rids),
                retries=flight.stats.retries,
            )
        self._complete(flight, seg)
        self.pump()
        return True

    def drain(self) -> None:
        """Run the pipeline dry: every queued batch launched and awaited."""
        while self.step():
            pass

    def drive(self, fut: SortFuture) -> None:
        """Advance the pipeline until ``fut`` resolves (or the queue dries)."""
        while not fut.done() and not self.idle:
            self.step()

    def run_pending(self, *, max_steps: int = 0) -> bool:
        """Driver pump for a thread/event loop: advance without a caller.

        Expires overdue deadlines, launches backoff-due and queued batches
        into free slots (non-blocking), then completes up to ``max_steps``
        flights (each completion blocks on that flight's device work — a
        driver thread passes 1, a latency-sensitive event loop 0 and lets
        claimants block instead). Returns whether work remains.
        """
        self.expire_deadlines()
        self.pump()
        for _ in range(max(0, int(max_steps))):
            if not self._flights:
                break
            self.step()
        return not self.idle

    # -------------------------------------------------------- completion
    def _complete(self, flight: _Flight, seg) -> None:
        self.stats.merge_from(flight.stats)
        if flight.decision is not None:
            # planner feedback as a completion callback: did the starting
            # tier overflow? (Persistence stays deferred to the service's
            # flush boundary — save_if_dirty there.)
            self.planner.record(flight.decision, faulted=flight.stats.retries > 0)
        obs.metrics().counter(
            "dispatch.start_tier", svc=self.label, tier=flight.start_tier
        ).inc()
        self._batches.inc()
        self._keys_sorted.inc(flight.batch.total_keys)
        obs.metrics().counter(
            "dispatch.batches_by_bucket",
            svc=self.label,
            bucket=flight.batch.n_per_proc,
        ).inc()
        # clean completion closes the bucket's breaker failure streak
        self._breaker_fails[flight.batch.n_per_proc] = 0
        if flight.failsink:
            self._failsink_resolved.inc(len(flight.batch.rids))
            self._recovered_batches.inc()
        for rid, keys, order in zip(flight.batch.rids, seg.keys, seg.order):
            fut = flight.futures[rid]
            fut.failsink = fut.failsink or flight.failsink
            self.on_result(fut, keys, order, seg.tier, seg.n_per_proc)

    def _backoff_for(self, attempt: int) -> float:
        """Exponential backoff for failsink generation ``attempt`` (the
        requeued batches' generation, i.e. parent attempt + 1)."""
        if self.backoff_base_s <= 0:
            return 0.0
        return min(
            self.backoff_max_s,
            self.backoff_base_s * (2.0 ** max(0, attempt - 1)),
        )

    def _handle_failure(self, item, exc: Exception) -> None:
        """Failsink: bisect a failed batch instead of failing everyone.

        Halves are re-formed through the batch former (their pow2 bucket
        shrinks with the batch) and re-enqueued at the queue *head* with
        the lineage's exponential backoff gate, so the isolation converges
        before new traffic is admitted but never blocks it (the pump scans
        past backing-off entries). Every rid gets exactly one solo retry
        (``solo_retry`` marks the retry dispatch); a failed solo retry is
        terminal — its future carries a :class:`SortServiceError` naming
        the rid, chained to the backend error. A lineage past
        ``fault_retry_budget`` generations stops bisecting and explodes to
        per-rid solo dispatches. Consecutive failures per bucket feed the
        circuit breaker.
        """
        rids, arrays = item.batch.rids, item.batch.arrays
        tr = self._tracer
        if tr is not None and isinstance(exc, ChaosError):
            tr.point(
                "chaos_launch_fault",
                cat="chaos",
                tid=getattr(item, "tid", None) or "main",
                rids=list(rids),
                error=str(exc),
            )
        # circuit breaker: consecutive failures in this pow2 bucket
        bucket = item.batch.n_per_proc
        fails = self._breaker_fails.get(bucket, 0) + 1
        self._breaker_fails[bucket] = fails
        if (
            self.breaker_threshold > 0
            and fails >= self.breaker_threshold
            and bucket not in self._breaker_open_at
        ):
            self._breaker_open_at[bucket] = time.perf_counter()
            self._breaker_opened.inc()
            if tr is not None:
                tr.point(
                    "breaker_open",
                    cat="dispatch",
                    tid="main",
                    bucket=bucket,
                    fails=fails,
                )
        solo_retry = False
        if len(rids) == 1 and getattr(item, "solo_retry", False):
            # the rid's one solo retry also failed: terminal. (Every rid
            # gets exactly one solo retry before this — whether it arrived
            # solo as fresh traffic or was isolated by bisection — so a
            # one-shot transient fault landing on the isolation dispatch
            # can never kill an innocent.)
            rid = rids[0]
            fut = item.futures[rid]
            fut.failsink = True
            err = SortServiceError(
                f"request rid={rid} failed solo after failsink isolation: "
                f"{exc!r}",
                rids=(rid,),
            )
            err.__cause__ = exc
            self._failsink_errors.inc()
            self.on_failure(fut, err)
            return
        if len(rids) == 1:
            self._failsink_solo_retries.inc()
            solo_retry = True
            halves = [list(zip(rids, arrays))]
        elif item.attempt >= self.retry_budget:
            # retry budget exhausted: skip the remaining bisection levels
            # and isolate every rid at once — bounded work, innocents still
            # complete (solo dispatches take the exact/allgather path)
            self._budget_exceeded.inc()
            halves = [[(r, a)] for r, a in zip(rids, arrays)]
        else:
            self._failsink_splits.inc()
            mid = len(rids) // 2
            halves = [
                list(zip(rids[:mid], arrays[:mid])),
                list(zip(rids[mid:], arrays[mid:])),
            ]
        attempt = item.attempt + 1
        not_before = time.perf_counter() + self._backoff_for(attempt)
        requeue: List[_Queued] = []
        for half in halves:
            for batch in self.former.form(half):
                requeue.append(
                    self._make_queued(
                        batch,
                        {r: item.futures[r] for r in batch.rids},
                        failsink=True,
                        attempt=attempt,
                        not_before=not_before,
                        solo_retry=solo_retry,
                    )
                )
        self._queue.extendleft(reversed(requeue))  # keep half order at head

    # ----------------------------------------------------- stream folding
    def fold_stream(self, stream, keys) -> Tuple[np.ndarray, np.ndarray, str, int]:
        """Fold one submit's keys into ``stream``'s standing sorted view.

        The first submit against a stream installs its view (a resort —
        there is nothing to rank against); every later submit folds: the
        Δ batch runs the h-relation at a Δ-sized rung and rank-merges in
        (``repro_torch.delta.SortedView``). The view carries one payload — the
        arrival index across the whole stream — so the returned ``order``
        is the stable argsort of the *concatenated stream history*, exactly
        what a cold sort of everything submitted so far would produce.
        Returns ``(keys, order, tier, n_per_proc)`` for the full view, the
        arrays as host numpy copies of the view's tensors.
        """
        v = self._stream_views.get(stream)
        if v is None:
            v = self._stream_views[stream] = SortedView(
                p=self.cfg.p,
                min_n_per_proc=self.cfg.min_n_per_proc,
                executor=self.executor,
                stats=self.stats,
                obs_handle=getattr(self.cfg, "obs", None),
                chaos_handle=getattr(self.cfg, "chaos", None),
                device=self.device,
            )
        base = self._stream_offsets.get(stream, 0)
        arr = np.asarray(keys, np.int32).reshape(-1)
        pos = np.arange(base, base + arr.size, dtype=np.int64)
        v.fold(arr, (pos,))
        self._stream_offsets[stream] = base + arr.size
        return (
            v.keys.cpu().numpy(),
            v.payloads[0].cpu().numpy(),
            v.last_tier or "delta",
            v.last_n_per_proc,
        )

    def telemetry(self) -> Dict[str, int]:
        return {
            "max_in_flight": self.max_in_flight,
            "in_flight_peak": self.in_flight_peak,
            "overlapped_launches": self.overlapped_launches,
            "failsink_splits": self.failsink_splits,
            "failsink_solo_retries": self.failsink_solo_retries,
            "failsink_resolved": self.failsink_resolved,
            "failsink_errors": self.failsink_errors,
            "recovered_batches": self.recovered_batches,
            "straggler_flights": self.straggler_flights,
            "breaker_opened": self.breaker_opened,
            "breaker_degraded_batches": self._breaker_degraded.value,
            "retry_budget_exceeded": self._budget_exceeded.value,
            "cancelled_rids": self.cancelled_rids,
            "deadline_timeouts": self.deadline_timeouts,
            "stream_views": len(self._stream_views),
        }
