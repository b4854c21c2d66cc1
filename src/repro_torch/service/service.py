"""SortService — async request queue + fused dispatch over the segmented sort.

The JAX package's ``repro.service.service``, ported. ``ServiceConfig``
keeps the reference's fields and defaults letter for letter; the device
is a constructor keyword, ``SortService(cfg, device=...)``, the card
unless the caller names another (without a card and without a device it
raises). Results are host numpy arrays, as in the JAX package.

Consumers (serve admission ordering, data-pipeline length bucketing, MoE-ish
"sort these ids by key" callers) each used to run one whole BSP sort per
array: a small request wastes the p-lane mesh, and every distinct length
builds a new set of executor entries (a recompile in the JAX package).
The service turns that regime into a first-class
workload — and, since the async restructure, into a *pipelined* one:

* ``submit(keys)`` queues a ragged int32 request and returns a
  :class:`repro_torch.service.dispatch.SortFuture` **immediately** — nothing is
  dispatched at submit time. ``future.result()`` is the only blocking
  point; it drives the dispatcher until the request's batch completes;
* batches are formed pow2-bucketed (:class:`repro_torch.service.batch.BatchFormer`)
  and handed to the :class:`repro_torch.service.dispatch.Dispatcher`, which keeps
  up to ``max_in_flight`` of them launched at once: the host-side
  fingerprint → plan → pack → launch of batch k+1 overlaps batch k's device
  collectives via CUDA's asynchronous launches. Per-request *failsink* fault
  isolation lives there too — a failed batch is bisected until the poison
  request stands alone, so one bad request cannot wedge the queue;
* escalation is per batch through ``bsp_sort_safe``'s capacity-tier
  ladder. The starting tier is resolved per batch (``pair_capacity="auto"``)
  by the **capacity planner** (:class:`repro_torch.planner.CapacityPlanner`),
  whose fault feedback now arrives as a *completion callback* when a
  flight lands, not inline on the dispatch path. An explicit
  ``pair_capacity="whp"``/``"exact"`` still pins every batch;
* the blocking API is a compatibility wrapper over futures, byte-identical
  to the synchronous path: ``flush()`` drains the pipeline and returns
  every *unclaimed* result, ``sort_one``/``sort_many`` are
  submit + ``future.result()``. Completed results stay in a **bounded**
  unclaimed store until claimed (``take_result`` / ``sort_one`` /
  ``sort_many``): past ``max_unclaimed`` the oldest entries are evicted
  (``evicted_results`` telemetry) — but a result is cached on its future
  at resolution, so the caller that actually holds the future never loses
  it. Auto-flush triggers (``max_pending`` size / ``flush_after_s``
  deadline) are now non-blocking: they form + launch, and let the caller
  block at claim time;
* telemetry: per-request wall latency (submit → result) with
  memoized percentiles (recomputed only when new completions landed, so
  soak-loop polling doesn't scale with window size), the accumulated
  :class:`TierStats`, dispatcher counters (in-flight peak, overlapped
  launches, failsink outcomes), per-bucket batch counts, auto-flush
  trigger counts, and planner plan/promotion counters.

One process-wide default executor serves all services, so every service
instance (and every other sort caller) shares stage callables per bucket.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import Deque, Dict, List, Optional, Sequence, Union

import numpy as np

from .. import obs
from ..core.api import SortExecutor, TierStats, default_executor
from ..planner import CapacityPlanner
from .batch import BatchFormer
from .dispatch import (
    Dispatcher,
    SortCancelledError,
    SortFuture,
    SortServiceError,
    SortTimeoutError,
)


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Static service knobs; the sort fields mirror SortConfig's."""

    p: int = 8  # simulated-processor lanes per fused sort
    algorithm: str = "iran"  # randomized oversampling: production default
    # First capacity tier, resolved per batch when "auto": the capacity
    # planner fingerprints the batch and picks (layout, starting tier,
    # oversampling ratio) — single-segment batches keep the raw-int32
    # contiguous hot path, multi-segment batches pack striped and start at
    # the segment-aware planned bound (repro_torch.planner). An explicit
    # "whp"/"exact" pins the starting tier for every batch.
    pair_capacity: str = "auto"
    local_sort: str = "lax"
    # Ph6 tail of the fused sort: "sort" (stable re-sort) or "tree" (the
    # payload-generic rank-merge tail — the int64 composites and their pos
    # payload ride the lg p rank merges instead of a full re-sort).
    merge: str = "sort"
    max_batch_keys: int = 1 << 16  # batch former's packing cap
    min_n_per_proc: int = 8
    seed: int = 0
    # planner history persistence (pair_capacity="auto" only); None keeps
    # the learned rungs in-process
    planner_path: Optional[str] = None
    # auto-flush triggers (both optional): form + launch from submit() once
    # this many requests are pending / once the oldest pending request is
    # older than this deadline (non-blocking — block at future.result()).
    # Caller-driven flush() stays supported.
    max_pending: Optional[int] = None
    flush_after_s: Optional[float] = None
    # dispatch pipeline depth: batches launched-but-unawaited at once; 1
    # restores strictly serial dispatch (launch, wait, launch, ...)
    max_in_flight: int = 2
    # unclaimed-result store bound: oldest-first eviction past this many
    # unclaimed results (each eviction counts in ``evicted_results``; the
    # result stays cached on its SortFuture). None disables the bound.
    max_unclaimed: Optional[int] = 1024
    # failure hardening (repro_torch.service.dispatch docstring has the model):
    # failsink re-enqueues back off failsink_backoff_s · 2^attempt (capped
    # at failsink_backoff_max_s) before relaunch eligibility; 0 restores
    # immediate retry. A failsink lineage past fault_retry_budget
    # generations stops bisecting and isolates every rid solo at once.
    failsink_backoff_s: float = 0.0
    failsink_backoff_max_s: float = 1.0
    fault_retry_budget: int = 8
    # circuit breaker: breaker_threshold consecutive failed launches in one
    # pow2 bucket degrade the bucket from fused batches to per-request
    # exact sorts for breaker_cooldown_s (0 disables the breaker)
    breaker_threshold: int = 4
    breaker_cooldown_s: float = 30.0
    # Observability handle (repro_torch.obs.Tracer or None), hash/compare-excluded
    # like SortConfig.obs: the dispatcher records its queue→form→launch→
    # flight timeline on it and threads it into every fused sort launch.
    obs: Optional[object] = dataclasses.field(
        default=None, compare=False, repr=False
    )
    # Chaos handle (repro_torch.chaos.FaultPlan or None), hash/compare-excluded
    # like ``obs``: deterministic seeded fault injection across the
    # dispatch path (launch faults, stragglers), the capacity ladder and
    # the delta views. A faulted service runs the same stage callables
    # as a clean one.
    chaos: Optional[object] = dataclasses.field(
        default=None, compare=False, repr=False
    )


@dataclasses.dataclass
class RequestResult:
    """One request's output: sorted keys + stable argsort + telemetry."""

    rid: int
    keys: np.ndarray  # sorted ascending
    order: np.ndarray  # stable argsort: input[order] == keys
    tier: Optional[str]  # capacity tier that served this request's batch
    n_per_proc: int  # pow2 bucket the batch was packed under
    latency_s: float  # submit -> result wall time
    failsink: bool = False  # completed via a failsink re-dispatch


@dataclasses.dataclass
class _Pending:
    rid: int
    keys: np.ndarray
    future: SortFuture


class SortService:
    def __init__(
        self,
        cfg: ServiceConfig = ServiceConfig(),
        *,
        executor: Optional[SortExecutor] = None,
        stats: Optional[TierStats] = None,
        planner: Optional[CapacityPlanner] = None,
        device=None,
    ) -> None:
        # reject unsupported pins up front: "planned" needs a per-batch
        # bound only the planner can supply — a pinned service would fail
        # every batch into the failsink and error every future
        if cfg.pair_capacity not in ("auto", "whp", "exact"):
            raise ValueError(
                f"unsupported service pair_capacity {cfg.pair_capacity!r}: "
                "use 'auto' (planner-resolved) or pin 'whp'/'exact'"
            )
        self.cfg = cfg
        self.executor = executor if executor is not None else default_executor()
        self.stats = stats if stats is not None else TierStats()
        # the capacity planner resolves "auto" starting tiers; a shared
        # instance lets several services pool their traffic history
        self.planner = (
            planner
            if planner is not None
            else CapacityPlanner(path=cfg.planner_path)
        )
        self.former = BatchFormer(
            cfg.p, cfg.max_batch_keys, cfg.min_n_per_proc
        )
        self.dispatcher = Dispatcher(
            cfg,
            former=self.former,
            executor=self.executor,
            planner=self.planner,
            stats=self.stats,
            on_result=self._deliver,
            on_failure=self._deliver_failure,
            max_in_flight=cfg.max_in_flight,
            device=device,
        )
        self.device = self.dispatcher.device
        self._pending: List[_Pending] = []
        self._completed: Dict[int, RequestResult] = {}  # unclaimed results
        self._next_rid = 0
        # submit/flush/drive share queue state; the RLock makes them safe
        # to call from a background driver thread (start_driver) alongside
        # the submitting thread. Reentrant: _drive flushes under the lock.
        self._lock = threading.RLock()
        self._driver: Optional[threading.Thread] = None
        self._driver_stop = threading.Event()
        # telemetry — lives in the process-wide metrics registry under the
        # dispatcher's instance label (one label per service). The latency
        # histogram keeps a bounded window (a long-lived serving process
        # must not grow one float per request forever) with the lifetime
        # request count as its own counter; the legacy attribute names
        # (latencies, requests_done, ...) are read-only property views.
        self.label = self.dispatcher.label
        reg = obs.metrics()
        self._lat = reg.histogram("service.request_latency_s", svc=self.label)
        self._requests_done = reg.counter("service.requests_done", svc=self.label)
        self._requests_failed = reg.counter(
            "service.requests_failed", svc=self.label
        )
        self._evicted = reg.counter("service.evicted_results", svc=self.label)
        self._cancelled = reg.counter(
            "service.cancelled_requests", svc=self.label
        )
        self._deadline_timeouts = reg.counter(
            "service.deadline_timeouts", svc=self.label
        )

    # ----------------------------------------------- registry metric views
    @property
    def latencies(self) -> Deque[float]:
        """The latency histogram's bounded recent-value window (seconds)."""
        return self._lat.values

    @property
    def requests_done(self) -> int:
        return self._requests_done.value

    @property
    def requests_failed(self) -> int:
        return self._requests_failed.value

    @property
    def evicted_results(self) -> int:
        return self._evicted.value

    @property
    def flush_triggers(self) -> Dict[str, int]:
        """trigger (manual/size/deadline/ready/claim) -> flush count."""
        return {
            str(lbl["trigger"]): c.value
            for lbl, c in obs.metrics().collect(
                "service.flush_triggers", svc=self.label
            )
        }

    def _count_flush(self, trigger: str) -> None:
        obs.metrics().counter(
            "service.flush_triggers", svc=self.label, trigger=trigger
        ).inc()

    # -------------------------------------------- dispatcher delegation
    # batch-level counters live on the dispatcher (completion is its job
    # now); these read-only views keep the older telemetry surface
    @property
    def batches_dispatched(self) -> int:
        return self.dispatcher.batches_dispatched

    @property
    def keys_sorted(self) -> int:
        return self.dispatcher.keys_sorted

    @property
    def bucket_counts(self) -> Dict[int, int]:
        return self.dispatcher.bucket_counts

    @property
    def start_tiers(self) -> Dict[str, int]:
        return self.dispatcher.start_tiers

    # ------------------------------------------------------------- queue
    def submit(
        self,
        keys: np.ndarray,
        *,
        stream: Optional[object] = None,
        deadline_s: Optional[float] = None,
    ) -> SortFuture:
        """Queue one ragged request (1-D int32 keys); returns a future.

        The future resolves at ``result()`` time (driving the dispatcher as
        needed) — nothing is dispatched before an auto-flush trigger, a
        ``flush``/``flush_async``, or a claim forces it. Auto-flush
        triggers launch batches without blocking; the submitted request's
        result is then claimable via the returned future or
        ``take_result``.

        ``deadline_s`` bounds the *un-launched* wait: a request still
        queued (pending here, or formed in the dispatcher queue) when the
        deadline passes is expired by the deadline sweeps
        (:meth:`run_pending`, any flush entry) and its future resolves
        with a :class:`SortTimeoutError` naming the rid. Once its batch
        launches the deadline no longer applies — completing paid-for
        device work is strictly better than discarding it. The returned
        future also supports ``cancel()`` while un-launched.

        ``stream`` opts into **incremental** semantics: submits naming the
        same stream key share one standing sorted view, and each submit
        folds its keys in (Δ-sized device work — ``repro_torch.delta``) instead
        of resorting the stream's whole history. The result covers the
        *entire stream so far*: ``keys`` is the sorted concatenation of
        every batch submitted to the stream, ``order`` its stable argsort
        (int64 arrival indices). Stream folds are synchronous — each fold
        depends on the view the previous one produced — so the future
        returns already resolved.
        """
        arr = np.asarray(keys, np.int32).reshape(-1)
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            if stream is not None:
                fut = SortFuture(rid, self._drive)
                t0 = fut.submitted_at
                skeys, order, tier, n_p = self.dispatcher.fold_stream(
                    stream, arr
                )
                lat = time.perf_counter() - t0
                self._lat.observe(lat)
                self._requests_done.inc()
                res = RequestResult(
                    rid=rid, keys=skeys, order=order, tier=tier,
                    n_per_proc=n_p, latency_s=lat,
                )
                fut._resolve(res)
                self._completed[rid] = res
                return fut
            fut = SortFuture(rid, self._drive)
            if deadline_s is not None:
                fut.deadline_at = fut.submitted_at + float(deadline_s)
            fut._canceller = self._cancel
            self._pending.append(_Pending(rid, arr, fut))
            if (
                self.cfg.max_pending is not None
                and len(self._pending) >= self.cfg.max_pending
            ):
                self.flush_async(trigger="size")
            else:
                self.maybe_flush()
            return fut

    def maybe_flush(self) -> bool:
        """Deadline check: launch the queue if the oldest request is overdue.

        Called from ``submit`` and pollable from an event loop (the service
        has no thread of its own, so a deadline only fires when *somebody*
        calls in). Non-blocking: batches are formed and launched, results
        claimed later. Returns whether a flush was triggered.
        """
        if (
            self.cfg.flush_after_s is not None
            and self._pending
            and time.perf_counter() - self._pending[0].future.submitted_at
            >= self.cfg.flush_after_s
        ):
            self.flush_async(trigger="deadline")
            return True
        return False

    @property
    def pending(self) -> int:
        return len(self._pending)

    # ---------------------------------------------------------- dispatch
    def flush_async(self, trigger: str = "manual") -> bool:
        """Form every pending request into batches and start launching.

        Non-blocking: batches enter the dispatcher's queue and up to
        ``max_in_flight`` of them launch immediately (host planning/packing
        overlapping any in-flight device work). Returns whether anything
        was enqueued.
        """
        with self._lock:
            self._expire_deadlines()
            todo, self._pending = self._pending, []
            if todo:
                self._count_flush(trigger)
            fut_by_rid = {r.rid: r.future for r in todo}
            for batch in self.former.form([(r.rid, r.keys) for r in todo]):
                self.dispatcher.enqueue(
                    batch, {rid: fut_by_rid[rid] for rid in batch.rids}
                )
            self.dispatcher.pump()
            return bool(todo)

    def flush_ready(self, min_keys: Optional[int] = None) -> bool:
        """Admission-aware launch for open-loop arrival pumps.

        Dispatches only batches that are full enough
        (:meth:`BatchFormer.form_ready`); an underfilled tail batch stays
        pending for more traffic — the deadline trigger or any plain
        ``flush`` clears it, so nothing starves. Non-blocking; returns
        whether any batch launched.
        """
        with self._lock:
            self._expire_deadlines()
            todo, self._pending = self._pending, []
            fut_by_rid = {r.rid: r.future for r in todo}
            batches, held = self.former.form_ready(
                [(r.rid, r.keys) for r in todo], min_keys=min_keys
            )
            if batches:
                self._count_flush("ready")
            for batch in batches:
                self.dispatcher.enqueue(
                    batch, {rid: fut_by_rid[rid] for rid in batch.rids}
                )
            self._pending = [
                _Pending(rid, keys, fut_by_rid[rid]) for rid, keys in held
            ] + self._pending
            self.dispatcher.pump()
            return bool(batches)

    def flush(self, trigger: str = "manual") -> Dict[int, RequestResult]:
        """Sort everything queued; one fused segmented sort per batch.

        Blocking wrapper over the async pipeline: forms + launches, then
        drains every in-flight batch. Returns every unclaimed result — the
        newly completed ones plus any earlier completion not yet taken (a
        request fused into another caller's flush stays claimable).
        Claiming (``take_result`` / ``sort_one`` / ``sort_many``) removes a
        result from the store. A failed request does NOT raise here — its
        future (and ``take_result``) carries the :class:`SortServiceError`.
        """
        with self._lock:
            self.flush_async(trigger)
            try:
                self.dispatcher.drain()
            finally:
                # one history write per flush (not per batch), raise or not.
                # Persistence is telemetry, not dispatch: an unwritable path
                # must neither fail completed sorts nor mask a batch
                # exception.
                try:
                    self.planner.save_if_dirty()
                except OSError as e:
                    warnings.warn(f"planner history not persisted: {e}")
            return dict(self._completed)

    def _drive(self, fut: SortFuture) -> None:
        """SortFuture's engine: launch anything queued, run until it lands."""
        with self._lock:
            if any(r.rid == fut.rid for r in self._pending):
                self.flush_async(trigger="claim")
            self.dispatcher.drive(fut)

    # ------------------------------------- deadlines, cancellation, driver
    def _cancel(self, fut: SortFuture) -> bool:
        """``SortFuture.cancel()``'s backend: unpick an un-launched request.

        Pending requests are removed from the submit queue; formed-but-
        queued ones are unpicked from their batch in the dispatcher (the
        batch re-forms without them). A launched/resolved request reports
        False and runs to completion. On success the future resolves with
        a :class:`SortCancelledError` — the request never launches.
        """
        with self._lock:
            if fut.done():
                return False
            was_pending = any(r.rid == fut.rid for r in self._pending)
            if was_pending:
                self._pending = [r for r in self._pending if r.rid != fut.rid]
            elif not self.dispatcher.cancel_rid(fut.rid):
                return False
            self._cancelled.inc()
            fut._fail(
                SortCancelledError(
                    f"request rid={fut.rid} cancelled before launch",
                    rids=(fut.rid,),
                )
            )
            return True

    def _expire_deadlines(self, now: Optional[float] = None) -> int:
        """Fail every un-launched request whose deadline passed.

        Sweeps both queues: requests still pending here, and requests
        formed into the dispatcher's batch queue (its own sweep unpicks
        them). Launched requests are never expired.
        """
        with self._lock:
            now = time.perf_counter() if now is None else now
            expired = [
                r
                for r in self._pending
                if r.future.deadline_at is not None
                and now >= r.future.deadline_at
                and not r.future.done()
            ]
            if expired:
                dead = {r.rid for r in expired}
                self._pending = [
                    r for r in self._pending if r.rid not in dead
                ]
                for r in expired:
                    self._deliver_failure(
                        r.future,
                        SortTimeoutError(
                            f"request rid={r.rid} expired un-launched "
                            f"(deadline passed while pending)",
                            rids=(r.rid,),
                        ),
                    )
            return len(expired) + self.dispatcher.expire_deadlines(now)

    def run_pending(self, max_steps: int = 1) -> bool:
        """Driver pump: advance time-triggered work without a submitter.

        One call expires overdue deadlines (pending + formed), fires the
        ``flush_after_s`` auto-flush if the oldest pending request is
        overdue — so a quiet service still flushes without anyone
        submitting or claiming — and lets the dispatcher launch
        backoff-due batches and complete up to ``max_steps`` flights.
        Callable from a thread (:meth:`start_driver`) or polled from an
        event loop. Returns whether work remains.
        """
        with self._lock:
            self._expire_deadlines()
            self.maybe_flush()
            busy = self.dispatcher.run_pending(max_steps=max_steps)
            return busy or bool(self._pending)

    def start_driver(self, interval_s: float = 0.002) -> None:
        """Run :meth:`run_pending` on a daemon thread every ``interval_s``.

        Idempotent. With a driver running, deadline flushes, backoff
        retries and deadline expirations proceed while every caller thread
        is idle; futures resolve in the background and ``result()`` returns
        without driving.
        """
        with self._lock:
            if self._driver is not None and self._driver.is_alive():
                return
            self._driver_stop.clear()

            def _loop() -> None:
                while not self._driver_stop.wait(interval_s):
                    self.run_pending(max_steps=1)

            self._driver = threading.Thread(
                target=_loop, name=f"sort-service-driver-{self.label}",
                daemon=True,
            )
            self._driver.start()

    def stop_driver(self) -> None:
        """Stop the driver thread (waits for the current pump to finish)."""
        t = self._driver
        if t is None:
            return
        self._driver_stop.set()
        t.join(timeout=5.0)
        self._driver = None

    # -------------------------------------------------------- completion
    def _deliver(self, fut: SortFuture, keys, order, tier, n_per_proc) -> None:
        """Dispatcher completion callback: resolve the future + store."""
        lat = time.perf_counter() - fut.submitted_at
        self._lat.observe(lat)
        self._requests_done.inc()
        res = RequestResult(
            rid=fut.rid,
            keys=keys,
            order=order,
            tier=tier,
            n_per_proc=n_per_proc,
            latency_s=lat,
            failsink=fut.failsink,
        )
        fut._resolve(res)
        self._completed[fut.rid] = res
        if self.cfg.max_unclaimed is not None:
            while len(self._completed) > self.cfg.max_unclaimed:
                oldest = next(iter(self._completed))  # insertion order
                del self._completed[oldest]
                self._evicted.inc()

    def _deliver_failure(self, fut: SortFuture, exc: BaseException) -> None:
        self._requests_failed.inc()
        if isinstance(exc, SortTimeoutError):
            self._deadline_timeouts.inc()
        fut._fail(exc)

    def take_result(
        self, rid: Union[int, SortFuture]
    ) -> RequestResult:
        """Claim (remove) one completed result; drives it if still in flight.

        Accepts a rid or the :class:`SortFuture` itself. Raises the
        request's :class:`SortServiceError` if it terminally failed, and a
        ``SortServiceError`` naming the rid if no such result exists
        (never a bare ``KeyError``) — unknown, already claimed, or evicted
        without the future in hand.
        """
        if isinstance(rid, SortFuture):
            res = rid.result()  # drives; raises the failure if it failed
            self._completed.pop(rid.rid, None)
            return res
        if rid not in self._completed and (
            any(r.rid == rid for r in self._pending)
            or not self.dispatcher.idle
        ):
            self.flush()
        try:
            return self._completed.pop(rid)
        except KeyError:
            raise SortServiceError(
                f"no claimable result for rid={rid}: unknown, already "
                "claimed, failed, or evicted from the unclaimed store "
                "(hold the SortFuture to survive eviction)",
                rids=(rid,),
            ) from None

    # ------------------------------------------------------ conveniences
    def sort_many(self, arrays: Sequence[np.ndarray]) -> List[RequestResult]:
        """Submit a batch of requests and flush; results in input order.

        A request that terminally failed (failsink-isolated solo and still
        failing) raises a :class:`SortServiceError` naming every failed
        rid — nothing is claimed then, so the completed requests' results
        all remain claimable via ``take_result``.
        """
        futs = [self.submit(a) for a in arrays]
        self.flush()
        failed = [f for f in futs if f.exception() is not None]
        if failed:
            raise SortServiceError(
                f"sort_many: {len(failed)} of {len(futs)} requests failed "
                f"(rids {[f.rid for f in failed]}); completed results stay "
                "claimable via take_result",
                rids=tuple(f.rid for f in failed),
            ) from failed[0].exception()
        return [self.take_result(f) for f in futs]

    def sort_one(self, keys: np.ndarray) -> RequestResult:
        """Sort a single request through the service. It fuses with anything
        already queued — and the piggybacked requests' results stay in the
        store for their own callers (``flush``/``take_result``)."""
        fut = self.submit(keys)
        self.flush()
        return self.take_result(fut)

    def _latency_row(self) -> Dict[str, object]:
        """Latency stats from the registry histogram. The memoization the
        soak loop relies on (poll telemetry without rescanning the window
        when nothing new completed) lives in ``Histogram.summary``."""
        s = self._lat.summary()
        if not s.get("count"):
            return {}
        return {
            "lat_mean_ms": round(s["mean"] * 1e3, 3),
            "lat_p50_ms": round(s["p50"] * 1e3, 3),
            "lat_p99_ms": round(s["p99"] * 1e3, 3),
        }

    def telemetry(self) -> Dict[str, object]:
        """Flat snapshot for logs/benchmark rows; latency stats cover the
        bounded recent window, ``requests`` the service lifetime."""
        row: Dict[str, object] = {
            "requests": self.requests_done,
            "requests_failed": self.requests_failed,
            "batches": self.batches_dispatched,
            "keys_sorted": self.keys_sorted,
            "buckets": dict(sorted(self.bucket_counts.items())),
            "flush_triggers": dict(sorted(self.flush_triggers.items())),
            "start_tiers": dict(sorted(self.start_tiers.items())),
            "evicted_results": self.evicted_results,
            "cancelled_requests": self._cancelled.value,
            "deadline_timeouts": self._deadline_timeouts.value,
            "dispatch": self.dispatcher.telemetry(),
        }
        if self.cfg.pair_capacity == "auto":
            row["planner"] = self.planner.telemetry()
        row.update(self._latency_row())
        row.update(self.stats.as_row())
        return row
