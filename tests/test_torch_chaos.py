"""``repro_torch.chaos`` and the service's recovery machinery, against the JAX package.

The JAX package's ``tests/test_chaos.py``, held against ``repro.chaos``
and ``repro.service`` on the same numpy inputs: the same ``FaultPlan``
fields (converted with ``fault_plan_from_reference``) give the same draws
and the same injections; a service in each package under the same plan
gives every request the same outcome (keys and stable order byte for
byte, tier, bucket, failsink mark; a failure's class, message and rids)
and the same counters (``telemetry()`` without its clock readings), and
``plan.injected`` is equal. The port's randomized sorts draw the
reference's samples (``reference_draws``), so both walk the same rungs.
Deadlines, backoff and the breaker's cooldown read ``time.perf_counter``;
the cooldown is rewound, not slept. Tolerance: exact.
"""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.chaos import ChaosError, FaultPlan, resolve_chaos
from repro_torch.core import SortConfig, SortExecutor, bsp_sort_safe, fault_plan_from_reference, gathered_output
from repro_torch.delta import SortedView
from repro_torch.service import (
    ServiceConfig,
    SortCancelledError,
    SortService,
    SortServiceError,
    SortTimeoutError,
)
from repro_torch.train import elastic
from repro_torch.train.elastic import StragglerMonitor
from test_torch_harness import (
    assert_same_counters,
    assert_same_outcomes,
    outcome,
    patch_launch,
    ref_service,
    reference,
    reference_draws,
    request_arrays,
    service_pair,
)

P = 4
POISON_LEN = 777  # unique request length the poison wrappers key on


@pytest.fixture(scope="module")
def executors():
    """One executor per package for the module: the reference compiles per bucket."""
    return reference().SortExecutor(), SortExecutor()


@pytest.fixture(autouse=True)
def _draws(monkeypatch):
    reference_draws(monkeypatch)


def both(executors, chaos=None, **cfg):
    return service_pair(*executors, chaos=chaos, **dict(dict(p=P), **cfg))


def run_both(pair, arrays):
    """Submit ``arrays`` to both services and flush; the futures of each."""
    out = []
    for svc in pair:
        futs = [svc.submit(a) for a in arrays]
        svc.flush()
        out.append(futs)
    return out


# ------------------------------------------------------------- the plan
def test_fault_plan_draws_are_deterministic_and_order_independent():
    """The same (seed, kind, key) decides identically however many other
    draws came first, and the reference's plan decides the same."""
    r = ref_service()
    kw = dict(seed=5, capacity_fault_rate=0.5, capacity_fault_rungs=(0, 1))
    a, b, ra = FaultPlan(**kw), FaultPlan(**kw), r.chaos.FaultPlan(**kw)
    for i in range(50):
        b.straggle_delay(i)
    hits = [[(s, k) for s in range(40) for k in (0, 1) if plan.fault_capacity(s, k)] for plan in (a, b, ra)]
    assert hits[0] == hits[1] == hits[2]
    assert 0 < len(hits[0]) < 80
    assert a.injected == ra.injected == {"capacity_fault": len(hits[0])}


def test_fault_plan_budget_caps_total_injections():
    r = ref_service()
    for plan in (FaultPlan(seed=1, capacity_fault_rate=1.0, max_faults=3),
                 r.chaos.FaultPlan(seed=1, capacity_fault_rate=1.0, max_faults=3)):
        assert sum(plan.fault_capacity(s, 0) for s in range(10)) == 3
        assert plan.injected_total == 3


def test_transient_faults_fire_each_rid_set_at_most_once():
    r = ref_service()
    for plan, err in ((FaultPlan(seed=2, transient_error_rate=1.0), ChaosError),
                      (r.chaos.FaultPlan(seed=2, transient_error_rate=1.0), r.chaos.ChaosError)):
        with pytest.raises(err, match=r"rids \[1, 2, 3\]"):
            plan.check_launch(0, (1, 2, 3))
        plan.check_launch(1, (1, 2, 3))  # same rid-set: recovered, no re-fault
        with pytest.raises(err):
            plan.check_launch(2, (1, 2))


def test_fault_plan_from_reference_injects_the_reference_schedule():
    """A converted plan, asked the same sequence of questions as the
    reference's, answers alike: capacity, launch, straggle and fold
    decisions, sequence numbers, messages and injection counts."""
    r = ref_service()
    rplan = r.chaos.FaultPlan(seed=23, capacity_fault_rate=0.3, capacity_fault_rungs=(0, 1),
                              capacity_faults=((7, 2),), poison_rids=(4,), transient_error_rate=0.35,
                              fail_batches=(3,), straggle_rate=0.2, straggle_s=0.001, straggle_flights=(2,),
                              fold_corrupt_rate=0.25, corrupt_folds=(1,), max_faults=60)
    plan = fault_plan_from_reference(rplan)
    assert isinstance(plan, FaultPlan) and plan.seed == 23 and plan.capacity_faults == ((7, 2),)

    def answers(p):
        out = []
        for s in range(12):
            out.append(("sort", p.next_sort(), [p.fault_capacity(s, k) for k in range(3)]))
        rng = np.random.default_rng(0)
        for _ in range(20):
            seq = p.next_batch()
            rids = tuple(int(x) for x in rng.choice(8, rng.integers(1, 4), replace=False))
            try:
                p.check_launch(seq, rids)
                out.append(("launch", seq, rids, None))
            except Exception as exc:  # noqa: BLE001 — the two packages' ChaosError classes
                out.append(("launch", seq, rids, str(exc)))
        out += [("straggle", p.straggle_delay(p.next_flight())) for _ in range(10)]
        out += [("fold", p.corrupt_fold(p.next_fold())) for _ in range(10)]
        return out, p.injected, p.injected_total

    assert answers(plan) == answers(rplan)


def test_resolve_chaos_duck_types():
    plan = FaultPlan()
    assert resolve_chaos(None) is None
    assert resolve_chaos(plan) is plan
    assert resolve_chaos(ref_service().chaos.FaultPlan()) is not None  # the query surface is enough
    with pytest.raises(TypeError):
        resolve_chaos(object())


def test_chaos_is_hash_excluded_from_sort_config():
    """A faulted config and a clean one are equal and share prepare keys,
    as in the JAX package; ``prepare_key`` drops the plan."""
    clean = SortConfig(p=4, n_per_proc=64)
    faulted = SortConfig(p=4, n_per_proc=64, chaos=FaultPlan(seed=9))
    assert clean == faulted and hash(clean) == hash(faulted)
    assert clean.prepare_key() == faulted.prepare_key()
    assert faulted.prepare_key().chaos is None


def test_faulted_sort_builds_no_executor_entry_of_its_own():
    """``bsp_sort_safe`` with a plan: the plan stays out of every executor
    key, the faulted rung escalates, and the bytes are the clean run's."""
    x = np.random.default_rng(3).integers(0, 1000, (4, 64)).astype(np.int32)
    ex = SortExecutor()
    clean, _, cst = bsp_sort_safe(x, SortConfig(p=4, n_per_proc=64, algorithm="det", pair_capacity="whp"),
                                  executor=ex, device="cpu")
    keys = dict(ex.trace_counts)
    plan = FaultPlan(capacity_faults=((0, 0),))
    faulted, _, fst = bsp_sort_safe(x, SortConfig(p=4, n_per_proc=64, algorithm="det", pair_capacity="whp",
                                                  chaos=plan), executor=ex, device="cpu")
    assert all(k[2].chaos is None for k in ex.trace_counts)
    assert set(ex.trace_counts) - set(keys) and all(v == 1 for v in ex.trace_counts.values())
    assert list(cst.attempts) == ["whp"] and list(fst.attempts) == ["whp", "whp2"]
    assert plan.injected == {"capacity_fault": 1}
    assert torch.equal(gathered_output(clean), gathered_output(faulted))
    assert torch.equal(gathered_output(faulted), torch.sort(torch.from_numpy(x).flatten()).values)


# ------------------------------------------------------ capacity faults
def test_capacity_fault_escalates_byte_identically(executors):
    a = request_arrays([600], seed=1)[0]
    clean = [svc.sort_one(a) for svc in both(executors, pair_capacity="whp")]
    chaos = dict(seed=0, capacity_fault_rate=1.0, capacity_fault_rungs=(0, 1, 2))
    pair = both(executors, chaos=chaos, pair_capacity="whp")
    faulted = [svc.sort_one(a) for svc in pair]
    assert pair[1].cfg.chaos.injected == pair[0].cfg.chaos.injected
    assert pair[1].cfg.chaos.injected.get("capacity_fault", 0) >= 1
    assert faulted[1].tier == faulted[0].tier != clean[1].tier == clean[0].tier
    for res in clean + faulted:
        assert np.array_equal(res.keys, clean[0].keys) and np.array_equal(res.order, clean[0].order)
    assert_same_counters(*pair)


def test_capacity_fault_never_fires_on_terminal_rung(executors):
    a = request_arrays([400], seed=2)[0]
    pair = both(executors, chaos=dict(seed=0, capacity_fault_rate=1.0, capacity_fault_rungs=(0, 1, 2, 3, 4)),
                pair_capacity="whp")
    out = [svc.sort_one(a) for svc in pair]
    for res in out:
        assert np.array_equal(res.keys, np.sort(a)) and res.tier == "allgather"
    assert pair[1].cfg.chaos.injected == pair[0].cfg.chaos.injected
    assert_same_counters(*pair)


# -------------------------------------------------------- launch faults
def test_poison_rid_fails_naming_rid_innocents_byte_identical(executors):
    arrays = request_arrays([300, 250, 400, 200], seed=3)
    clean = run_both(both(executors), arrays)
    pair = both(executors, chaos=dict(seed=3, poison_rids=(1,)))
    rfuts, futs = run_both(pair, arrays)
    assert_same_outcomes(rfuts, futs)
    exc = futs[1].exception()
    assert isinstance(exc, SortServiceError) and "rid=1" in str(exc)
    assert isinstance(exc.__cause__, ChaosError)
    for i in (0, 2, 3):
        assert outcome(futs[i])[3:6] == outcome(clean[1][i])[3:6] == outcome(clean[0][i])[3:6]
    tele = pair[1].telemetry()["dispatch"]
    assert tele["failsink_errors"] == 1 and tele["recovered_batches"] >= 1
    assert pair[1].cfg.chaos.injected == pair[0].cfg.chaos.injected
    assert_same_counters(*pair)


def test_transient_launch_fault_recovers_all_requests(executors):
    arrays = request_arrays([300, 250, 400], seed=4)
    pair = both(executors, chaos=dict(seed=0, fail_batches=(0,)))
    rfuts, futs = run_both(pair, arrays)
    assert_same_outcomes(rfuts, futs)
    for a, f in zip(arrays, futs):
        assert np.array_equal(f.result().keys, np.sort(a)) and f.result().failsink
    assert pair[1].cfg.chaos.injected == pair[0].cfg.chaos.injected == {"launch_error": 1}
    tele = pair[1].telemetry()["dispatch"]
    assert tele["recovered_batches"] >= 1 and tele["failsink_errors"] == 0
    assert_same_counters(*pair)


# ---------------------------------------------- stragglers + the monitor
def test_straggler_monitor_is_slow_is_pure():
    r = ref_service()
    walls = [0.01, 0.012, 0.009, 0.011, 0.05, 0.01, 0.3, 0.3, 0.3, 0.01]
    m, rm = StragglerMonitor(threshold=2.0), r.elastic.StragglerMonitor(threshold=2.0)
    for w in walls:
        assert m.is_slow(w) == rm.is_slow(w)
        assert m.record(w) == rm.record(w)
        assert (m.ewma, m.slow_streak, m.steps) == (rm.ewma, rm.slow_streak, rm.steps)
    ewma = m.ewma
    assert m.is_slow(1.0) and not m.is_slow(0.001)
    assert m.ewma == ewma
    assert not StragglerMonitor().is_slow(100.0)


@pytest.mark.parametrize("n_devices,model_axis,old_data,batch", [(8, 2, 4, 64), (7, 2, 4, 64), (16, 4, 4, 48),
                                                                 (3, 1, 4, 12)])
def test_elastic_plan_remesh_and_retry_capacity_match_reference(n_devices, model_axis, old_data, batch):
    r = ref_service()
    assert elastic.plan_remesh(n_devices, model_axis, old_data, batch) == r.elastic.plan_remesh(
        n_devices, model_axis, old_data, batch)
    seen, rseen = [], []

    def step(log):
        return lambda cf: (log.append(cf) or cf, cf < 1.5)

    assert elastic.retry_capacity(step(seen)) == r.elastic.retry_capacity(step(rseen)) == 1.5625
    assert seen == rseen
    with pytest.raises(ValueError):
        elastic.plan_remesh(1, 2, 1, 8)
    with pytest.raises(ValueError):
        r.elastic.plan_remesh(1, 2, 1, 8)


def test_injected_straggle_counts_straggler_flights(executors):
    pair = both(executors, chaos=dict(seed=0, straggle_flights=(5,), straggle_s=0.25))
    for svc in pair:
        svc.dispatcher.stragglers = type(svc.dispatcher.stragglers)(threshold=3.0)
    arrays = request_arrays([256] * 7, seed=5)
    for svc in pair:
        for a in arrays:
            svc.sort_one(a)
    assert pair[1].cfg.chaos.injected == pair[0].cfg.chaos.injected == {"straggle": 1}
    assert pair[1].dispatcher.straggler_flights >= 1 and pair[0].dispatcher.straggler_flights >= 1
    assert_same_counters(*pair)


# ------------------------------------------------- deadlines and cancel
def test_deadline_expires_pending_request_with_timeout_naming_rid(executors):
    pair = both(executors)
    futs = []
    for svc in pair:
        keep = svc.submit(request_arrays([100], seed=6)[0])
        doomed = svc.submit(request_arrays([120], seed=7)[0], deadline_s=0.001)
        time.sleep(0.01)
        svc.run_pending(max_steps=0)
        futs.append([keep, doomed])
    assert_same_outcomes(*futs)
    exc = futs[1][1].exception()
    assert isinstance(exc, SortTimeoutError) and f"rid={futs[1][1].rid}" in str(exc)
    assert pair[1].telemetry()["deadline_timeouts"] == 1
    assert futs[1][0].exception() is None
    assert_same_counters(*pair)


def test_deadline_expires_formed_but_unlaunched_request(executors):
    pair = both(executors, max_in_flight=1)
    blocker_keys = request_arrays([400], seed=8)[0]
    a1, a2 = request_arrays([200, 220], seed=9)
    futs = []
    for svc in pair:
        blocker = svc.submit(blocker_keys)
        svc.flush_async()  # the blocker holds the only slot
        keep = svc.submit(a1)
        doomed = svc.submit(a2, deadline_s=0.001)
        svc.flush_async()  # formed and queued behind the blocker
        time.sleep(0.01)
        svc.run_pending(max_steps=0)
        futs.append([blocker, keep, doomed])
    assert_same_outcomes(*futs)
    blocker, keep, doomed = futs[1]
    assert isinstance(doomed.exception(), SortTimeoutError)
    assert np.array_equal(keep.result().keys, np.sort(a1))
    assert np.array_equal(blocker.result().keys, np.sort(blocker_keys))
    assert_same_counters(*pair)


def test_launched_requests_are_never_expired(executors):
    pair = both(executors)
    a = request_arrays([300], seed=10)[0]
    futs = []
    for svc in pair:
        fut = svc.submit(a, deadline_s=0.001)
        svc.flush_async()  # launched at once, past expiry
        time.sleep(0.01)
        svc.run_pending()
        futs.append([fut])
    assert_same_outcomes(*futs)
    assert np.array_equal(futs[1][0].result().keys, np.sort(a))
    assert_same_counters(*pair)


def test_cancel_pending_request_never_launches(executors):
    pair = both(executors)
    for svc in pair:
        fut = svc.submit(request_arrays([100], seed=11)[0])
        assert fut.cancel() and fut.cancelled() and fut.done()
        assert svc.dispatcher.launches == 0
        with pytest.raises(Exception, match=f"rid={fut.rid}") as ei:
            fut.result()
        assert type(ei.value).__name__ == "SortCancelledError"
        assert not fut.cancel()
    assert isinstance(fut.exception(), SortCancelledError)
    assert_same_counters(*pair)


def test_cancel_unpicks_queued_request_and_batch_reforms(executors):
    pair = both(executors, max_in_flight=1)
    arrays = request_arrays([150, 170, 190], seed=13)
    futs = []
    for svc in pair:
        blocker = svc.submit(request_arrays([400], seed=12)[0])
        svc.flush_async()
        fs = [svc.submit(a) for a in arrays]
        svc.flush_async()
        assert fs[1].cancel() and fs[1].cancelled()
        svc.flush()
        futs.append([blocker] + fs)
        assert svc.dispatcher.cancelled_rids == 1
    assert_same_outcomes(*futs)
    assert np.array_equal(futs[1][1].result().keys, np.sort(arrays[0]))
    assert np.array_equal(futs[1][3].result().keys, np.sort(arrays[2]))
    assert_same_counters(*pair)


def test_cancel_after_launch_returns_false_and_completes(executors):
    pair = both(executors)
    a = request_arrays([250], seed=14)[0]
    futs = []
    for svc in pair:
        fut = svc.submit(a)
        svc.flush_async()
        assert not fut.cancel()
        futs.append([fut])
    assert_same_outcomes(*futs)
    assert np.array_equal(futs[1][0].result().keys, np.sort(a))


# ------------------------------------- retry budget and circuit breaker
def fail_fused_with_poison(orig):
    def poisoned(packed, **kw):  # fails only while fused with others
        if POISON_LEN in packed.sizes and len(packed.sizes) > 1:
            raise RuntimeError("backend error (simulated)")
        return orig(packed, **kw)

    return poisoned


def test_retry_budget_explodes_to_solos(executors, monkeypatch):
    patch_launch(monkeypatch, fail_fused_with_poison)
    pair = both(executors, fault_retry_budget=0, breaker_threshold=0)
    arrays = request_arrays([200, POISON_LEN, 250, 300], seed=15)
    rfuts, futs = run_both(pair, arrays)
    assert_same_outcomes(rfuts, futs)
    for a, f in zip(arrays, futs):
        assert np.array_equal(f.result().keys, np.sort(a))
    tele = pair[1].telemetry()["dispatch"]
    assert tele["retry_budget_exceeded"] == 1 and tele["failsink_splits"] == 0
    assert_same_counters(*pair)


def test_circuit_breaker_degrades_bucket_to_solo_exact(executors, monkeypatch):
    patch_launch(monkeypatch, fail_fused_with_poison)
    pair = both(executors, breaker_threshold=2)
    for rnd in range(3):
        arrays = request_arrays((200, POISON_LEN, 250), seed=20 + rnd)
        rfuts, futs = run_both(pair, arrays)
        assert_same_outcomes(rfuts, futs)
        for a, f in zip(arrays, futs):
            assert np.array_equal(f.result().keys, np.sort(a))
    tele = pair[1].telemetry()["dispatch"]
    assert tele["breaker_opened"] >= 1 and tele["breaker_degraded_batches"] >= 1
    assert_same_counters(*pair)


def test_circuit_breaker_closes_after_cooldown(executors, monkeypatch):
    """Past the cooldown the bucket readmits fused batches (half-open); the
    cooldown is expired by rewinding the open instant on each clock."""
    fail = {"on": True}

    def flaky(orig):
        def launch(packed, **kw):
            if fail["on"] and len(packed.sizes) > 1:
                raise RuntimeError("backend error (simulated)")
            return orig(packed, **kw)

        return launch

    patch_launch(monkeypatch, flaky)
    pair = both(executors, breaker_threshold=1, breaker_cooldown_s=60.0)
    rounds = [request_arrays([200, 250], seed=s) for s in (30, 31, 32)]
    rfuts, futs = run_both(pair, rounds[0])  # a fused failure opens the breaker
    assert_same_outcomes(rfuts, futs)
    assert all(f.exception() is None for f in futs) and pair[1].dispatcher.breaker_opened == 1
    fail["on"] = False
    rfuts, futs = run_both(pair, rounds[1])  # inside the open window: degraded
    assert_same_outcomes(rfuts, futs)
    assert pair[1].telemetry()["dispatch"]["breaker_degraded_batches"] == 1
    for svc in pair:
        d = svc.dispatcher
        for bucket in list(d._breaker_open_at):
            d._breaker_open_at[bucket] -= 61.0
    rfuts, futs = run_both(pair, rounds[2])  # fused again, clean
    assert_same_outcomes(rfuts, futs)
    tele = pair[1].telemetry()["dispatch"]
    assert tele["breaker_degraded_batches"] == 1 and tele["breaker_opened"] == 1
    assert_same_counters(*pair)


def test_backoff_and_breaker_read_the_dispatch_module_clock(executors, monkeypatch):
    """Backoff gates and the breaker's cooldown read the dispatch module's
    ``time.perf_counter``: with that clock frozen, a backed-off retry is
    not launchable until the clock is moved past its gate, and an open
    breaker closes only when the clock passes the cooldown."""
    import repro_torch.service.dispatch as disp
    import repro_torch.service.service as service_mod

    now = {"t": 1000.0}

    class Clock:
        @staticmethod
        def perf_counter():
            return now["t"]

        sleep = staticmethod(lambda s: now.__setitem__("t", now["t"] + s))

    monkeypatch.setattr(disp, "time", Clock)
    monkeypatch.setattr(service_mod, "time", Clock)
    patch_launch(monkeypatch, fail_fused_with_poison)
    svc = SortService(ServiceConfig(p=P, failsink_backoff_s=5.0, failsink_backoff_max_s=5.0, breaker_threshold=1,
                                    breaker_cooldown_s=30.0, max_in_flight=1),
                      executor=executors[1], device="cpu")
    arrays = request_arrays([200, POISON_LEN], seed=40)
    futs = [svc.submit(a) for a in arrays]
    svc.flush_async()  # the fused batch fails: bisected halves back off 5 s
    d = svc.dispatcher
    assert d.failsink_splits == 1 and d.in_flight == 0 and len(d._queue) == 2
    assert d._next_launchable(now["t"]) is None
    assert d._next_launchable(now["t"] + 5.0) == 0
    bucket = svc.former.bucket(sum(len(a) for a in arrays))  # the fused batch's
    assert list(d._breaker_open_at) == [bucket] and d._breaker_is_open(bucket)
    t0 = now["t"]
    svc.flush()  # step() sleeps on the frozen clock up to the gate
    assert now["t"] == t0 + 5.0
    for a, f in zip(arrays, futs):
        assert np.array_equal(f.result().keys, np.sort(a))
    now["t"] += 24.0
    assert d._breaker_is_open(bucket)
    now["t"] += 1.0
    assert not d._breaker_is_open(bucket)


# --------------------------------------------------- delta fold corruption
def fold_fallbacks(reg, label):
    return {str(lbl["view"]): c.value for lbl, c in reg.collect("delta.fold_fallback_resorts")}.get(label, 0)


def test_fold_corruption_falls_back_to_resort_byte_identically():
    r = ref_service()
    rng = np.random.default_rng(32)
    b1 = rng.integers(0, 1000, 400).astype(np.int32)
    b2 = rng.integers(0, 1000, 60).astype(np.int32)
    rplan = r.chaos.FaultPlan(seed=0, corrupt_folds=(0,))
    plan = fault_plan_from_reference(rplan)
    rv = r.delta.SortedView(p=4, chaos_handle=rplan)
    v = SortedView(p=4, chaos_handle=plan, device="cpu")
    for view in (rv, v):
        view.fold(b1, (np.arange(400, dtype=np.int64),))
    assert v.fold(b2, (np.arange(400, 460, dtype=np.int64),)) == rv.fold(
        b2, (np.arange(400, 460, dtype=np.int64),)) == "resort"
    assert plan.injected == rplan.injected == {"fold_corruption": 1}
    cat = np.concatenate([b1, b2])
    assert np.array_equal(v.keys.numpy(), np.sort(cat)) and np.array_equal(v.keys.numpy(), rv.keys)
    assert np.array_equal(v.payloads[0].numpy(), np.argsort(cat, kind="stable"))
    assert np.array_equal(v.payloads[0].numpy(), rv.payloads[0])
    assert fold_fallbacks(obs.metrics(), v.label) == fold_fallbacks(r.obs.metrics(), rv.label) == 1
    assert v.clone()._chaos_handle is plan


def test_uncorrupted_folds_never_fall_back():
    r = ref_service()
    rng = np.random.default_rng(33)
    rv = r.delta.SortedView(p=4, chaos_handle=r.chaos.FaultPlan(seed=0))
    v = SortedView(p=4, chaos_handle=FaultPlan(seed=0), device="cpu")
    hist = []
    for _ in range(3):
        b = rng.integers(0, 1000, 200).astype(np.int32)
        base = sum(len(h) for h in hist)
        assert v.fold(b, (np.arange(base, base + 200, dtype=np.int64),)) == rv.fold(
            b, (np.arange(base, base + 200, dtype=np.int64),))
        hist.append(b)
    assert np.array_equal(v.keys.numpy(), np.sort(np.concatenate(hist))) and np.array_equal(v.keys.numpy(), rv.keys)
    assert fold_fallbacks(obs.metrics(), v.label) == fold_fallbacks(r.obs.metrics(), rv.label) == 0


# ------------------------------------------------ driver pump and thread
def test_run_pending_fires_flush_after_s_without_any_caller(executors):
    pair = both(executors, flush_after_s=0.005)
    a = request_arrays([200], seed=34)[0]
    futs = []
    for svc in pair:
        fut = svc.submit(a)
        time.sleep(0.02)
        assert not fut.done()
        svc.run_pending(max_steps=1)  # no submit, no claim: just the pump
        assert svc.pending == 0 and fut.done()
        assert svc.flush_triggers.get("deadline", 0) == 1
        futs.append([fut])
    assert_same_outcomes(*futs)
    assert np.array_equal(futs[1][0].result().keys, np.sort(a))
    assert_same_counters(*pair)


def test_driver_thread_resolves_futures_in_background(executors):
    pair = both(executors, flush_after_s=0.002)
    a = request_arrays([300], seed=35)[0]
    futs = []
    for svc in pair:
        svc.start_driver(interval_s=0.002)
        try:
            fut = svc.submit(a)
            deadline = time.time() + 20.0
            while not fut.done() and time.time() < deadline:
                time.sleep(0.005)
            assert fut.done(), "the driver thread never resolved the future"
            futs.append([fut])
        finally:
            svc.stop_driver()
    assert_same_outcomes(*futs)
    assert np.array_equal(futs[1][0].result().keys, np.sort(a))


def test_chaos_service_end_to_end_soak_innocents_byte_identical(executors):
    """Capacity faults, two poison rids, transient launch faults and a
    straggler over a request mix: every innocent equals the un-faulted run
    byte for byte, both poisons fail naming their rid, and the faulted run
    equals the reference's faulted run, injections and counters included."""
    sizes = [200, 350, 150, 420, 260, 180, 310, 240]
    arrays = request_arrays(sizes, seed=36)
    poison = (2, 5)
    clean = run_both(both(executors, max_batch_keys=1 << 13), arrays)
    chaos = dict(seed=36, poison_rids=poison, capacity_fault_rate=0.5, capacity_fault_rungs=(0,),
                 transient_error_rate=0.4, straggle_flights=(0,), straggle_s=0.002)
    pair = both(executors, chaos=chaos, max_batch_keys=1 << 13)
    rfuts, futs = run_both(pair, arrays)
    assert_same_outcomes(rfuts, futs)
    for f, c in zip(futs, clean[1]):
        if f.rid in poison:
            exc = f.exception()
            assert isinstance(exc, SortServiceError) and f"rid={f.rid}" in str(exc)
        else:
            assert outcome(f)[3:6] == outcome(c)[3:6]
    plan = pair[1].cfg.chaos
    assert plan.injected == pair[0].cfg.chaos.injected and plan.injected_total > 0
    assert_same_counters(*pair)
