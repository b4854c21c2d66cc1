"""``repro_torch.service.dispatch`` — futures, in-flight batches and failsink
isolation — against the JAX package.

The JAX package's ``tests/test_dispatch.py``, held against
``repro.service`` on the same numpy inputs: each property is checked on
the port, and a service in each package given the same requests (and the
same simulated backend failures, wrapped around ``segmented_sort_launch``
in each dispatch namespace) gives every request the same outcome (keys
and stable order byte for byte, tier, bucket, failsink mark; a failure's
class, message and rids) and the same counters (``telemetry()`` without
its clock readings). Completion copies a flight's flat keys and
positions to the host once and hands out numpy views of them; the plan
to overrides step equals the reference dispatcher's. The port's
randomized sorts draw the reference's samples. Tolerance: exact.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import SortExecutor, pack_segments, segmented_sort_launch, sort_segments
from repro_torch.planner import CapacityPlanner
from repro_torch.service import BatchFormer, ServiceConfig, SortFuture, SortService, SortServiceError
from repro_torch.service.dispatch import plan_overrides
from test_torch_harness import (
    assert_same_counters,
    assert_same_outcomes,
    patch_launch,
    ref_service,
    reference,
    reference_draws,
    request_arrays,
    service_pair,
    x64,
)

P = 8
POISON_LEN = 777  # unique request length the poison wrappers key on


@pytest.fixture(scope="module")
def executors():
    """One executor per package for the module: the reference compiles per bucket."""
    return reference().SortExecutor(), SortExecutor()


@pytest.fixture(autouse=True)
def _draws(monkeypatch):
    reference_draws(monkeypatch)


def both(executors, **cfg):
    return service_pair(*executors, **dict(dict(p=P), **cfg))


def run_both(pair, arrays):
    out = []
    for svc in pair:
        futs = [svc.submit(a) for a in arrays]
        svc.flush()
        out.append(futs)
    return out


def test_submit_returns_future_without_dispatching(executors):
    pair = both(executors)
    arrays = request_arrays([100, 300, 50])
    futs = []
    for svc in pair:
        fs = [svc.submit(a) for a in arrays]
        assert all(not f.done() for f in fs)
        assert svc.pending == 3 and svc.dispatcher.idle and svc.dispatcher.launches == 0
        futs.append(fs)
    assert all(isinstance(f, SortFuture) for f in futs[1])
    for f in futs[0] + futs[1]:
        f.result()  # the only blocking point
    assert_same_outcomes(*futs)
    for a, f in zip(arrays, futs[1]):
        res = f.result()
        assert isinstance(res.keys, np.ndarray) and np.array_equal(res.keys, np.sort(a))
        assert np.array_equal(a[res.order], res.keys)
    assert_same_counters(*pair)


def test_futures_path_byte_identical_to_fused_sync_path(executors):
    """Results claimed through futures equal the core fused segmented sort
    (the port's and the reference's) byte for byte."""
    arrays = request_arrays([5, 333, 64, 1000, 7, 512], seed=9)
    with x64():
        want = reference().sort_segments(arrays, p=P)
    got = sort_segments(arrays, p=P, device="cpu")
    pair = both(executors)
    rfuts, futs = run_both(pair, arrays)
    assert_same_outcomes(rfuts, futs)
    for i, f in enumerate(futs):
        res = f.result()
        assert res.keys.dtype == np.int32 and res.order.dtype == np.asarray(want.order[i]).dtype
        assert np.array_equal(res.keys, np.asarray(want.keys[i])) and np.array_equal(res.keys, got.keys[i].numpy())
        assert np.array_equal(res.order, np.asarray(want.order[i])) and np.array_equal(res.order, got.order[i].numpy())


def test_multiple_batches_in_flight_overlap(executors):
    pair = both(executors, max_batch_keys=400, max_in_flight=2)
    arrays = request_arrays([300, 300, 300, 300], seed=3)
    futs = []
    for svc in pair:
        fs = [svc.submit(a) for a in arrays]
        svc.flush_async()
        assert svc.dispatcher.in_flight == 2 and svc.dispatcher.launches == 2
        assert not any(f.done() for f in fs)
        svc.flush()
        futs.append(fs)
    tele = pair[1].telemetry()["dispatch"]
    assert tele["in_flight_peak"] >= 2 and tele["overlapped_launches"] >= 1
    assert_same_outcomes(*futs)
    for a, f in zip(arrays, futs[1]):
        assert np.array_equal(f.result().keys, np.sort(a))
    assert_same_counters(*pair)


def fail_with(*lengths, fused_only=False):
    def wrap(orig):
        def poisoned(packed, **kw):
            if any(n in packed.sizes for n in lengths) and (len(packed.sizes) > 1 or not fused_only):
                raise RuntimeError("backend error (simulated)")
            return orig(packed, **kw)

        return poisoned

    return wrap


def test_poison_request_failsink_isolates_and_resolves_solo(executors, monkeypatch):
    patch_launch(monkeypatch, fail_with(POISON_LEN, fused_only=True))
    pair = both(executors)
    arrays = request_arrays([300, 300, POISON_LEN, 300, 300], seed=5)
    outs = []
    futs = []
    for svc in pair:
        fs = [svc.submit(a) for a in arrays]
        outs.append(svc.flush())
        futs.append(fs)
    assert set(outs[1]) == set(outs[0]) == {f.rid for f in futs[1]}
    assert_same_outcomes(*futs)
    for a, f in zip(arrays, futs[1]):
        assert np.array_equal(f.result().keys, np.sort(a))
    poison = futs[1][2].result()
    assert poison.failsink and poison.n_per_proc == 128
    tele = pair[1].telemetry()["dispatch"]
    assert tele["failsink_splits"] >= 1 and tele["failsink_errors"] == 0 and tele["failsink_resolved"] >= 1
    assert_same_counters(*pair)


def test_poison_request_failsink_terminal_error_spares_the_batch(executors, monkeypatch):
    patch_launch(monkeypatch, fail_with(POISON_LEN))
    pair = both(executors)
    arrays = request_arrays([200, POISON_LEN, 200, 200], seed=6)
    rfuts, futs = run_both(pair, arrays)
    assert_same_outcomes(rfuts, futs)
    for i, (a, f) in enumerate(zip(arrays, futs)):
        if i != 1:
            assert np.array_equal(f.result().keys, np.sort(a))
    exc = futs[1].exception()
    assert isinstance(exc, SortServiceError) and exc.rids == (futs[1].rid,) and str(futs[1].rid) in str(exc)
    with pytest.raises(SortServiceError):
        futs[1].result()
    with pytest.raises(SortServiceError):
        pair[1].take_result(futs[1])
    tele = pair[1].telemetry()
    assert tele["requests_failed"] == 1 and tele["dispatch"]["failsink_errors"] == 1
    assert tele["dispatch"]["failsink_splits"] >= 2 and tele["dispatch"]["failsink_solo_retries"] >= 1
    assert_same_counters(*pair)


def test_sort_many_surfaces_failure_as_service_error_not_keyerror(executors, monkeypatch):
    patch_launch(monkeypatch, fail_with(POISON_LEN))
    pair = both(executors)
    arrays = request_arrays([100, POISON_LEN, 150], seed=7)
    for svc in pair:
        with pytest.raises(Exception) as ei:
            svc.sort_many(arrays)
        assert type(ei.value).__name__ == "SortServiceError" and ei.value.rids == (1,)
        for rid, a in [(0, arrays[0]), (2, arrays[2])]:
            assert np.array_equal(svc.take_result(rid).keys, np.sort(a))
        with pytest.raises(Exception, match="rid=1") as ei:
            svc.take_result(1)
        assert type(ei.value).__name__ == "SortServiceError"
    assert_same_counters(*pair)


def test_unclaimed_store_bounded_with_eviction_counter(executors):
    pair = both(executors, max_unclaimed=4)
    arrays = request_arrays([50] * 6, seed=8)
    futs = []
    for svc in pair:
        fs = [svc.submit(a) for a in arrays]
        out = svc.flush()
        assert set(out) == {f.rid for f in fs[2:]}
        assert svc.evicted_results == 2 and svc.telemetry()["evicted_results"] == 2
        with pytest.raises(Exception, match="evicted"):
            svc.take_result(fs[0].rid)
        futs.append(fs)
    assert_same_outcomes(*futs)
    svc, fs = pair[1], futs[1]
    assert np.array_equal(fs[0].result().keys, np.sort(arrays[0]))
    assert np.array_equal(svc.take_result(fs[5]).keys, np.sort(arrays[5]))


def test_telemetry_latency_stats_memoized_per_completion(executors, monkeypatch):
    svc = SortService(ServiceConfig(p=P), executor=executors[1], device="cpu")
    svc.sort_many(request_arrays([100, 200, 300], seed=10))
    calls = {"n": 0}
    orig = np.quantile

    def counting(*args, **kw):
        calls["n"] += 1
        return orig(*args, **kw)

    monkeypatch.setattr(np, "quantile", counting)
    first = svc.telemetry()
    after_first = calls["n"]
    assert after_first >= 1 and first["lat_p99_ms"] > 0
    for _ in range(5):
        again = svc.telemetry()
    assert calls["n"] == after_first and again["lat_p99_ms"] == first["lat_p99_ms"]
    svc.sort_one(np.arange(64, dtype=np.int32)[::-1].copy())
    svc.telemetry()
    assert calls["n"] > after_first


def test_form_ready_holds_partial_tail_and_flush_ready_launches_full(executors):
    r = ref_service()
    reqs = [(i, np.zeros(s, np.int32)) for i, s in enumerate([600, 300, 200])]
    for former in (BatchFormer(p=8, max_batch_keys=1000, min_n_per_proc=8),
                   r.service.BatchFormer(p=8, max_batch_keys=1000, min_n_per_proc=8)):
        ready, held = former.form_ready(reqs, min_keys=500)
        assert [b.rids for b in ready] == [[0, 1]] and [rid for rid, _ in held] == [2]
        ready2, held2 = former.form_ready(reqs)
        assert [b.rids for b in ready2] == [[0, 1]] and len(held2) == 1
        assert former.form_ready([]) == ([], [])
    pair = both(executors, max_batch_keys=1000)
    arrays = request_arrays([600, 300, 200], seed=11)
    futs = []
    for svc in pair:
        fs = [svc.submit(a) for a in arrays]
        assert svc.flush_ready(min_keys=500) and svc.pending == 1
        assert svc.flush_triggers.get("ready") == 1
        assert not svc.flush_ready(min_keys=500)
        svc.flush()
        assert svc.pending == 0
        futs.append(fs)
    assert_same_outcomes(*futs)
    for a, f in zip(arrays, futs[1]):
        assert np.array_equal(f.result().keys, np.sort(a))
    assert_same_counters(*pair)


def test_two_poison_requests_in_one_batch_both_isolated(executors, monkeypatch):
    patch_launch(monkeypatch, fail_with(POISON_LEN, 778))
    pair = both(executors, breaker_threshold=0)
    arrays = request_arrays([300, POISON_LEN, 250, 778, 200, 350], seed=12)
    rfuts, futs = run_both(pair, arrays)
    assert_same_outcomes(rfuts, futs)
    for i, (a, f) in enumerate(zip(arrays, futs)):
        if i in (1, 3):
            exc = f.exception()
            assert isinstance(exc, SortServiceError) and exc.rids == (f.rid,) and f"rid={f.rid}" in str(exc)
        else:
            assert f.exception() is None and np.array_equal(f.result().keys, np.sort(a))
    assert pair[1].telemetry()["dispatch"]["failsink_errors"] == 2
    assert pair[1].telemetry()["requests_failed"] == 2
    assert_same_counters(*pair)


def test_backoff_does_not_starve_innocents_behind_retry_queue(executors, monkeypatch):
    """While a failed batch's retry backs off, a fresh innocent launches
    ahead of it; the two packages launch the same sequence."""
    logs = []

    def recording(orig):
        launched = []
        logs.append(launched)

        def launch(packed, **kw):
            launched.append(tuple(packed.sizes))
            if POISON_LEN in packed.sizes:
                raise RuntimeError("backend error (simulated)")
            return orig(packed, **kw)

        return launch

    patch_launch(monkeypatch, recording)
    pair = both(executors, failsink_backoff_s=0.2, failsink_backoff_max_s=0.2, breaker_threshold=0,
                max_in_flight=1)
    a = request_arrays([200], seed=14)[0]
    futs = []
    for svc, launched in zip(pair, logs):
        poison = svc.submit(request_arrays([POISON_LEN], seed=13)[0])
        svc.flush_async()
        assert launched == [(POISON_LEN,)]
        innocent = svc.submit(a)
        assert np.array_equal(innocent.result().keys, np.sort(a))
        first_retry = launched.index((POISON_LEN,), 1) if launched.count((POISON_LEN,)) > 1 else len(launched)
        assert launched.index((200,)) < first_retry, launched
        with pytest.raises(Exception, match=f"rid={poison.rid}"):
            poison.result()
        assert launched.count((POISON_LEN,)) == 2
        futs.append([poison, innocent])
    assert logs[0] == logs[1]
    assert_same_outcomes(*futs)
    assert_same_counters(*pair)


# ------------------------------------------------------------- port-side
def test_plan_overrides_match_the_reference_dispatcher(executors):
    """The plan-to-overrides step equals the reference dispatcher's
    ``_resolve_batch`` on the same batches (radix, planned, pinned,
    degraded and delta decisions)."""
    from repro_torch.core import datagen

    r = ref_service()
    rsvc, svc = both(executors)
    rng = np.random.default_rng(2)
    batches = [
        [rng.integers(-(2**31), 2**31, 300).astype(np.int32) for _ in range(3)],  # balanced: radix
        [datagen.generate("zipf", 1, 200 + 10 * i, seed=i)[0] for i in range(4)],  # planned
        [np.sort(rng.integers(0, 1 << 20, 4000)).astype(np.int32)],  # sorted single segment
        [datagen.near_sorted(4000, 0.01, "scattered", seed=3)],  # near sorted: delta
    ]
    for arrays in batches:
        rb = r.service.BatchFormer(P).form(list(enumerate(arrays)))[0]
        b = BatchFormer(P).form(list(enumerate(arrays)))[0]
        for degraded in (False, True):
            with x64(len(arrays) > 1):
                rpacked, rov, rd = rsvc.dispatcher._resolve_batch(rb, degraded=degraded)
            packed, ov, d = svc.dispatcher._resolve_batch(b, degraded=degraded)
            assert ov == rov and (rd is None) == (d is None)
            if d is not None:
                assert (d.route, d.layout, d.pair_capacity, d.pair_cap_override, d.omega) == (
                    rd.route, rd.layout, rd.pair_capacity, rd.pair_cap_override, rd.omega)
                if d.route != "delta":
                    assert plan_overrides(d) == ov
            assert (packed is None) == (rpacked is None)
            if packed is not None:
                assert np.array_equal(packed.comp, np.asarray(rpacked.comp)) and packed.layout == rpacked.layout
    pinned = service_pair(*executors, p=P, pair_capacity="whp")[1]
    assert pinned.dispatcher._resolve_batch(b)[1] == {"pair_capacity": "whp"}


def test_completion_copies_each_flight_to_the_host_once(monkeypatch):
    """A flight of 16 segments reaches the host in two copies (its flat
    keys and its positions), and every result is a numpy view of them."""
    arrays = request_arrays([37 * (i + 1) for i in range(16)], seed=4)
    for layout in ("striped", "contiguous"):
        inflight = segmented_sort_launch(pack_segments(arrays, P, layout=layout), device="cpu",
                                         generator=torch.Generator().manual_seed(1))
        calls = {"n": 0}
        orig = torch.Tensor.cpu

        def counting(self, *a, **kw):
            calls["n"] += 1
            return orig(self, *a, **kw)

        monkeypatch.setattr(torch.Tensor, "cpu", counting)
        res = inflight.wait(host=True)
        monkeypatch.setattr(torch.Tensor, "cpu", orig)
        assert calls["n"] == 2
        assert all(isinstance(k, np.ndarray) and k.base is not None for k in res.keys + res.order)
        assert len({id(k.base) for k in res.keys}) == 1 and len({id(o.base) for o in res.order}) == 1
        for a, k, o in zip(arrays, res.keys, res.order):
            assert np.array_equal(k, np.sort(a)) and np.array_equal(o, np.argsort(a, kind="stable"))


def test_planner_is_shared_across_services(executors):
    """A shared planner pools two services' traffic history, as in the
    reference (the planner's decisions are host code, held equal in
    tests/test_torch_planner.py)."""
    planner = CapacityPlanner()
    a, b = (SortService(ServiceConfig(p=P), executor=executors[1], planner=planner, device="cpu") for _ in range(2))
    arrays = request_arrays([300, 200], seed=21)
    a.sort_many(arrays)
    b.sort_many(arrays)
    assert a.planner is b.planner and planner.plans == 2
