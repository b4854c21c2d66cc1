"""``repro_torch.service`` — the sort service, its batch former and stream
folds — against the JAX package.

The JAX package's ``tests/test_service.py``, held against
``repro.service`` and ``repro.core`` on the same numpy inputs: fused
segmented sorts equal per-request sorts and the reference's; a service in
each package given the same requests gives every request the same outcome
(keys and stable order byte for byte, tier, bucket, failsink mark) and
the same counters (``telemetry()`` without its clock readings), at both
pipeline depths; the former's buckets and the executor's reuse per bucket
match; a stream's folds, a corrupted one included, equal the reference's
and a cold sort of the stream. ``ServiceConfig`` has the reference's
fields and defaults; the device is ``SortService(device=)``. The port's
randomized sorts draw the reference's samples. Two reference tests have
no counterpart yet: ``length_bucketed_order`` (``repro.data``) and the
benchmark JSON writer (``benchmarks/``) are not ported. Tolerance: exact.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import (
    SortExecutor,
    bsp_sort_safe,
    datagen,
    gathered_output,
    pack_segments,
    service_config_from_reference,
    sort_segments,
)
from repro_torch import obs
from repro_torch.service import BatchFormer, ServiceConfig, SortService
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


@pytest.fixture(scope="module")
def executors():
    """One executor per package for the module: the reference compiles per bucket."""
    return reference().SortExecutor(), SortExecutor()


@pytest.fixture(autouse=True)
def _draws(request, monkeypatch):
    if "cuda" not in request.keywords:  # the card test runs where JAX is absent
        reference_draws(monkeypatch)


def both(executors, **cfg):
    return service_pair(*executors, **dict(dict(p=P), **cfg))


def many_both(pair, arrays):
    return [svc.sort_many(arrays) for svc in pair]


def assert_same_results(rres, res):
    for r, g in zip(rres, res):
        assert (g.rid, g.tier, g.n_per_proc, g.failsink) == (r.rid, r.tier, r.n_per_proc, r.failsink)
        for a, b in ((r.keys, g.keys), (r.order, g.order)):
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def per_request(keys: np.ndarray, p: int = P) -> np.ndarray:
    """One whole overflow-safe sort for this request alone, on its own
    sentinel-padded pow2 layout."""
    n = keys.shape[0]
    n_p = max(8, 1 << (max(1, -(-n // p)) - 1).bit_length())
    x = np.concatenate([keys, np.full(p * n_p - n, np.iinfo(np.int32).max, np.int32)])
    res, _, _ = bsp_sort_safe(x.reshape(p, n_p), algorithm="iran", pair_capacity="whp", device="cpu")
    return gathered_output(res)[:n].numpy()


def test_segmented_matches_per_request_sort_byte_identical():
    sizes = datagen.zipf_sizes(24, 4096, seed=21)
    mixes = ["U", "DD", "zipf", "WR"]
    arrays = [datagen.generate(mixes[i % 4], 1, int(s), seed=50 + i)[0] for i, s in enumerate(sizes)]
    res = sort_segments(arrays, p=P, device="cpu")
    with x64():
        want = reference().sort_segments(arrays, p=P)
    for i, (a, got) in enumerate(zip(arrays, res.keys)):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), per_request(a)) and np.array_equal(got.numpy(), np.asarray(want.keys[i]))
        assert np.array_equal(res.order[i].numpy(), np.asarray(want.order[i]))


@pytest.mark.parametrize("case", ["ragged_and_empty", "duplicate_heavy"])
def test_segmented_ragged_empty_and_stable(case):
    if case == "ragged_and_empty":
        arrays = request_arrays([0, 1, 7, 333, 0, 64])
    else:
        arrays = [np.zeros(257, np.int32), datagen.generate("DD", 1, 500, seed=2)[0],
                  datagen.generate("zipf", 1, 400, seed=3)[0]]
    res = sort_segments(arrays, p=P, device="cpu")
    assert [len(k) for k in res.keys] == [len(a) for a in arrays]
    for a, k, o in zip(arrays, res.keys, res.order):
        k, o = k.numpy(), o.numpy()
        assert np.array_equal(k, np.sort(a)) and np.array_equal(a[o], k)
        for v in np.unique(k):
            assert (np.diff(o[k == v]) > 0).all()  # stable within equal keys


def test_segmented_adversarial_batch_escalates_not_truncates(executors):
    arrays = [np.full(1024, r * 1000, np.int32) for r in range(8)]
    pair = both(executors, pair_capacity="whp")
    rres, res = many_both(pair, arrays)
    assert_same_results(rres, res)
    assert pair[1].stats.retries >= 1
    for a, r in zip(arrays, res):
        assert np.array_equal(r.keys, np.sort(a)) and r.tier not in (None, "whp")
    assert_same_counters(*pair)


def test_default_service_serves_multi_segment_batches_first_tier(executors):
    rng = np.random.default_rng(7)
    arrays = [rng.integers(0, 2**31, 512).astype(np.int32) for _ in range(16)]
    pair = both(executors)
    rres, res = many_both(pair, arrays)
    assert_same_results(rres, res)
    assert pair[1].stats.retries == 0, pair[1].stats.as_row()
    assert all(r.tier == pair[1].stats.last_tier for r in res)
    for a, r in zip(arrays, res):
        assert np.array_equal(r.keys, np.sort(a))
    assert_same_counters(*pair)


def test_flush_keeps_piggybacked_results_claimable(executors):
    pair = both(executors)
    a = np.arange(100, dtype=np.int32)[::-1].copy()
    b = np.arange(50, dtype=np.int32)[::-1].copy()
    for svc in pair:
        fut_a = svc.submit(a)
        assert not fut_a.done() and svc.dispatcher.idle
        res_b = svc.sort_one(b)
        assert np.array_equal(res_b.keys, np.sort(b))
        assert svc.pending == 0 and fut_a.done()
        assert set(svc.flush()) == {fut_a.rid}
        res_a = svc.take_result(fut_a.rid)
        assert np.array_equal(res_a.keys, np.sort(a))
        assert svc.flush() == {} and fut_a.result() is res_a
        assert np.array_equal(svc.take_result(svc.submit(a)).keys, np.sort(a))
        assert np.array_equal(svc.take_result(svc.submit(a).rid).keys, np.sort(a))
    assert_same_counters(*pair)


def test_batch_former_pow2_buckets_and_key_cap():
    r = ref_service()
    reqs = [(i, np.zeros(s, np.int32)) for i, s in enumerate([600, 300, 200, 5000])]
    rows = []
    for former in (BatchFormer(p=8, max_batch_keys=1000, min_n_per_proc=8),
                   r.service.BatchFormer(p=8, max_batch_keys=1000, min_n_per_proc=8)):
        batches = former.form(reqs)
        assert [b.rids for b in batches] == [[0, 1], [2], [3]]
        for b in batches:
            assert b.n_per_proc & (b.n_per_proc - 1) == 0 and 8 * b.n_per_proc >= b.total_keys
        assert batches[0].n_per_proc == 128 and former.form([]) == []
        rows.append([(b.rids, b.total_keys, b.n_per_proc) for b in batches])
        rows.append([former.bucket(t) for t in (0, 1, 63, 64, 65, 1000, 4097, 1 << 20)])
    assert rows[0] == rows[2] and rows[1] == rows[3]


def test_batch_former_reuses_one_set_of_entries_per_bucket():
    """Two different same-bucket mixes reuse one set of executor entries;
    another bucket builds its own once. The entries' kinds and buckets are
    the reference's compiled programs'."""
    r = ref_service()
    ex, rex = SortExecutor(), reference().SortExecutor()
    kw = dict(p=8, algorithm="det", pair_capacity="exact")
    rng = np.random.default_rng(4)
    mixes = [[rng.integers(0, 2**31, s).astype(np.int32) for s in sizes]
             for sizes in ([900, 60, 40], [500, 10, 400, 101], [5000])]

    def shape(counts):
        return sorted((k[0], k[2].n_per_proc, k[2].pair_capacity, k[3]) for k in counts)

    seen = []
    for i, arrays in enumerate(mixes):
        SortService(ServiceConfig(**kw), executor=ex, device="cpu").sort_many(arrays)
        r.service.SortService(r.service.ServiceConfig(**kw), executor=rex).sort_many(arrays)
        assert all(v == 1 for v in ex.trace_counts.values())
        assert shape(ex.trace_counts) == shape(rex.trace_counts)
        seen.append(dict(ex.trace_counts))
    assert sum(1 for k in seen[0] if k[0] == "prepare") == 1
    assert seen[1] == seen[0] and len(seen[2]) > len(seen[1])


def test_service_telemetry_latency_and_tier_stats(executors):
    pair = both(executors)
    arrays = [np.arange(s, dtype=np.int32)[::-1].copy() for s in [10, 200, 3000]]
    rres, res = many_both(pair, arrays)
    assert_same_results(rres, res)
    svc = pair[1]
    assert len(svc.latencies) == 3 and all(r.latency_s > 0 for r in res)
    assert all(r.n_per_proc == res[0].n_per_proc for r in res)
    assert svc.keys_sorted == 3210 and svc.batches_dispatched == 1
    tele = svc.telemetry()
    assert tele["requests"] == 3 and tele["batches"] == 1 and sum(svc.stats.attempts.values()) >= 1
    assert {"lat_mean_ms", "lat_p50_ms", "lat_p99_ms"} <= set(tele)
    assert svc.flush() == {} and svc.pending == 0
    assert_same_counters(*pair)


@pytest.mark.parametrize("max_in_flight", [1, 2])
def test_service_max_batch_splits_into_multiple_fused_sorts(executors, max_in_flight):
    """Four requests of 300 under a cap of 650 make two fused sorts, at
    either pipeline depth, with the reference's bytes and counters."""
    pair = both(executors, max_batch_keys=650, max_in_flight=max_in_flight)
    arrays = [np.arange(300, dtype=np.int32)[::-1].copy() for _ in range(4)]
    rres, res = many_both(pair, arrays)
    assert_same_results(rres, res)
    assert pair[1].batches_dispatched == 2
    assert pair[1].telemetry()["dispatch"]["in_flight_peak"] == max_in_flight
    for a, r in zip(arrays, res):
        assert np.array_equal(r.keys, np.sort(a))
    assert_same_counters(*pair)


def test_pack_segments_layout_and_bounds():
    packed = pack_segments([np.arange(3, dtype=np.int32), np.arange(2, dtype=np.int32)], p=4, n_per_proc=8)
    assert packed.comp.shape == (4, 8) and packed.comp.dtype == np.int64
    assert packed.pos.shape == (4, 8) and packed.n_keys == 5
    real = packed.pos >= 0
    assert packed.comp[~real].min() > packed.comp[real].max()
    per_lane = real.sum(axis=1)
    assert per_lane.max() - per_lane.min() <= 1
    for k in range(4):
        assert real[k, : per_lane[k]].all()
    one = pack_segments([np.arange(5, dtype=np.int32)], p=4, n_per_proc=8)
    assert one.comp.dtype == np.int32 and (one.comp[one.pos < 0] == np.iinfo(np.int32).max).all()
    with pytest.raises(ValueError):
        pack_segments([np.zeros(100, np.int32)], p=2, n_per_proc=8)


def test_single_segment_int32_path_handles_max_key_collisions(executors):
    imax = np.iinfo(np.int32).max
    keys = np.concatenate([np.full(7, imax, np.int32), np.arange(50, dtype=np.int32)])
    res = sort_segments([keys], p=P, device="cpu")
    k, o = res.keys[0].numpy(), res.order[0].numpy()
    assert np.array_equal(k, np.sort(keys)) and np.array_equal(keys[o], k)
    assert (np.diff(o[k == imax]) > 0).all()
    pair = both(executors)
    assert_same_results(*[[svc.sort_one(keys)] for svc in pair])


def test_single_segment_batch_serves_on_cheap_sub_exact_tier(executors):
    """A balanced integer corpus takes the radix route, a range-skewed one
    the planner's sampled ``planned`` capacity, and a pin forces whp; in
    both packages alike."""
    lens = np.random.default_rng(11).integers(1, 5000, 999).astype(np.int32)
    skew = datagen.generate("zipf", 1, 999, seed=11)[0]
    for keys, cfg, tier in ((lens, {}, "radix"), (skew, {}, "planned"), (lens, dict(pair_capacity="whp"), "whp")):
        pair = both(executors, **cfg)
        rres, res = [svc.sort_one(keys) for svc in pair]
        assert_same_results([rres], [res])
        assert np.array_equal(res.keys, np.sort(keys)) and res.tier == tier
        assert pair[1].stats.retries == 0, pair[1].stats.as_row()
        assert_same_counters(*pair)


def test_flush_failsink_retries_failed_batch_without_losing_requests(executors, monkeypatch):
    def second_fails(orig):
        calls = {"n": 0}

        def launch(*args, **kw):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("boom")
            return orig(*args, **kw)

        return launch

    pair = both(executors, max_batch_keys=100)
    a = np.arange(80, dtype=np.int32)[::-1].copy()
    b = np.arange(90, dtype=np.int32)[::-1].copy()
    futs = [[svc.submit(a), svc.submit(b)] for svc in pair]
    patch_launch(monkeypatch, second_fails)
    for svc, (fa, fb) in zip(pair, futs):
        assert set(svc.flush()) == {fa.rid, fb.rid}
        assert svc.dispatcher.failsink_solo_retries == 1 and svc.dispatcher.failsink_errors == 0
    assert_same_outcomes(*futs)
    svc, (fut_a, fut_b) = pair[1], futs[1]
    res_b = svc.take_result(fut_b)
    assert res_b.failsink and fut_b.failsink and np.array_equal(res_b.keys, np.arange(90, dtype=np.int32))
    assert not svc.take_result(fut_a).failsink
    assert_same_counters(*pair)


def test_datagen_zipf_keys_and_sizes():
    ref = reference()
    z = datagen.generate("zipf", 4, 500, seed=3)
    assert z.shape == (4, 500) and z.dtype == np.int32 and z.min() >= 1
    assert np.array_equal(z, ref.datagen.generate("zipf", 4, 500, seed=3))
    assert np.unique(z, return_counts=True)[1].max() / z.size > 0.2
    s = datagen.zipf_sizes(32, 4096, seed=21)
    assert np.array_equal(s, ref.datagen.zipf_sizes(32, 4096, seed=21))
    assert s.sum() == 4096 and s.min() >= 1 and len(s) == 32 and s.max() / s.min() > 8
    for total in (64, 65, 80):
        t = datagen.zipf_sizes(64, total, seed=0)
        assert t.sum() == total and t.min() >= 1
        assert np.array_equal(t, ref.datagen.zipf_sizes(64, total, seed=0))


@pytest.mark.parametrize("corrupt", [False, True])
def test_stream_submits_fold_like_the_reference_and_the_cold_sort(executors, corrupt):
    """``submit(stream=)``: the first submit installs the stream's view, the
    next fold into it; with ``corrupt_folds=(0,)`` the first fold is
    corrupted and falls back to a resort. Every result is the reference's
    and equals a cold stable sort of the stream so far. The order (arrival
    indices) is int64 in the port; the reference's fold narrows it to int32
    (JAX's default 32-bit mode), so its values are compared."""
    chaos = dict(corrupt_folds=(0,)) if corrupt else None
    pair = service_pair(*executors, chaos=chaos, p=4)
    rng = np.random.default_rng(17)
    batches = [rng.integers(0, 5000, n).astype(np.int32) for n in (600, 64, 40)]
    hist = []
    for b in batches:
        rres, res = [svc.submit(b, stream="s").result() for svc in pair]
        assert (res.rid, res.tier, res.n_per_proc) == (rres.rid, rres.tier, rres.n_per_proc)
        assert res.keys.dtype == rres.keys.dtype and res.keys.tobytes() == rres.keys.tobytes()
        # the arrival indices are int64 in both; the reference's fold merges
        # them in JAX's default 32-bit mode, which narrows them to int32
        assert np.array_equal(res.order, rres.order)
        hist.append(b)
        cat = np.concatenate(hist)
        assert np.array_equal(res.keys, np.sort(cat)) and res.order.dtype == np.int64
        assert np.array_equal(res.order, np.argsort(cat, kind="stable"))
    assert [r.tier for r in (rres, res)] == ["delta", "delta"]
    if corrupt:
        assert pair[1].cfg.chaos.injected == pair[0].cfg.chaos.injected == {"fold_corruption": 1}
    views = [svc.dispatcher._stream_views["s"] for svc in pair]
    r = ref_service()
    fallbacks = [
        {str(lbl["view"]): c.value for lbl, c in reg.collect("delta.fold_fallback_resorts")}.get(v.label, 0)
        for reg, v in zip((r.obs.metrics(), obs.metrics()), views)
    ]
    assert fallbacks == [int(corrupt)] * 2
    assert_same_counters(*pair)


def test_service_config_matches_the_reference_and_converts():
    r = ref_service()
    ref_fields = [(f.name, f.default, f.compare) for f in dataclasses.fields(r.service.ServiceConfig)]
    assert [(f.name, f.default, f.compare) for f in dataclasses.fields(ServiceConfig)] == ref_fields
    rcfg = r.service.ServiceConfig(p=16, algorithm="det", pair_capacity="whp", merge="tree", max_batch_keys=4096,
                                   max_in_flight=3, breaker_threshold=2,
                                   chaos=r.chaos.FaultPlan(seed=4, poison_rids=(3,)))
    cfg = service_config_from_reference(rcfg)
    assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "chaos"} == {
        f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg) if f.name != "chaos"}
    assert cfg.chaos.poison_rids == (3,) and type(cfg.chaos).__module__ == "repro_torch.chaos.plan"
    with pytest.raises(ValueError, match="obs"):
        service_config_from_reference(r.service.ServiceConfig(obs=object()))
    with pytest.raises(ValueError, match="pair_capacity"):
        SortService(ServiceConfig(pair_capacity="planned"), device="cpu")


def test_service_without_a_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SortService(ServiceConfig(p=4))


@pytest.mark.cuda
def test_service_on_the_card_equals_the_cpu_service():
    """A small service on the card gives the CPU service's bytes, tiers and
    counters (both draw the same samples from CPU generators)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sizes = datagen.zipf_sizes(32, 1 << 14, seed=21)
    arrays = [datagen.generate(m, 1, int(s), seed=100 + i)[0]
              for i, (m, s) in enumerate(zip(["U", "G", "DD", "zipf"] * 8, sizes))]
    out = []
    for device in ("cuda", "cpu"):
        svc = SortService(ServiceConfig(p=8, max_batch_keys=1 << 12), executor=SortExecutor(), device=device)
        futs = [svc.submit(a) for a in arrays]
        svc.flush()
        out.append((svc, futs))
    assert_same_outcomes(out[1][1], out[0][1])
    assert_same_counters(out[1][0], out[0][0])
