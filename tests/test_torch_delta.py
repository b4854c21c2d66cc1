"""``repro_torch.delta`` — the fold and the sorted view — against the JAX package.

The invariants of the JAX package's ``tests/test_delta.py``, held against
``repro.delta`` on the same numpy inputs: the host split and the
composite lift are equal; ``merge_sorted_runs`` gives equal bytes for
int32, int64 and float32 runs with payloads under both merge substrates
(``pallas`` takes the rank kernel's plain version on the CPU);
``near_sorted_sort`` equals the reference and a cold ``bsp_sort_safe`` of
the stream; and sequences of ``SortedView`` folds, resorts, deletes,
updates and pops leave both views in the same state, a snapshot of the
reference's view installed into the port's included. Payloads are int32
and float32 outside the reference's 64-bit scope (JAX's default mode
narrows int64 ones there). Tolerance: exact.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import TierStats, bsp_sort_safe, datagen, gathered_output, view_from_reference
from repro_torch.delta import (
    SortedView,
    drop_positions,
    lift_positions,
    merge_sorted_runs,
    near_sorted_sort,
    near_sorted_sort_launch,
    split_sorted_run,
)
from repro_torch.planner import CapacityPlanner
from test_torch_harness import assert_same, reference, x64

P = 8
PATTERNS = ("appended", "scattered", "rotated")


def ref_delta():
    reference()
    import repro.delta

    return repro.delta


def stream(dist: str, n: int, seed: int = 0) -> np.ndarray:
    return datagen.generate(dist, 1, n, seed=seed)[0]


def test_near_sorted_generator_matches_reference():
    ref = reference()
    assert datagen.NEAR_SORTED_PATTERNS == ref.datagen.NEAR_SORTED_PATTERNS == PATTERNS
    for pattern in PATTERNS:
        assert_same(ref.datagen.near_sorted(4096, 0.05, pattern, seed=3),
                    datagen.near_sorted(4096, 0.05, pattern, seed=3))


@pytest.mark.parametrize("pattern", PATTERNS)
def test_split_sorted_run_matches_reference(pattern):
    rd = ref_delta()
    x = datagen.near_sorted(4096, 0.02, pattern, seed=5)
    for got, want in zip(split_sorted_run(x), rd.split_sorted_run(x)):
        assert_same(want, got)
    kept, delta = split_sorted_run(x)
    assert np.array_equal(np.sort(np.concatenate([kept, delta])), np.arange(4096))
    assert np.all(np.diff(x[kept].astype(np.int64)) >= 0)


def test_split_sorted_run_edges_and_planted_extreme():
    rd = ref_delta()
    x = np.sort(np.random.default_rng(0).integers(0, 2**20, 2048)).astype(np.int32)
    x[10] = np.iinfo(np.int32).max
    for arr in (x, np.array([], np.int32), np.array([7], np.int32), np.full(9, 3, np.int32)):
        for got, want in zip(split_sorted_run(arr), rd.split_sorted_run(arr)):
            assert_same(want, got)
    assert 10 in split_sorted_run(x)[1]


def test_lift_and_drop_match_reference():
    rd = ref_delta()
    rng = np.random.default_rng(1)
    keys = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max, 512, dtype=np.int64).astype(np.int32)
    keys[::7] = keys[0]
    pos = np.arange(512, dtype=np.int64)
    comp = lift_positions(keys, pos)
    assert_same(rd.lift_positions(keys, pos), comp)
    srt = np.sort(comp)
    for got, want in zip(drop_positions(srt), rd.drop_positions(srt)):
        assert_same(want, got)
    for got, want in zip(drop_positions(torch.from_numpy(srt)), rd.drop_positions(srt)):
        assert_same(want, got)
    assert np.array_equal(drop_positions(srt)[1], np.argsort(keys, kind="stable"))


def runs(dtype: str, na: int, nb: int, seed: int = 2):
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        choice = np.asarray([-0.0, 0.0, 1.5, -2.0, 7.25, np.inf], np.float32)
        a, b = (np.sort(choice[rng.integers(0, 6, n)]) for n in (na, nb))
    elif dtype == "int64":
        a, b = (np.sort(rng.integers(-(2**62), 2**62, n, dtype=np.int64) // 1000 * 1000) for n in (na, nb))
        if na:
            a[-1] = np.iinfo(np.int64).max  # a real key equal to the pad
    else:
        a, b = (np.sort(rng.integers(0, 1000, n)).astype(np.int32) for n in (na, nb))
    # int64 payloads only in the 64-bit scope: outside it the reference
    # narrows them to int32 (JAX's default mode), which torch does not
    it = np.int64 if dtype == "int64" else np.int32
    av = (np.arange(na, dtype=it), rng.standard_normal(na).astype(np.float32))
    bv = (np.arange(na, na + nb, dtype=it), rng.standard_normal(nb).astype(np.float32))
    return a, b, av, bv


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["int32", "int64", "float32"])
@pytest.mark.parametrize("na,nb", [(300, 170), (2048, 9), (1, 1000), (0, 40), (40, 0), (0, 0)])
def test_merge_sorted_runs_matches_reference(dtype, backend, na, nb):
    rd = ref_delta()
    a, b, av, bv = runs(dtype, na, nb)
    with x64(dtype == "int64"):
        want, wvals = rd.merge_sorted_runs(a, b, av, bv, backend=backend)
    got, gvals = merge_sorted_runs(a, b, av, bv, backend=backend, device="cpu")
    assert_same(want, got, "keys")
    for w, g in zip(wvals, gvals):
        assert_same(w, g, "payload")
    cat = np.concatenate([a, b])
    assert np.array_equal(got.numpy(), cat[np.argsort(cat, kind="stable")])


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_near_sorted_sort_matches_reference_and_cold_sort(pattern, backend):
    rd = ref_delta()
    x = datagen.near_sorted(4096, 0.02, pattern, seed=11)
    st = TierStats()
    got = near_sorted_sort(x, P, stats=st, backend=backend, device="cpu")
    with x64():
        want = rd.near_sorted_sort(x, P, backend=backend)
    assert got.tier == want.tier == "delta" and got.n_per_proc == want.n_per_proc
    assert st.retries == 0 and st.as_row() == want.stats.as_row()
    assert_same(want.keys[0], got.keys[0], "keys")
    assert_same(want.order[0], got.order[0], "order")
    res, _, _ = bsp_sort_safe(x.reshape(P, -1), algorithm="det", device="cpu")
    assert torch.equal(got.keys[0], gathered_output(res))
    assert np.array_equal(got.order[0].numpy(), np.argsort(x, kind="stable"))


def test_sorted_stream_folds_nothing():
    x = np.arange(1000, dtype=np.int32)
    flight = near_sorted_sort_launch(x, P, device="cpu")
    assert flight.flight is None and flight.done()
    res = flight.wait()
    assert torch.equal(res.keys[0], torch.from_numpy(x)) and res.stats.attempts == {}


def views(**kw):
    return SortedView(p=P, device="cpu", **kw), ref_delta().SortedView(p=P, **kw)


def assert_views_equal(view, rview, what=""):
    assert_same(rview.keys, view.keys, f"{what} keys")
    assert len(view.payloads) == len(rview.payloads)
    for w, g in zip(rview.payloads, view.payloads):
        assert_same(w, g, f"{what} payload")
    assert (view.last_tier, view.last_n_per_proc) == (rview.last_tier, rview.last_n_per_proc), what


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("dist", ["U", "G", "B", "DD", "zipf"])
def test_sorted_view_sequences_match_reference(dist, backend):
    view, rview = views(merge_backend=backend)
    base = stream(dist, 2048, seed=4)
    pos = np.arange(4096, dtype=np.int32)
    steps = [("fold", base, (pos[:2048],)), ("fold", stream(dist, 128, seed=9), (pos[2048:2176],)),
             ("delete", stream(dist, 40, seed=3), None), ("fold", stream(dist, 300, seed=8), (pos[2176:2476],)),
             ("update", stream(dist, 30, seed=2), (pos[-30:],)), ("pop", None, None),
             ("fold", stream(dist, 900, seed=7), (pos[2476:3376],)), ("fold_forced", stream(dist, 16, 1), (pos[:16],)),
             ("resort_forced", stream(dist, 16, 5), (pos[16:32],)), ("fold", np.zeros(0, np.int32), (pos[:0],))]
    for i, (op, arg, pls) in enumerate(steps):
        if op.startswith("fold") or op.startswith("resort"):
            route = {"fold_forced": "fold", "resort_forced": "resort"}.get(op)
            assert view.fold(arg, pls, route=route) == rview.fold(arg, pls, route=route), i
        elif op == "delete":
            assert view.delete(arg) == rview.delete(arg)
        elif op == "update":
            assert view.update(arg, pls) == rview.update(arg, pls)
        else:
            k, v = view.pop_min()
            rk, rv = rview.pop_min()
            assert (k, v) == (int(rk), tuple(x.item() for x in rv))
        assert_views_equal(view, rview, f"step {i} {op}")
    assert view.stats.as_row() == rview.stats.as_row()
    c, rc = view.clone(), rview.clone()
    c.fold(stream(dist, 64, seed=30), (pos[:64],))
    rc.fold(stream(dist, 64, seed=30), (pos[:64],))
    assert_views_equal(c, rc, "clone")
    assert_views_equal(view, rview, "original after clone's fold")


def test_fold_equals_resort_and_cold_sort():
    base = np.sort(stream("zipf", 2048, seed=4))
    delta = stream("zipf", 128, seed=9)
    cat = np.concatenate([base, delta])
    fold_view, resort_view = SortedView(p=P, device="cpu"), SortedView(p=P, device="cpu")
    assert fold_view.fold(base) == "resort" and fold_view.fold(delta) == "fold"
    resort_view.fold(base)
    assert resort_view.fold(delta, route="resort") == "resort"
    assert torch.equal(fold_view.keys, resort_view.keys)
    assert np.array_equal(fold_view.keys.numpy(), np.sort(cat))
    big = SortedView(p=P, device="cpu", fold_max_share=0.25)
    big.fold(base)
    assert big.fold(stream("U", 1000, seed=3)) == "resort"
    with pytest.raises(ValueError):
        big.fold(delta, route="sideways")
    with pytest.raises(ValueError):
        big.install(np.array([3, 1], np.int32))
    with pytest.raises(ValueError):
        big.fold(delta, (np.zeros(128),))


def test_view_counters_and_trace_spans():
    from repro_torch import obs

    t = obs.Tracer()
    view = SortedView(p=P, device="cpu", obs_handle=t)
    view.fold(np.sort(stream("U", 512, seed=1)))
    view.fold(stream("U", 32, seed=2))
    view.delete(np.array([view.keys[0].item(), 12345], np.int32))
    snap = obs.metrics().snapshot()
    lab = view.label
    assert snap[f"delta.folds{{view={lab}}}"] == 1 and snap[f"delta.resorts{{view={lab}}}"] == 1
    assert snap[f"delta.tombstones{{view={lab}}}"] == 1 and snap[f"delta.tombstone_misses{{view={lab}}}"] == 1
    assert [s["args"]["route"] for s in t.spans if s["name"] == "fold"] == ["resort", "fold"]
    assert any(s["name"] == "tombstone" for s in t.spans) and t.route_spans()


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_reference_snapshot_installs_and_folds_alike(backend):
    """A snapshot of the reference's view (numpy keys and payloads) carried
    into the port's view folds to the same bytes."""
    rview = ref_delta().SortedView(p=P, merge_backend=backend)
    rview.fold(stream("DD", 3000, seed=6), (np.arange(3000, dtype=np.int32),))
    rview.delete(stream("DD", 50, seed=7))
    view = view_from_reference(rview.keys, rview.payloads, p=P, device="cpu", merge_backend=backend)
    delta = stream("DD", 200, seed=8)
    pls = (np.arange(200, dtype=np.int32) + 5000,)
    assert view.fold(delta, pls) == rview.fold(delta, pls) == "fold"
    assert_same(rview.keys, view.keys, "keys")
    assert_same(rview.payloads[0], view.payloads[0], "payload")


def test_planner_routes_near_sorted_to_delta():
    planner = CapacityPlanner()
    x = datagen.near_sorted(2048, 0.02, "scattered", seed=13)
    assert planner.plan([x], P).route == "delta" and planner.plan([x], P).start_tier == "delta"
    assert planner.delta_plans >= 1
    assert planner.plan([stream("U", 2048, seed=14)], P).route != "delta"
    assert planner.plan([datagen.near_sorted(256, 0.02, "scattered", seed=15)], P).route != "delta"
    assert planner.plan([np.sort(stream("U", 1024, seed=16)) for _ in range(2)], P).route != "delta"
