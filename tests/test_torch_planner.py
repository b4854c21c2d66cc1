"""``repro_torch.planner`` and the planned sorts, against the JAX package.

The planner is host code copied from ``repro.planner``, so on the same
numpy inputs every ``Fingerprint`` field, every planned capacity and ω,
and every ``PlanDecision`` of a plan/observe/record sequence (promotions
and probes included) must be the reference's exactly, on the U, G, B, DD
and zipf mixes at the sizes of ``benchmarks/tables.py``'s
``table_planner`` (cut to p = 8 and at most 2^16 keys). Histories written
by either package load into the other and plan alike. A planned segmented
sort (fingerprint → plan → pack with the plan's layout → sort with its
overrides → record) must give the reference's per-segment keys and order,
start tier and ``TierStats``; its randomized sample is fed the
reference's own draws (the reference draws from ``jax.random``), so both
walk the same rungs. ``bsp_sort_safe(planner=...)`` must slice the same
ladder. Tolerance: exact.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.core import SortExecutor, TierStats, bsp_sort_safe, datagen, gathered_output
from repro_torch.core import api as port_api
from repro_torch.core.convert import planner_from_reference
from repro_torch.core.segmented import pack_segments, segmented_sort_safe
from repro_torch.planner import (
    CapacityPlanner,
    bucket_key,
    fingerprint_arrays,
    lane_spread,
    planned_cap_for,
    radix_share,
    sampled_dup_fraction,
    sampled_sortedness,
    segment_aware_pair_cap,
    solve_omega,
)
from test_torch_harness import adversarial, config_fields, reference, x64

P = 8
MIXES = ["U", "G", "B", "DD", "zipf"]


def sort_overrides(d):
    """The segmented sort's overrides for a plan, as the JAX package's
    service dispatcher builds them (``service/dispatch.py:605-617``)."""
    ov = {"pair_capacity": d.pair_capacity}
    if d.route == "radix":
        ov["route"] = "radix"
    elif d.pair_capacity == "planned":
        ov.update(pair_cap_override=d.pair_cap_override, omega=d.omega)
    return ov


def ref_planner():
    reference()
    import repro.planner

    return repro.planner


def zipf_mix(mix: str, n_req: int, total: int, seed: int):
    """``table_planner``'s batches: Zipf sizes, each request one draw of the mix."""
    sizes = datagen.zipf_sizes(n_req, total, seed=seed)
    return [datagen.generate(mix, 1, int(s), seed=seed * 100 + i)[0] for i, s in enumerate(sizes)]


def batches():
    """(name, arrays): fused multi-segment mixes, single segments, a
    near-sorted stream, a few-segment skewed batch, and over 512 segments
    (the coarse bound's sweep)."""
    out = [(f"{m} x16", zipf_mix(m, 16, 2048, s)) for m in MIXES for s in (0, 1)]
    out += [(f"{m} x64", zipf_mix(m, 64, 1 << 14, 21)) for m in MIXES]
    out += [(f"{m} single", [datagen.generate(m, 1, 3000, seed=4)[0]]) for m in MIXES]
    out += [("near-sorted", [datagen.near_sorted(4096, 0.02, "scattered", seed=13)]),
            ("skewed", [np.arange(2048, dtype=np.int32)] + [np.arange(64, dtype=np.int32)] * 7),
            ("600 tiny", [np.full(3, i, np.int32) for i in range(600)]),
            ("float keys", [np.linspace(0, 1, 500, dtype=np.float32), np.ones(30, np.float32)])]
    return out


BATCHES = batches()


@pytest.mark.parametrize("name,arrays", BATCHES, ids=[b[0] for b in BATCHES])
def test_fingerprint_and_capacity_match_reference(name, arrays):
    rp = ref_planner()
    fp, rfp = fingerprint_arrays(arrays, P), rp.fingerprint_arrays(arrays, P)
    assert dataclasses.asdict(fp) == dataclasses.asdict(rfp)
    assert (fp.dup_fraction, fp.pad_keys, fp.n_segments) == (rfp.dup_fraction, rfp.pad_keys, rfp.n_segments)
    assert bucket_key(fp) == rp.bucket_key(rfp)
    for single in (False, True):
        assert planned_cap_for(fp, single_segment=single) == rp.planned_cap_for(rfp, single_segment=single)
    sizes = [len(a) for a in arrays]
    assert lane_spread(sizes, P) == rp.lane_spread(sizes, P)
    for kw in (dict(), dict(dup_fractions=fp.dup_fractions, pad_dup=1.0),
               dict(omega=2.5, dup_fractions=[0.5] * len(sizes))):
        assert segment_aware_pair_cap(sizes, P, fp.n_per_proc, **kw) == \
            rp.segment_aware_pair_cap(sizes, P, fp.n_per_proc, **kw)
    assert solve_omega(sizes, P, fp.n_per_proc, grid=(1.0, 3.0)) == \
        rp.solve_omega(sizes, P, fp.n_per_proc, grid=(1.0, 3.0))


def test_sampling_helpers_match_reference():
    rp = ref_planner()
    for x in (datagen.generate("DD", 1, 5000, seed=2)[0], np.arange(40, dtype=np.int32),
              datagen.near_sorted(3000, 0.1, "rotated", seed=1), np.zeros(0, np.int32), np.ones(1, np.int32)):
        assert sampled_dup_fraction(x, seed=3) == rp.sampled_dup_fraction(x, seed=3)
        assert sampled_sortedness(x, seed=3) == rp.sampled_sortedness(x, seed=3)
    samples = [np.arange(100, dtype=np.int32) * 7, np.full(5, -3, np.int32)]
    assert radix_share(samples, [100, 5], P) == rp.radix_share(samples, [100, 5], P)
    assert radix_share(samples[:1], [100], P) == rp.radix_share(samples[:1], [100], P)


def decision_row(d):
    return (d.bucket, d.layout, d.pair_capacity, d.pair_cap_override, d.omega, d.rung, d.route, d.start_tier)


def test_plan_observe_record_sequence_matches_reference():
    """The same traffic and outcomes through both planners: the same
    decisions step by step, promotions and probes included."""
    rp = ref_planner()
    kw = dict(fault_target=0.05, min_attempts=3, probe_after=4)
    pl, rpl = CapacityPlanner(**kw), rp.CapacityPlanner(**kw)
    rng = np.random.default_rng(5)
    traffic = [b for _, b in BATCHES[:12]] + [b for _, b in BATCHES[15:22]]
    for step in range(60):
        arrays = traffic[step % len(traffic)]
        d, rd = pl.plan(arrays, P), rpl.plan(arrays, P)
        assert decision_row(d) == decision_row(rd), step
        faulted = bool(rng.random() < (0.8 if step < 30 else 0.0))
        pl.record(d, faulted)
        rpl.record(rd, faulted)
        pl.observe("sort/iran/p8/npp64/whp", faulted, 4)
        rpl.observe("sort/iran/p8/npp64/whp", faulted, 4)
        assert pl.history == rpl.history, step
    t, rt = pl.telemetry(), rpl.telemetry()
    assert t == rt and t["promotions"] > 0 and t["probes"] > 0 and t["radix_plans"] > 0 and t["delta_plans"] > 0
    assert json.loads(pl.to_json()) == json.loads(rpl.to_json())


def test_history_round_trips_between_packages(tmp_path):
    rp = ref_planner()
    path = str(tmp_path / "history.json")
    rpl = rp.CapacityPlanner(path=path, min_attempts=2)
    for _ in range(3):
        rpl.observe("hot", True)
    rpl.observe("cold", False)
    rpl.save()
    pl = planner_from_reference(path, min_attempts=2)
    assert pl.history == rpl.history and pl.history["hot"]["rung"] == 1
    same = planner_from_reference(rpl.to_json())
    assert same.history == rpl.history
    arrays = BATCHES[0][1]
    b = rp.bucket_key(rp.fingerprint_arrays(arrays, P))
    for h in (rpl.history, pl.history):
        h[b] = {"rung": 1, "attempts": 0, "faults": 0, "clean": 0}
    assert decision_row(pl.plan(arrays, P)) == decision_row(rpl.plan(arrays, P))
    # the port saves over the reference's file: merge-on-save pools both
    pl.observe("cold", False)
    pl.observe("warm", True)
    pl.save()
    back = rp.CapacityPlanner(path=path)
    assert back.history == pl.history and back.history["cold"]["attempts"] == 2
    other = rp.CapacityPlanner(path=path)
    other.observe("cold", False)
    other.save()
    pl.observe("cold", False)
    pl.save()  # folds the reference's delta in
    assert CapacityPlanner(path=path).history["cold"]["attempts"] == 4
    assert not pl.save_if_dirty() and CapacityPlanner().save_if_dirty() is False


def test_corrupt_history_warns_and_starts_fresh(tmp_path):
    path = tmp_path / "history.json"
    for text in ("{ not json", json.dumps({"version": 1, "buckets": {"b": {"rung": 1}}}),
                 json.dumps({"version": 99, "buckets": {}})):
        path.write_text(text)
        with pytest.warns(UserWarning, match="unusable"):
            assert CapacityPlanner(path=str(path)).history == {}


def reference_draws(monkeypatch, scope_x64: bool):
    """Make the port's randomized sorts draw the reference's sample: rung r
    takes the positions ``random_sample`` draws under ``fold_in(key(seed), r)``
    (the draw depends on the shape and the key only)."""
    import jax
    import jax.numpy as jnp

    ref = reference()
    from repro.core import splitters
    from repro.core.types import AXIS

    def positions(cfg, rung, generator, device):
        if cfg.algorithm not in ("iran", "ran") or cfg.route == "radix":
            return None
        fields = {k: v for k, v in config_fields(cfg).items() if k != "obs"}
        rcfg = ref.SortConfig(**fields)
        with x64(scope_x64):
            rng = jax.random.fold_in(jax.random.key(cfg.seed), rung)
            xs = jnp.zeros((cfg.p, cfg.n_per_proc), jnp.int32)
            pos = jax.vmap(lambda r: splitters.random_sample(r, rcfg, AXIS, rng)[2], axis_name=AXIS)(xs)
            return torch.from_numpy(np.array(pos)).to(device)

    monkeypatch.setattr(port_api, "_positions", positions)


PLANNED_MIXES = [(m, n) for m in MIXES for n in (16, 64)] + [("U", 1), ("skewed", 8)]


@pytest.mark.parametrize("mix,n_req", PLANNED_MIXES, ids=[f"{m}-{n}" for m, n in PLANNED_MIXES])
def test_planned_segmented_sort_matches_reference(mix, n_req, monkeypatch):
    rp = ref_planner()
    from repro.core import segmented as rseg

    if mix == "skewed":
        arrays = BATCHES[-3][1]
    elif n_req == 1:
        arrays = [datagen.generate(mix, 1, 5000, seed=3)[0]]
    else:
        arrays = zipf_mix(mix, n_req, 1 << 14 if n_req == 64 else 4096, 21)
    reference_draws(monkeypatch, len(arrays) > 1)
    pl, rpl = CapacityPlanner(), rp.CapacityPlanner()
    for _ in range(2):  # twice through one planner, as the card run does
        d, rd = pl.plan(arrays, P), rpl.plan(arrays, P)
        assert decision_row(d) == decision_row(rd)
        ov = sort_overrides(d)
        with x64(len(arrays) > 1):
            rpk = rseg.pack_segments(arrays, P, layout=rd.layout)
            want = rseg.segmented_sort_safe(rpk, merge="tree", merge_backend="pallas", **ov)
        got = segmented_sort_safe(pack_segments(arrays, P, layout=d.layout), merge="tree", merge_backend="pallas",
                                  device="cpu", **ov)
        for r, (wk, wo, gk, go) in enumerate(zip(want.keys, want.order, got.keys, got.order)):
            assert np.array_equal(np.asarray(wk), gk.numpy()) and np.array_equal(np.asarray(wo), go.numpy()), r
        assert (got.tier, got.n_per_proc, got.stats.as_row()) == (want.tier, want.n_per_proc, want.stats.as_row())
        pl.record(d, got.stats.retries > 0)
        rpl.record(rd, want.stats.retries > 0)
        assert pl.history == rpl.history


def test_planned_cap_is_sub_exact_on_the_planner_mixes():
    """The planner's point: striped multi-segment batches start below exact."""
    for m in MIXES:
        arrays = zipf_mix(m, 16, 4096, 21)
        d = CapacityPlanner().plan(arrays, P)
        assert d.layout == "striped" and d.start_tier == "planned", (m, d)
        assert d.pair_cap_override < fingerprint_arrays(arrays, P).n_per_proc


@pytest.mark.parametrize("algorithm", ["det", "iran"])
def test_bsp_sort_safe_planner_slices_the_same_ladder(algorithm, monkeypatch):
    """A shape whose whp rung keeps faulting starts one rung up, in both
    packages, from the same history."""
    import jax.numpy as jnp

    ref = reference()
    rp = ref_planner()
    reference_draws(monkeypatch, False)
    p, n_p = 8, 64
    adv = (adversarial(p, n_p) * 1048).astype(np.int32)
    kw = dict(fault_target=0.05, min_attempts=2)
    pl, rpl = CapacityPlanner(**kw), rp.CapacityPlanner(**kw)
    ex, rex = SortExecutor(), ref.SortExecutor()
    for _ in range(4):
        res, _, st = bsp_sort_safe(adv, algorithm=algorithm, pair_capacity="whp", planner=pl, executor=ex,
                                   stats=TierStats(), device="cpu")
        _, _, rst = ref.bsp_sort_safe(jnp.asarray(adv), ref.SortConfig(p=p, n_per_proc=n_p, algorithm=algorithm,
                                                                       pair_capacity="whp"),
                                      planner=rpl, executor=rex, stats=ref.TierStats())
        assert st.as_row() == rst.as_row() and pl.history == rpl.history
        assert torch.equal(gathered_output(res), torch.sort(torch.from_numpy(adv).flatten()).values)
    bucket = f"sort/{algorithm}/p{p}/npp{n_p}/whp"
    assert pl.history[bucket]["rung"] >= 1
    st = TierStats()
    bsp_sort_safe(adv, algorithm=algorithm, pair_capacity="whp", planner=pl, executor=ex, stats=st, device="cpu")
    assert "whp" not in st.attempts


def test_executor_entries_bounded_and_replayed_under_planned_traffic():
    """Planned capacities are quantized, so replayed traffic builds no new
    executor entry."""
    ex = SortExecutor()
    pl = CapacityPlanner()

    def soak():
        for seed in range(6):
            arrays = zipf_mix(["U", "DD", "zipf"][seed % 3], [4, 16, 16][seed % 3], 1024 + 128 * (seed % 5), seed)
            d = pl.plan(arrays, P)
            res = segmented_sort_safe(pack_segments(arrays, P, layout=d.layout), executor=ex, device="cpu",
                                      generator=torch.Generator().manual_seed(seed), **sort_overrides(d))
            pl.record(d, res.stats.retries > 0)

    soak()
    counts = dict(ex.trace_counts)
    shapes = {k[2].n_per_proc for k in counts}
    assert sum(k[0] == "route" for k in counts) <= len(shapes) * 12
    assert sum(k[0] == "prepare" for k in counts) <= len(shapes) * 2
    soak()
    assert dict(ex.trace_counts) == counts
