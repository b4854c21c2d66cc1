"""SORT_DET_BSP end to end: the port's ``bsp_sort_safe`` is byte-identical to
the JAX package's — buf, count, overflow, payloads and the tiers walked.

This file holds the slice's own configuration (bitonic Ph2, tree merge on
the kernel substrate, w.h.p. capacity) over every input distribution, and
the route stage alone fed the reference's prepared state. The covering
grid over the other axes is ``test_torch_sort_grid.py``. All keys are
integers, so the tolerance is exact.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro_torch.core import (
    bsp_sort,
    bsp_sort_safe,
    config_from_reference,
    datagen,
    gathered_output,
    prepared_from_reference,
)
from repro_torch.core.sort_det import prepare_det_spmd, route_det_spmd
from test_torch_harness import adversarial, assert_same, config_fields, reference

SLICE = dict(
    algorithm="det", local_sort="bitonic", merge="tree", merge_backend="pallas",
    pair_capacity="whp",
)
P, NP = 8, 512


def make_input(dist: str, p: int, n_p: int) -> np.ndarray:
    return adversarial(p, n_p) if dist == "adversarial" else datagen.generate(dist, p, n_p)


def payloads(p: int, n_p: int, n_values: int):
    vals = [np.arange(p * n_p, dtype=np.int32).reshape(p, n_p)]
    if n_values > 1:
        rng = np.random.default_rng(7)
        vals.append(rng.standard_normal((p, n_p, 2)).astype(np.float32))
    return vals[:n_values]


def check_against_reference(x, cfg_kw: dict, n_values: int) -> dict:
    """Run both packages' overflow-safe drivers; assert byte identity."""
    import jax.numpy as jnp

    ref = reference()
    p, n_p = x.shape
    vals = payloads(p, n_p, n_values)
    rcfg = ref.SortConfig(p=p, n_per_proc=n_p, **cfg_kw)
    rres, rvals, rstats = ref.bsp_sort_safe(
        jnp.asarray(x), rcfg, values=[jnp.asarray(v) for v in vals]
    )
    pcfg = config_from_reference(config_fields(rcfg))
    res, pvals, stats = bsp_sort_safe(x, pcfg, values=vals, device="cpu")
    assert_same(rres.buf, res.buf, "buf")
    assert_same(rres.count, res.count, "count")
    assert_same(rres.overflow, res.overflow, "overflow")
    assert len(pvals) == len(rvals) == n_values
    for i, (rv, pv) in enumerate(zip(rvals, pvals)):
        assert_same(rv, pv, f"payload {i}")
    assert stats.as_row() == rstats.as_row()
    assert stats.last_tier == rstats.last_tier
    out = gathered_output(res).numpy()
    assert np.array_equal(out, np.sort(x.ravel(), kind="stable"))
    if n_values:
        order = np.argsort(x.ravel(), kind="stable")
        got = np.concatenate([pvals[0][k, : int(res.count[k])].numpy() for k in range(p)])
        assert np.array_equal(got, vals[0].ravel()[order])
    return stats.as_row()


@pytest.mark.parametrize("n_values", [0, 1])
@pytest.mark.parametrize("dist", ["U", "G", "B", "DD", "WR", "zipf", "adversarial"])
def test_slice_config_matches_reference(dist, n_values):
    row = check_against_reference(make_input(dist, P, NP), SLICE, n_values)
    if dist == "adversarial":
        assert [k for k in row if k.startswith("tier_")] == ["tier_whp", "tier_whp2", "tier_exact"]
        assert row["ok_exact"] == 1 and row["retries"] == 2


@pytest.mark.parametrize("dist", ["U", "DD"])
def test_route_stage_on_reference_prepared_state(dist):
    """Carry the reference's PreparedSort across; every rung's route stage
    (Ph4–Ph6) and the port's own prepare stage are byte-identical."""
    import jax
    import jax.numpy as jnp

    ref = reference()
    from repro.core.api import SortExecutor

    x = make_input(dist, P, NP)
    vals = payloads(P, NP, 1)
    rcfg = ref.SortConfig(p=P, n_per_proc=NP, **SLICE)
    ex = SortExecutor()
    rprep = ex.prepare_vmap(rcfg, 1)(jnp.asarray(x), jnp.asarray(vals[0]))
    prep = prepared_from_reference(
        np.asarray(rprep.xs), [np.asarray(v) for v in rprep.vals],
        [np.asarray(s) for s in rprep.splits], device="cpu",
    )
    own = prepare_det_spmd(
        prep.xs.new_tensor(x), config_from_reference(config_fields(rcfg)),
        [prep.xs.new_tensor(vals[0])],
    )
    assert_same(rprep.xs, own.xs, "prepared xs")
    assert_same(rprep.vals[0], own.vals[0], "prepared vals")
    for r, o in zip(rprep.splits, own.splits):
        assert_same(r, o, "splitters")
    rng = jax.random.key_data(jax.random.key(0))
    for _, rtier in rcfg.tier_ladder():
        rbuf, rvbufs, rcount, rover = ex.route_vmap(rtier, 1)(rprep, rng)
        buf, vbufs, count, over = route_det_spmd(prep, config_from_reference(config_fields(rtier)))
        assert_same(rbuf, buf, "route buf")
        assert_same(rvbufs[0], vbufs[0], "route payload")
        assert_same(rcount, count, "route count")
        assert_same(rover, over, "route overflow")


def test_bsp_sort_one_tier_matches_reference():
    """The single-tier entry point, including a faulted (overflowing) run."""
    import jax.numpy as jnp

    ref = reference()
    x = make_input("adversarial", P, NP)
    rcfg = ref.SortConfig(p=P, n_per_proc=NP, **SLICE)
    rres, _ = ref.bsp_sort(jnp.asarray(x), rcfg)
    res, _ = bsp_sort(x, config_from_reference(config_fields(rcfg)), device="cpu")
    assert bool(res.overflow) and bool(rres.overflow)
    assert_same(rres.buf, res.buf, "buf")
    assert_same(rres.count, res.count, "count")


def test_launch_then_wait_is_idempotent_and_stats_accumulate():
    from repro_torch.core import SortConfig, TierStats, bsp_sort_safe_launch

    x = make_input("adversarial", 4, 64)
    cfg = SortConfig(p=4, n_per_proc=64, **SLICE)
    stats = TierStats()
    flight = bsp_sort_safe_launch(x, cfg, stats=stats, device="cpu")
    first = flight.wait()
    assert flight.wait() is first
    once = stats.as_row()
    assert once["retries"] >= 1  # the adversarial input faults the whp rung
    bsp_sort_safe(x, cfg, stats=stats, device="cpu")
    assert stats.as_row() == {k: 2 * v for k, v in once.items()}
    assert np.array_equal(gathered_output(first[0]).numpy(), np.sort(x.ravel()))
