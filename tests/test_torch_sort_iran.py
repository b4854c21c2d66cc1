"""SORT_IRAN_BSP, the paper's randomized sort, against the JAX package.

The JAX package draws every rung's sample from ``jax.random`` (the key
folded per rung, then per processor), which torch cannot reproduce. So the
route stage (Ph3–Ph6) is held to the reference rung by rung, fed the
positions that the reference's own ``random_sample`` draws under the same
folded key, on the reference's prepared state: byte-identical. The port's
own draws are held to what the sort promises: sorted output, payloads in
stable order, consistent tiers. Tolerance: exact (integer keys).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import (
    SortConfig,
    TierStats,
    bsp_sort,
    bsp_sort_safe,
    bsp_sort_safe_launch,
    config_from_reference,
    gathered_output,
    prepared_from_reference,
)
from repro_torch.core.sort_iran import prepare_iran_spmd, route_iran_spmd
from test_torch_harness import assert_same, config_fields, reference
from test_torch_sort_det import make_input, payloads

SLICE = dict(
    algorithm="iran", local_sort="bitonic", merge="tree", merge_backend="pallas",
    pair_capacity="whp",
)
P, NP = 8, 512
DISTS = ["U", "G", "B", "DD", "zipf", "adversarial"]
_EXECUTOR = []


def executor():
    """One reference executor for the module, so each rung compiles once."""
    if not _EXECUTOR:
        reference()
        from repro.core.api import SortExecutor

        _EXECUTOR.append(SortExecutor())
    return _EXECUTOR[0]


def reference_positions(rcfg, rxs, tier_rng):
    """The (p, s) positions the reference's ``random_sample`` draws."""
    import jax

    from repro.core import splitters
    from repro.core.types import AXIS

    draw = lambda xs: splitters.random_sample(xs, rcfg, AXIS, tier_rng)[2]  # noqa: E731
    return torch.from_numpy(np.array(jax.vmap(draw, axis_name=AXIS)(rxs)))


def check_rungs(x, cfg_kw: dict, n_values: int, route_fn, prepare_fn, draw) -> None:
    """Every rung's route stage on the reference's prepared state and draw."""
    import jax
    import jax.numpy as jnp

    ref = reference()
    ex = executor()
    vals = payloads(P, NP, n_values)
    rcfg = ref.SortConfig(p=P, n_per_proc=NP, **cfg_kw)
    rprep = ex.prepare_vmap(rcfg, n_values)(jnp.asarray(x), *[jnp.asarray(v) for v in vals])
    prep = prepared_from_reference(
        np.asarray(rprep.xs), [np.asarray(v) for v in rprep.vals], None, device="cpu"
    )
    own = prepare_fn(torch.from_numpy(x), config_from_reference(config_fields(rcfg)),
                     [torch.from_numpy(v) for v in vals])
    assert_same(rprep.xs, own.xs, "prepared xs")
    for r, o in zip(rprep.vals, own.vals):
        assert_same(r, o, "prepared vals")
    rng = jax.random.key(rcfg.seed)
    for i, (_, rtier) in enumerate(rcfg.tier_ladder()):
        tier_rng = jax.random.fold_in(rng, i)
        positions = draw(rtier, rprep.xs, tier_rng)
        rbuf, rvbufs, rcount, rover = ex.route_vmap(rtier, n_values)(
            rprep, jax.random.key_data(tier_rng)
        )
        buf, vbufs, count, over = route_fn(prep, config_from_reference(config_fields(rtier)), positions)
        assert_same(rbuf, buf, f"rung {i} buf")
        assert_same(rcount, count, f"rung {i} count")
        assert_same(rover, over, f"rung {i} overflow")
        for rv, v in zip(rvbufs, vbufs):
            assert_same(rv, v, f"rung {i} payload")


def check_sorted(x, res, pvals, stats, vals) -> None:
    """Sorted output, stable payload order, consistent tiers."""
    assert np.array_equal(gathered_output(res).numpy(), np.sort(x.ravel()))
    if vals:
        order = np.argsort(x.ravel(), kind="stable")
        got = np.concatenate([pvals[0][k, : int(res.count[k])].numpy() for k in range(x.shape[0])])
        assert np.array_equal(got, vals[0].ravel()[order])
    row = stats.as_row()
    walked = [k[len("tier_"):] for k in row if k.startswith("tier_")]
    assert walked and walked[-1] == stats.last_tier and row["retries"] == len(walked) - 1
    assert not bool(res.overflow)


@pytest.mark.parametrize("n_values", [0, 1])
@pytest.mark.parametrize("dist", DISTS)
def test_route_stage_per_rung_matches_reference(dist, n_values):
    check_rungs(make_input(dist, P, NP), SLICE, n_values, route_iran_spmd, prepare_iran_spmd,
                reference_positions)


@pytest.mark.parametrize("n_values", [0, 1])
@pytest.mark.parametrize("dist", DISTS)
def test_safe_sort_sorts_with_its_own_sample(dist, n_values):
    x = make_input(dist, P, NP)
    vals = payloads(P, NP, n_values)
    res, pvals, stats = bsp_sort_safe(x, SortConfig(p=P, n_per_proc=NP, **SLICE), values=vals,
                                      device="cpu")
    check_sorted(x, res, pvals, stats, vals)
    if dist == "adversarial":
        assert stats.retries >= 1


def test_generator_decides_the_sample():
    """The same generator state gives the same bytes; a generator is drawn
    from rung after rung; without one the config's seed decides."""
    x = make_input("DD", P, NP)
    cfg = SortConfig(p=P, n_per_proc=NP, **SLICE)
    runs = [bsp_sort(x, cfg, generator=torch.Generator().manual_seed(5), device="cpu")[0]
            for _ in range(2)]
    assert torch.equal(runs[0].buf, runs[1].buf)
    a = bsp_sort_safe(x, cfg, device="cpu")[0]
    b = bsp_sort_safe(x, cfg, device="cpu")[0]
    assert torch.equal(a.buf, b.buf) and torch.equal(a.count, b.count)
    g = torch.Generator().manual_seed(11)
    stats = TierStats()
    flight = bsp_sort_safe_launch(make_input("adversarial", P, NP), cfg, generator=g, stats=stats,
                                  device="cpu")
    before = g.get_state()
    res, _, _ = flight.wait()
    assert stats.retries >= 1 and not torch.equal(g.get_state(), before)
    assert np.array_equal(gathered_output(res).numpy(), np.sort(make_input("adversarial", P, NP).ravel()))


def test_bsp_sort_one_tier_runs_iran():
    x = make_input("U", P, NP)
    res, _ = bsp_sort(x, SortConfig(p=P, n_per_proc=NP, **SLICE), device="cpu")
    assert not bool(res.overflow)
    assert np.array_equal(gathered_output(res).numpy(), np.sort(x.ravel()))
