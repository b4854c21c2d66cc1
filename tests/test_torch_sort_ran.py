"""SORT_RAN_BSP, the classic randomized sample sort, against the JAX package.

As for SORT_IRAN_BSP (``test_torch_sort_iran.py``): every rung's route
stage, fed the positions the reference draws from its folded key (unsorted
here), is byte-identical to the reference's; the port's own draws must
sort. Tolerance: exact (integer keys).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import SortConfig, bsp_sort_safe
from repro_torch.core.sort_ran import prepare_ran_spmd, route_ran_spmd
from test_torch_sort_det import make_input, payloads
from test_torch_sort_iran import P, NP, check_rungs, check_sorted

CONFIGS = {
    "sort": dict(algorithm="ran", pair_capacity="whp"),
    "bitonic_tree": dict(algorithm="ran", local_sort="bitonic", merge="tree",
                         merge_backend="pallas", pair_capacity="whp"),
}


def reference_positions(rcfg, rxs, tier_rng):
    """The reference's step-2 draw: s positions per processor, unsorted."""
    import jax
    import jax.numpy as jnp

    def draw(me):
        return jax.random.randint(jax.random.fold_in(tier_rng, me), (rcfg.s,), 0, rcfg.n_per_proc)

    return torch.from_numpy(np.array(jax.vmap(draw)(jnp.arange(rcfg.p, dtype=jnp.int32))))


@pytest.mark.parametrize("n_values", [0, 1])
@pytest.mark.parametrize("dist", ["U", "DD", "zipf", "adversarial"])
def test_route_stage_per_rung_matches_reference(dist, n_values):
    check_rungs(make_input(dist, P, NP), CONFIGS["sort"], n_values, route_ran_spmd,
                prepare_ran_spmd, reference_positions)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("dist", ["U", "B", "DD", "adversarial"])
def test_safe_sort_sorts_with_its_own_sample(dist, config):
    x = make_input(dist, P, NP)
    vals = payloads(P, NP, 1)
    res, pvals, stats = bsp_sort_safe(x, SortConfig(p=P, n_per_proc=NP, **CONFIGS[config]),
                                      values=vals, device="cpu")
    check_sorted(x, res, pvals, stats, vals)
