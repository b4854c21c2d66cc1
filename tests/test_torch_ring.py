"""``routing="ring"`` — p−1 rotation supersteps — against the JAX package.

SORT_DET_BSP runs end to end through both packages' ``bsp_sort_safe``;
SORT_IRAN_BSP is held rung by rung on the reference's own sample draws
(``test_torch_sort_iran.check_rungs``). Both ``exchange`` modes, key-only
and with payloads (one of them (n, 2) float32), must give the reference's
bytes; a receive bound cut below the average load makes the exact rung
overflow and escalate to the allgather rung. The visitor block's byte
packing and the host accounting helpers are held on their own.
Tolerance: exact bytes.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import routing
from repro_torch.core.sort_iran import prepare_iran_spmd, route_iran_spmd
from test_torch_harness import assert_same, reference
from test_torch_sort_det import check_against_reference, make_input, payloads
from test_torch_sort_iran import check_rungs, reference_positions

P, NP = 8, 512


@pytest.mark.parametrize("n_values", [0, 1, 2])
@pytest.mark.parametrize("exchange", ["fused", "per_array"])
@pytest.mark.parametrize("dist", ["U", "DD", "adversarial"])
def test_det_ring_matches_reference(dist, exchange, n_values):
    cfg = dict(algorithm="det", routing="ring", exchange=exchange, local_sort="bitonic",
               merge="tree", merge_backend="pallas")
    check_against_reference(make_input(dist, P, NP), cfg, n_values)


@pytest.mark.parametrize("n_values", [0, 1])
@pytest.mark.parametrize("exchange", ["fused", "per_array"])
def test_iran_ring_route_stage_per_rung_matches_reference(exchange, n_values):
    cfg = dict(algorithm="iran", routing="ring", exchange=exchange, merge="tree")
    check_rungs(make_input("G", P, NP), cfg, n_values, route_iran_spmd, prepare_iran_spmd,
                reference_positions)


@pytest.mark.parametrize("exchange", ["fused", "per_array"])
def test_ring_overflow_escalates_to_allgather(exchange):
    """capacity_factor 0.5 puts n_max below every processor's share: the
    ring's exact rung overflows and the allgather rung finishes."""
    cfg = dict(algorithm="det", routing="ring", exchange=exchange, capacity_factor=0.5)
    row = check_against_reference(make_input("U", P, NP), cfg, 1)
    assert row == {"tier_exact": 1, "tier_allgather": 1, "ok_allgather": 1, "retries": 1}


def test_visitor_block_packs_to_the_reference_bytes():
    import jax
    import jax.numpy as jnp

    reference()
    from repro.core import routing as ref_routing

    x = make_input("U", P, NP)
    v1, v2 = payloads(P, NP, 2)
    b = np.sort(np.random.default_rng(0).integers(0, NP + 1, (P, P + 1)), axis=1).astype(np.int32)
    arrs = [x, v1, v2, b]
    want = jax.vmap(lambda *a: ref_routing.pack_bytes_flat(list(a))[0])(*[jnp.asarray(a) for a in arrs])
    got, metas = routing.pack_bytes_flat([torch.from_numpy(a) for a in arrs])
    assert_same(want, got, "packed")
    for a, back in zip(arrs, routing.unpack_bytes_flat(got, metas)):
        assert_same(a, back, "unpacked")


@pytest.mark.parametrize("name", ["a2a_dense", "allgather", "ring"])
def test_host_accounting_matches_reference(name):
    reference()
    from repro.core import routing as ref_routing

    for p in (1, 2, 8, 128):
        assert routing.route_supersteps(name, p) == ref_routing.route_supersteps(name, p)
    assert routing.packed_row_bytes(torch.int32, [torch.int32, torch.float32]) == \
        ref_routing.packed_row_bytes(np.int32, [np.int32, np.float32])
    assert routing.packed_row_bytes(torch.int64) == ref_routing.packed_row_bytes(np.int64)
    with pytest.raises(ValueError):
        routing.route_supersteps("mesh", 8)
