"""SORT_DET_BSP parity with the JAX package over a covering grid.

Every value of every axis appears at least once: p ∈ {4, 8}; n_per_proc up
to 1024 (one odd width); U, G, B, DD, WR, zipf and the adversarial input;
key-only, one payload and two payloads (one multi-dimensional);
merge sort/tree × backend xla/pallas; local sort lax/bitonic; routing
a2a_dense/allgather; fused and per-array exchange. The slice's own
configuration over every distribution is in ``test_torch_sort_det.py``.
"""
from __future__ import annotations

import pytest

from test_torch_sort_det import check_against_reference, make_input

_CASES = [
    # (p, n_p, config, [(dist, n_values), ...])
    (4, 256, dict(local_sort="lax", merge="sort", pair_capacity="whp"),
     [("U", 1), ("DD", 0), ("adversarial", 1)]),
    (4, 1024, dict(local_sort="lax", merge="tree", pair_capacity="whp"),
     [("G", 0), ("zipf", 1), ("WR", 1)]),
    (8, 256, dict(local_sort="bitonic", merge="sort", routing="allgather"),
     [("B", 1), ("adversarial", 0)]),
    (4, 512, dict(local_sort="lax", merge="tree", merge_backend="pallas",
                  routing="allgather", pair_capacity="whp"),
     [("U", 0), ("DD", 1)]),
    (8, 1024, dict(local_sort="bitonic", merge="tree", exchange="per_array",
                   pair_capacity="whp"),
     [("zipf", 2), ("adversarial", 1)]),
    (4, 100, dict(local_sort="lax", merge="tree", merge_backend="pallas",
                  pair_capacity="whp"),
     [("G", 2), ("B", 0)]),
]


@pytest.mark.parametrize(
    "p,n_p,cfg,dist,n_values",
    [(p, n_p, cfg, d, nv) for p, n_p, cfg, runs in _CASES for d, nv in runs],
)
def test_grid_matches_reference(p, n_p, cfg, dist, n_values):
    check_against_reference(make_input(dist, p, n_p), dict(algorithm="det", **cfg), n_values)
