"""[BSI] (Batcher's bitonic sort across processors) and the bitonic sample
sort (``sample_sort="bitonic"``), against the JAX package.

Both are deterministic, so [BSI] and SORT_DET_BSP with the bitonic sample
sort are byte-identical to the reference end to end; SORT_IRAN_BSP with the
bitonic sample sort is held rung by rung on the reference's sample
(``test_torch_sort_iran.py``). Tolerance: exact (integer keys).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import SortConfig, bsp_sort, bsp_sort_safe
from repro_torch.core.sort_iran import prepare_iran_spmd, route_iran_spmd
from test_torch_sort_det import check_against_reference, make_input
from test_torch_sort_iran import P, NP, check_rungs, reference_positions

BSI = dict(algorithm="bitonic")


@pytest.mark.parametrize("local_sort", ["lax", "bitonic"])
@pytest.mark.parametrize("dist", ["U", "G", "DD", "zipf", "adversarial"])
def test_bsi_matches_reference(dist, local_sort):
    row = check_against_reference(make_input(dist, P, NP), dict(BSI, local_sort=local_sort), 0)
    assert row == {"tier_exact": 1, "ok_exact": 1, "retries": 0}


def test_bsi_is_key_only():
    x = make_input("U", 4, 64)
    with pytest.raises(NotImplementedError, match="key-only"):
        bsp_sort(x, SortConfig(p=4, n_per_proc=64, **BSI), values=[np.zeros_like(x)], device="cpu")


def test_bsi_keeps_n_per_proc_keys_on_every_processor():
    x = make_input("B", P, NP)
    res, _, _ = bsp_sort_safe(x, SortConfig(p=P, n_per_proc=NP, **BSI), device="cpu")
    assert torch.equal(res.count, torch.full((P,), NP, dtype=torch.int32))
    assert np.array_equal(res.buf.numpy().ravel(), np.sort(x.ravel()))


@pytest.mark.parametrize("n_values", [0, 1])
@pytest.mark.parametrize("dist", ["U", "DD", "adversarial"])
def test_det_bitonic_sample_sort_matches_reference(dist, n_values):
    cfg = dict(algorithm="det", sample_sort="bitonic", local_sort="bitonic", merge="tree",
               merge_backend="pallas", pair_capacity="whp")
    check_against_reference(make_input(dist, P, NP), cfg, n_values)


@pytest.mark.parametrize("dist", ["U", "zipf"])
def test_iran_bitonic_sample_sort_route_matches_reference(dist):
    cfg = dict(algorithm="iran", sample_sort="bitonic", local_sort="bitonic", merge="tree",
               merge_backend="pallas", pair_capacity="whp")
    check_rungs(make_input(dist, P, NP), cfg, 1, route_iran_spmd, prepare_iran_spmd,
                reference_positions)
