"""The radix local sort — the paper's [DSR] and [RSR] — against the JAX package.

``radix_argsort`` (LSD counting passes over every run at once) must give
the reference's stable argsort on int32 and int64 extremes and on Zipf
duplicates. [DSR] (``det`` + ``local_sort="radix"``) runs end to end
through both packages' ``bsp_sort_safe``; [RSR] (``iran``) is held rung by
rung on the reference's own sample draws (``test_torch_sort_iran``), its
prepared state included. Float keys under ``local_sort="radix"`` take the
stable sort, as in the reference. Tolerance: exact bytes.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import datagen
from repro_torch.core.radix import radix_argsort, radix_sort
from repro_torch.core.sort_iran import prepare_iran_spmd, route_iran_spmd
from test_torch_float_keys import float_keys, run_both
from test_torch_harness import assert_same, reference, x64
from test_torch_sort_det import check_against_reference, make_input
from test_torch_sort_iran import check_rungs, reference_positions

I32, I64 = np.iinfo(np.int32), np.iinfo(np.int64)
P, NP = 8, 512
MERGES = [("sort", "xla"), ("tree", "xla"), ("tree", "pallas")]


def reference_argsort(x: np.ndarray, bits: int) -> np.ndarray:
    """The reference's ``radix_argsort`` of every row."""
    import jax.numpy as jnp

    reference()
    from repro.core.radix import radix_argsort as ref_argsort

    with x64(x.dtype == np.int64):
        return np.stack([np.asarray(ref_argsort(jnp.asarray(row), bits=bits)) for row in x])


@pytest.mark.parametrize(
    "name,bits",
    [("int32 extremes", 4), ("int32 extremes", 8), ("int64 extremes", 4), ("int64 extremes", 8),
     ("zipf duplicates", 4)],
)
def test_radix_argsort_matches_reference(name, bits):
    rng = np.random.default_rng(0)
    if name == "int32 extremes":
        x = np.array([[5, -1, I32.min, I32.max, 0, -7, I32.min, I32.max, 3, -1],
                      [I32.max, I32.max, -2, -2, I32.min, 1, 1, 0, 0, I32.min]], np.int32)
    elif name == "int64 extremes":
        x = rng.integers(I64.min, I64.max, (3, 64), dtype=np.int64)
        x[0, :8] = (I64.max, I64.min, 0, -1, 1, I64.min, I64.max, I64.min + 1)
        x[1, ::3] = I64.max
        x[2] = x[2] % 5 - 2  # heavy ties, both signs
    else:
        x = datagen.generate("zipf", 4, 512, seed=3)
    got = radix_argsort(torch.from_numpy(x), bits=bits)
    assert_same(reference_argsort(x, bits), got, "order")
    assert np.array_equal(got.numpy(), np.argsort(x, axis=1, kind="stable")), "not the stable argsort"
    assert_same(reference_argsort(x[:1], bits)[0], radix_argsort(torch.from_numpy(x[0]), bits=bits), "1-D")
    assert_same(np.sort(x, axis=1), radix_sort(torch.from_numpy(x), bits=bits), "radix_sort")


def test_radix_argsort_refuses_float_keys():
    with pytest.raises(TypeError):
        radix_argsort(torch.zeros(4))


#: every merge on U; the tree on the kernels for duplicate-heavy DD (three
#: rungs) and Zipf keys
DSR_CASES = [("U", m, b) for m, b in MERGES] + [(d, "tree", "pallas") for d in ("DD", "zipf")]


@pytest.mark.parametrize("n_values", [0, 1])
@pytest.mark.parametrize("dist,merge,backend", DSR_CASES)
def test_dsr_matches_reference(dist, merge, backend, n_values):
    """[DSR]: SORT_DET_BSP with the radix local sort, end to end."""
    cfg = dict(algorithm="det", local_sort="radix", merge=merge, merge_backend=backend,
               pair_capacity="whp")
    check_against_reference(make_input(dist, P, NP), cfg, n_values)


@pytest.mark.parametrize("n_values", [0, 1])
@pytest.mark.parametrize("merge,backend", [("sort", "xla"), ("tree", "pallas")])
def test_rsr_route_stage_per_rung_matches_reference(merge, backend, n_values):
    """[RSR]: SORT_IRAN_BSP with the radix local sort, on the reference's draws."""
    cfg = dict(algorithm="iran", local_sort="radix", merge=merge, merge_backend=backend,
               pair_capacity="whp")
    check_rungs(make_input("G", P, NP), cfg, n_values, route_iran_spmd, prepare_iran_spmd,
                reference_positions)


@pytest.mark.parametrize("keyset,n_values", [("signed_zeros", 1), ("nans", 0)])
def test_float_keys_under_radix_local_sort_take_the_stable_sort(keyset, n_values):
    cfg = dict(local_sort="radix", merge="tree", merge_backend="pallas", pair_capacity="whp")
    run_both(float_keys(keyset), cfg, n_values)
