"""The segmented sort (``core/segmented.py``) against the JAX package.

Packing is host code: ``pack_segments`` must give the reference's bytes
(``comp``, ``pos``, lane sizes) under both layouts, the striped layout's
distinct pad composites included. The fused sort must give every
segment's keys and stable argsort, the tier that served the batch and the
ladder's counters, for single-segment int32 batches (raw keys, pads equal
to real keys) and multi-segment int64 composite batches, on the default
SORT_IRAN_BSP config and on det, radix-route, escalating and tree-merge
ones; ``merge_backend="pallas"`` on the CPU takes the plain int64 K2.
The randomized sample differs between the packages (the reference draws
from ``jax.random``), but a sort's output does not, and these batches
keep both on the same rungs. Tolerance: exact bytes.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import datagen, segmented
from test_torch_harness import assert_same, reference, x64

P = 8


def requests(kind: str, seed: int = 0):
    """Ragged int32 requests: ``one`` segment, ``few`` mixed sizes (one of a
    single key, duplicates, int32 extremes), or ``zipf`` heavy-tailed sizes."""
    rng = np.random.default_rng(seed)
    if kind == "one":
        a = rng.integers(-50, 50, 1000).astype(np.int32)
        a[:7] = np.iinfo(np.int32).max  # real keys equal to the pad
        return [a]
    if kind == "few":
        sizes = [1, 300, 2000, 77, 1500, 5]
    else:
        sizes = datagen.zipf_sizes(24, 3000, seed=seed)
    out = [rng.integers(-1000, 1000, int(n)).astype(np.int32) for n in sizes]
    out[2][:3] = (np.iinfo(np.int32).min, np.iinfo(np.int32).max, 0)
    return out


def ref_segmented():
    reference()
    from repro.core import segmented as ref

    return ref


@pytest.mark.parametrize("n_per_proc", [None, 1024])
@pytest.mark.parametrize("layout", ["contiguous", "striped"])
@pytest.mark.parametrize("kind", ["one", "few", "zipf"])
def test_pack_segments_matches_reference(kind, layout, n_per_proc):
    ref = ref_segmented()
    arrs = requests(kind)
    want = ref.pack_segments(arrs, P, n_per_proc=n_per_proc, layout=layout)
    got = segmented.pack_segments(arrs, P, n_per_proc=n_per_proc, layout=layout)
    assert_same(want.comp, got.comp, "comp")
    assert_same(want.pos, got.pos, "pos")
    assert (got.sizes, got.p, got.n_per_proc, got.layout, got.n_keys) == \
        (want.sizes, want.p, want.n_per_proc, want.layout, want.n_keys)


def test_packing_helpers_match_reference():
    ref = ref_segmented()
    sizes = [int(s) for s in datagen.zipf_sizes(30, 5000, seed=4)]
    for total in (0, 7, 5000):
        assert_same(ref.contiguous_lane_sizes(total, P), segmented.contiguous_lane_sizes(total, P))
    assert_same(ref.striped_chunk_sizes(sizes, P), segmented.striped_chunk_sizes(sizes, P))
    seg = np.repeat(np.arange(4), 3)
    keys = np.array([np.iinfo(np.int32).min, -1, 0, 1, np.iinfo(np.int32).max, 5] * 2, np.int32)
    comp = segmented.pack_keys(seg, keys)
    assert_same(ref.pack_keys(seg, keys), comp)
    for w, g in zip(ref.unpack_keys(comp), segmented.unpack_keys(comp)):
        assert_same(w, g)
    assert all(ref._pow2_n_per_proc(t, P, 8) == segmented._pow2_n_per_proc(t, P, 8) for t in (1, 64, 65, 9999))
    with pytest.raises(ValueError):
        segmented.pack_segments([np.zeros(100, np.int32)], P, n_per_proc=8)
    with pytest.raises(ValueError):
        segmented.pack_segments([np.zeros(1, np.int32)], P, layout="diagonal")


CONFIGS = {
    "default": {},
    "det": dict(algorithm="det"),
    "tree pallas": dict(merge="tree", merge_backend="pallas"),
    "det tree pallas": dict(algorithm="det", merge="tree", merge_backend="pallas"),
    "radix route": dict(route="radix", merge="tree", merge_backend="pallas"),
    "det escalating": dict(algorithm="det", capacity_factor=0.5),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("layout", ["contiguous", "striped"])
@pytest.mark.parametrize("kind", ["one", "few", "zipf"])
def test_sort_segments_matches_reference(kind, layout, config):
    ref = ref_segmented()
    arrs = requests(kind, seed=1)
    overrides = CONFIGS[config]
    with x64(len(arrs) > 1):
        want = ref.sort_segments(arrs, p=P, layout=layout, **overrides)
    got = segmented.sort_segments(arrs, p=P, layout=layout, device="cpu", **overrides)
    assert len(got.keys) == len(got.order) == len(arrs)
    for r, (wk, wo, gk, go) in enumerate(zip(want.keys, want.order, got.keys, got.order)):
        assert_same(wk, gk, f"segment {r} keys")
        assert_same(wo, go, f"segment {r} order")
        assert np.array_equal(gk.numpy(), np.sort(arrs[r], kind="stable"))
        assert np.array_equal(go.numpy(), np.argsort(arrs[r], kind="stable"))
    assert got.tier == want.tier and got.n_per_proc == want.n_per_proc
    assert got.stats.as_row() == want.stats.as_row()
    if config == "det escalating":
        assert got.tier == "allgather" and got.stats.retries == 1


def test_launch_then_wait_is_the_blocking_sort():
    arrs = requests("few", seed=2)
    packed = segmented.pack_segments(arrs, P, layout="striped")
    flight = segmented.segmented_sort_launch(packed, device="cpu", generator=torch.Generator().manual_seed(3))
    assert not flight.done()
    first = flight.wait()
    assert flight.done() and flight.wait().keys[0] is not None
    again = segmented.segmented_sort_safe(packed, device="cpu", generator=torch.Generator().manual_seed(3))
    for a, b in zip(first.keys + first.order, again.keys + again.order):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        segmented.segmented_sort_launch(packed, segmented.SortConfig(p=P, n_per_proc=packed.n_per_proc * 2),
                                        device="cpu")
