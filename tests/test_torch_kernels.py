"""The K1, K2 and K3 wrappers against the JAX package's kernel ops.

On the CPU every wrapper takes its kernel's plain version, so these tests
hold the padding, tiling, clamping and window logic around each kernel,
and the plain version itself, against the Pallas kernels run in interpret
mode. The cases are those of ``tests/test_kernels_fast.py`` plus a
multi-tile K1 row. The kernels themselves run only on the card
(``test_kernels_match_plain_on_card``).
"""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitonic import ops as bops
from repro_torch.kernels.bitonic import ref as bref
from repro_torch.kernels.merge_path import ops as mops
from repro_torch.kernels.merge_path import ref as mref
from repro_torch.kernels.searchsorted import ops as sops
from repro_torch.kernels.searchsorted import ref as sref
from test_torch_harness import assert_same, reference


def _ref_ops(name: str):
    reference()
    return importlib.import_module(f"repro.kernels.{name}.ops")


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("shape", [(1, 17), (3, 100), (2, 1024)])
def test_bitonic_sort_matches_reference(dtype, shape):
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**20, shape).astype(dtype)
    want = _ref_ops("bitonic").sort(jnp.asarray(x))
    assert_same(want, bops.sort(torch.from_numpy(x)), "sort")
    assert_same(want[0], bops.sort(torch.from_numpy(x[0])), "sort 1-D")


def test_bitonic_sort_multi_tile_row():
    rng = np.random.default_rng(1)
    x = rng.integers(-(2**31), 2**31 - 1, (2, 3 * bops.MAX_WIDTH + 5), dtype=np.int64)
    x = x.astype(np.int32)
    x[1, :40] = np.iinfo(np.int32).max  # real keys equal to the sentinel
    got = bops.sort(torch.from_numpy(x))
    assert_same(np.sort(x, axis=-1), got, "multi-tile")


def test_bitonic_sort_rejects_bad_tiles():
    with pytest.raises(ValueError):
        bops.sort_tiles(torch.zeros((2, 96), dtype=torch.int32))
    with pytest.raises(ValueError):
        bops.sort_tiles(torch.zeros((2, 2 * bops.MAX_WIDTH), dtype=torch.int32))
    assert bops.supports(torch.zeros(4, dtype=torch.float32))
    assert not bops.supports(torch.zeros(4, dtype=torch.int64))


@pytest.mark.parametrize("na,nb", [(33, 77), (128, 128), (1, 64)])
def test_merge_matches_reference(na, nb):
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    a = np.sort(rng.integers(0, 500, (2, na)).astype(np.int32), axis=-1)
    b = np.sort(rng.integers(0, 500, (2, nb)).astype(np.int32), axis=-1)
    want = _ref_ops("merge_path").merge(jnp.asarray(a), jnp.asarray(b))
    assert_same(want, mops.merge(torch.from_numpy(a), torch.from_numpy(b)), "merge")


@pytest.mark.parametrize("na,nb", [(100, 300), (1500, 2500), (64, 64)])
def test_merge_partitioned_matches_reference(na, nb):
    """Widths straddling the TILE boundary, sentinel-valued real keys."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    w = max(na, nb)
    sent = np.iinfo(np.int32).max
    a = np.sort(rng.integers(0, 1000, (3, w)).astype(np.int32), axis=-1)
    b = np.sort(rng.integers(0, 1000, (3, w)).astype(np.int32), axis=-1)
    a[:, na:] = sent
    b[:, nb:] = sent
    b[1, nb - 1 :] = sent
    want = np.asarray(_ref_ops("merge_path").merge_partitioned(jnp.asarray(a), jnp.asarray(b)))
    got = mops.merge_partitioned(torch.from_numpy(a), torch.from_numpy(b))
    assert_same(want, got, "merge_partitioned")
    assert_same(np.sort(np.concatenate([a, b], axis=-1), axis=-1), got, "oracle")
    # the merge tree asks for a clipped width: the same columns, no more
    clipped = mops.merge_partitioned(torch.from_numpy(a), torch.from_numpy(b), width=w + 7)
    assert_same(want[:, : w + 7], clipped, "clipped")


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("n,q", [(256, 256), (1000, 100), (5000, 2048)])
def test_rank_in_matches_reference(side, n, q):
    import jax.numpy as jnp

    rng = np.random.default_rng(6)
    data = np.sort(rng.integers(0, 50, n).astype(np.int32))
    queries = rng.integers(-5, 55, q).astype(np.int32)
    queries[:3] = np.iinfo(np.int32).max  # sentinel-valued queries
    want = _ref_ops("searchsorted").rank_in(jnp.asarray(data), jnp.asarray(queries), side=side)
    assert_same(want, sops.rank_in(torch.from_numpy(data), torch.from_numpy(queries), side=side))
    # batched over rows, as the merge tail calls it
    rows = np.stack([data, data])
    got = sops.rank_in(torch.from_numpy(rows), torch.from_numpy(np.stack([queries, queries])), side=side)
    assert_same(np.stack([np.asarray(want)] * 2), got, "batched")


@pytest.mark.parametrize("n,s", [(256, 7), (1000, 31)])
def test_splitter_ranks_matches_reference(n, s):
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    x = np.sort(rng.integers(0, 40, n).astype(np.int32))
    sk = rng.integers(0, 40, s).astype(np.int32)
    sp = rng.integers(0, 8, s).astype(np.int32)
    si = rng.integers(0, n, s).astype(np.int32)
    want = _ref_ops("searchsorted").splitter_ranks(
        jnp.asarray(x), jnp.asarray(sk), jnp.asarray(sp), jnp.asarray(si), jnp.asarray(3, jnp.int32)
    )
    got = sops.splitter_ranks(
        torch.from_numpy(x), torch.from_numpy(sk), torch.from_numpy(sp), torch.from_numpy(si), 3
    )
    assert_same(want, got, "splitter_ranks")


def test_rank_in_rejects_bad_side():
    with pytest.raises(ValueError):
        sops.rank_in(torch.zeros(4, dtype=torch.int32), torch.zeros(2, dtype=torch.int32), side="mid")


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Each CUDA kernel equals its plain version exactly (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.int32, torch.float32):
        x = torch.randint(-(2**30), 2**30, (16, 16384), device="cuda", generator=g).to(dtype)
        assert torch.equal(bops.sort_tiles(x), bref.sort_tiles(x))
        xm = torch.randint(0, 2**20, (4, 65536), device="cuda", generator=g).to(dtype)
        assert torch.equal(bops.sort(xm), torch.sort(xm, dim=-1).values)
    data = torch.sort(torch.randint(0, 500, (8, 1256), device="cuda", generator=g).int(), dim=-1).values
    q = torch.randint(-5, 505, (8, 2512), device="cuda", generator=g).int()
    q[:, :4] = torch.iinfo(torch.int32).max
    for side in ("left", "right"):
        zeros = torch.zeros_like(q)
        tag = torch.full_like(q, 1 if side == "right" else -1)
        plain = sref.ranks(data, q, tag, zeros, torch.zeros(8, dtype=torch.int32, device="cuda"))
        assert torch.equal(sops.rank_in(data, q, side=side), plain)
    for w in (100, 1256, 2512):
        a = torch.sort(torch.randint(0, 1000, (8, w), device="cuda", generator=g).int(), dim=-1).values
        b = torch.sort(torch.randint(0, 1000, (8, w), device="cuda", generator=g).int(), dim=-1).values
        b[:, w // 2 :] = torch.iinfo(torch.int32).max
        tile = min(mops.TILE, mops._pow2_at_least(w))
        assert torch.equal(mops.merge_partitioned(a, b), mref.merge_windows(a, b, tile, 2 * w))
    assert _build.counts()["bitonic_sort_tiles"] > 0
