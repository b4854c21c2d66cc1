"""Keys whose ties differ in their bits, and the other key dtypes.

Float keys drawn from {-0.0, +0.0, 2.0} compare equal but differ in their
bytes; keys with NaNs (both signs) compare false with everything. The JAX
package's bitonic networks (the tile sort and the merge-path merge) are
not stable on such keys and leave NaN runs unsorted, and its
``jnp.searchsorted`` probes decide where a NaN lands. The port must give
its bytes all the same, over every Ph2 method, Ph6 merge and merge
substrate, key-only and key-value. uint32 and bfloat16 keys, which the
bitonic tile sort also takes, are held to the same bytes. Tolerance: exact.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import bsp_sort_safe, config_from_reference
from test_torch_harness import config_fields, reference

P, NP = 8, 256
KEYSETS = {
    "signed_zeros": [-0.0, 0.0, 2.0],
    "nans": [np.nan, -np.nan, 1.0, -1.0, 0.5],
}
MERGES = [("sort", "xla"), ("sort", "pallas"), ("tree", "xla"), ("tree", "pallas")]


def float_keys(keyset: str, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    choice = np.asarray(KEYSETS[keyset], dtype=np.float32)
    return choice[rng.integers(0, len(choice), (P, NP))]


def to_torch(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, bfloat16 by its bits."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_bytes(ref, port: torch.Tensor, what: str) -> None:
    r = np.asarray(ref)
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[port.element_size()]
    t = port.detach().cpu().contiguous().view(bits).numpy()
    assert r.shape == t.shape, f"{what}: shape {t.shape} != reference {r.shape}"
    assert r.dtype.itemsize == t.dtype.itemsize, f"{what}: item size differs"
    assert r.tobytes() == t.tobytes(), f"{what}: bytes differ"


def run_both(x: np.ndarray, cfg_kw: dict, n_values: int):
    """Both packages' overflow-safe sorts on one input; bytes must agree."""
    import jax.numpy as jnp

    ref = reference()
    vals = [np.arange(x.size, dtype=np.int32).reshape(x.shape)][:n_values]
    rcfg = ref.SortConfig(p=P, n_per_proc=NP, **cfg_kw)
    rres, rvals, rstats = ref.bsp_sort_safe(
        jnp.asarray(x), rcfg, values=[jnp.asarray(v) for v in vals]
    )
    res, pvals, stats = bsp_sort_safe(
        to_torch(x), config_from_reference(config_fields(rcfg)), values=vals, device="cpu"
    )
    assert res.buf.dtype == to_torch(x).dtype
    assert_bytes(rres.buf, res.buf, "buf")
    assert_bytes(rres.count, res.count, "count")
    assert bool(rres.overflow) == bool(res.overflow)
    for rv, pv in zip(rvals, pvals):
        assert_bytes(rv, pv, "payload")
    assert stats.as_row() == rstats.as_row()
    return res, pvals


@pytest.mark.parametrize("n_values", [0, 1])
@pytest.mark.parametrize("merge,backend", MERGES)
@pytest.mark.parametrize("local_sort", ["lax", "bitonic"])
@pytest.mark.parametrize("keyset", sorted(KEYSETS))
def test_float_keys_match_reference(keyset, local_sort, merge, backend, n_values):
    cfg = dict(local_sort=local_sort, merge=merge, merge_backend=backend, pair_capacity="whp")
    run_both(float_keys(keyset), cfg, n_values)


SLICE = dict(local_sort="bitonic", merge="tree", merge_backend="pallas", pair_capacity="whp")


@pytest.mark.parametrize("n_values", [0, 1])
@pytest.mark.parametrize("local_sort", ["lax", "bitonic"])
def test_uint32_keys_match_reference(local_sort, n_values):
    """Keys above 2³¹ and equal to the uint32 sentinel come back as uint32."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2**32, (P, NP), dtype=np.uint64).astype(np.uint32)
    x[0, :5] = np.iinfo(np.uint32).max
    x[3, :7] = 0
    res, pvals = run_both(x, dict(SLICE, local_sort=local_sort), n_values)
    assert res.buf.dtype == torch.uint32
    got = np.concatenate([res.buf[k, : int(res.count[k])].view(torch.int32).numpy() for k in range(P)])
    assert np.array_equal(got.view(np.uint32), np.sort(x.ravel()))


@pytest.mark.parametrize("n_values", [0, 1])
@pytest.mark.parametrize("local_sort", ["lax", "bitonic"])
def test_bfloat16_keys_match_reference(local_sort, n_values):
    import ml_dtypes

    rng = np.random.default_rng(4)
    x = rng.standard_normal((P, NP)).astype(ml_dtypes.bfloat16)
    x[1, :9] = -0.0
    x[2, :9] = 0.0
    run_both(x, dict(SLICE, local_sort=local_sort), n_values)


def test_tile_sort_wrapper_matches_reference_on_signed_zeros():
    """The K1 wrapper alone: the network's order of -0.0 and +0.0."""
    import importlib

    import jax.numpy as jnp

    from repro_torch.kernels.bitonic import ops as bops

    reference()
    rops = importlib.import_module("repro.kernels.bitonic.ops")
    x = float_keys("signed_zeros")
    assert_bytes(rops.sort(jnp.asarray(x)), bops.sort(torch.from_numpy(x)), "sort")
    x = float_keys("nans", seed=1)
    assert_bytes(rops.sort(jnp.asarray(x)), bops.sort(torch.from_numpy(x)), "sort, NaNs")


def test_stable_sort_orders_as_the_reference():
    """The port's key sort: -0.0 equals +0.0, NaNs of either sign equal and
    last, ties in input order — ``jnp.argsort(stable=True)``'s order."""
    import jax.numpy as jnp

    from repro_torch.core.primitives import stable_sort

    reference()
    x = float_keys("nans", seed=2)
    x[:, ::7] = -0.0
    x[:, 3::11] = 0.0
    values, order = stable_sort(torch.from_numpy(x))
    want = np.asarray(jnp.argsort(jnp.asarray(x), axis=-1, stable=True))
    assert np.array_equal(order.numpy(), want)
    assert_bytes(np.take_along_axis(x, want, -1), values, "values")


@pytest.mark.cuda
def test_card_sorts_float_keys_as_the_cpu():
    """``torch.sort`` of floats on the card orders NaNs otherwise than on
    the CPU; the port's sorts must not (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.primitives import stable_sort

    x = torch.from_numpy(float_keys("nans", seed=3))
    for got, want in zip(stable_sort(x.cuda()), stable_sort(x)):
        assert torch.equal(got.cpu().view(torch.int32) if got.is_floating_point() else got.cpu(),
                           want.view(torch.int32) if want.is_floating_point() else want)
    res, _, _ = bsp_sort_safe(x.cuda(), config_from_reference(dict(p=P, n_per_proc=NP, **SLICE)))
    ref_res, _, _ = bsp_sort_safe(x, config_from_reference(dict(p=P, n_per_proc=NP, **SLICE)),
                                  device="cpu")
    assert torch.equal(res.buf.cpu().view(torch.int32), ref_res.buf.view(torch.int32))


@pytest.mark.parametrize("n_values", [0, 1])
@pytest.mark.parametrize("local_sort,merge,backend", [("lax", "sort", "xla"), ("bitonic", "tree", "pallas")])
def test_bfloat16_nans_keep_their_bits(local_sort, merge, backend, n_values):
    """bfloat16 NaNs of both signs pass every gather and scatter with their
    bits (torch's CPU gather and scatter rewrite them to 0xffff)."""
    import ml_dtypes

    cfg = dict(local_sort=local_sort, merge=merge, merge_backend=backend, pair_capacity="whp")
    run_both(float_keys("nans", seed=4).astype(ml_dtypes.bfloat16), cfg, n_values)


def noncanonical_nan_keys(seed: int = 5) -> np.ndarray:
    """(8, 64) bfloat16 keys, every 9th a NaN with non-canonical bits:
    ``0xffff`` and ``0x7f81`` in turn (torch's own bfloat16 NaN on the CPU
    is ``0xffff``)."""
    import ml_dtypes

    x = np.random.default_rng(seed).standard_normal((8, 64)).astype(np.float32).astype(ml_dtypes.bfloat16)
    flat = x.view(np.uint16).reshape(-1)
    at = np.arange(0, flat.size, 9)
    flat[at] = np.where(np.arange(at.size) % 2 == 0, 0xFFFF, 0x7F81)
    return x


#: Ph6 merge and substrate of the F5 grid
F5_MERGES = [("sort", "xla"), ("tree", "xla"), ("tree", "pallas")]
F5_CASES = [dict(local_sort=ls, merge=m, merge_backend=b, routing=r,
                 pair_capacity="whp" if r == "a2a_dense" and ls != "radix" else "exact")
            for ls in ("lax", "bitonic", "radix") for m, b in F5_MERGES for r in ("a2a_dense", "ring")]
F5_CASES += [dict(route="radix", local_sort="lax", pair_capacity="exact"),
             dict(route="radix", local_sort="bitonic", merge="tree", merge_backend="pallas", pair_capacity="exact")]


@pytest.mark.parametrize("n_values", [0, 1])
@pytest.mark.parametrize("cfg_kw", F5_CASES, ids=["-".join(str(v) for v in c.values()) for c in F5_CASES])
def test_bfloat16_noncanonical_nans_match_reference(cfg_kw, n_values):
    """F5: the reference's bfloat16 ops rewrite a NaN to the quiet NaN of
    its sign (``0xffff`` -> ``0xffc0``, ``0x7f81`` -> ``0x7fc0``) wherever
    they compute on it; the port's output must carry the same bits, over
    Ph2 × Ph6 × routing and the radix route. Tolerance: exact bytes."""
    import jax.numpy as jnp

    ref = reference()
    x = noncanonical_nan_keys()
    p, n_p = x.shape
    vals = [np.arange(x.size, dtype=np.int32).reshape(x.shape)][:n_values]
    rcfg = ref.SortConfig(p=p, n_per_proc=n_p, **cfg_kw)
    rres, rvals, rstats = ref.bsp_sort_safe(jnp.asarray(x), rcfg, values=[jnp.asarray(v) for v in vals])
    res, pvals, stats = bsp_sort_safe(
        to_torch(x), config_from_reference(config_fields(rcfg)), values=vals, device="cpu"
    )
    assert_bytes(rres.buf, res.buf, "buf")
    assert_bytes(rres.count, res.count, "count")
    for rv, pv in zip(rvals, pvals):
        assert_bytes(rv, pv, "payload")
    assert stats.as_row() == rstats.as_row()


DET_TREE_PALLAS = dict(algorithm="det", local_sort="bitonic", merge="tree", merge_backend="pallas",
                       pair_capacity="whp")


@pytest.mark.parametrize("keys", ["U", "U with a ±0.0 band", "signed_zeros", "nans"])
def test_det_float32_on_the_kernels_tree_matches_reference(keys):
    """det float32 with the tree merge on the kernels, as the full-width
    float path runs it: U keys cast to float32, the same with one key in
    16 replaced by -0.0 or +0.0, and the ±0.0 and NaN key sets."""
    from repro_torch.core import datagen

    if keys.startswith("U"):
        x = datagen.generate("U", P, NP).astype(np.float32)
        if keys != "U":
            pick = np.random.default_rng(3).integers(0, 32, x.shape)
            x = np.where(pick == 0, np.float32(-0.0), np.where(pick == 1, np.float32(0.0), x))
    else:
        x = float_keys(keys, seed=4)
    run_both(x, DET_TREE_PALLAS, 0)


@pytest.mark.parametrize("keyset", ["U", "nans"])
def test_tree_tail_hands_the_kernel_one_nan_flag_a_rung(keyset, monkeypatch):
    """Every K3 call of a float sort's tree tail gets the NaN flag reduced
    once from the rung's keys, a one-element bool tensor (never read on the
    host), False exactly when the keys hold no NaN; the bytes are those of
    the flag-free merge."""
    from repro_torch.core import SortConfig, datagen
    from repro_torch.kernels.merge_path import ops as mops

    x = datagen.generate("U", P, NP).astype(np.float32) if keyset == "U" else float_keys(keyset, seed=6)
    cfg = SortConfig(p=P, n_per_proc=NP, **DET_TREE_PALLAS)
    want, _, _ = bsp_sort_safe(torch.from_numpy(x), cfg, device="cpu")
    flags = []
    merge = mops.merge_partitioned

    def spy(a, b, width=None, has_nan=None):
        flags.append(has_nan)
        return merge(a, b, width)

    monkeypatch.setattr(mops, "merge_partitioned", spy)
    got, _, _ = bsp_sort_safe(torch.from_numpy(x), cfg, device="cpu")
    assert flags and len(flags) % 3 == 0  # lg 8 rounds a rung
    for rung in range(0, len(flags), 3):
        assert all(f is flags[rung] for f in flags[rung:rung + 3])
    assert all(f.dtype == torch.bool and f.numel() == 1 and bool(f) == bool(np.isnan(x).any()) for f in flags)
    assert torch.equal(got.buf.view(torch.int32), want.buf.view(torch.int32))
