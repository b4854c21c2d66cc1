"""``route="radix"`` — count-then-distribute — against the JAX package.

Every mix of the reference's radix benchmark (``dense_int`` over 4p
values, ``expert_id`` over p, ``U``, ``zipf_skew`` and ``U64``, int64 under
the reference's 64-bit scope) runs end to end through both packages'
``bsp_sort_safe``: buf, count, flag, payloads and tiers byte-identical,
one ``"radix"`` rung and no retry. Float keys take the reference's value
cast to unsigned (saturating, NaN to 0), which ``-0.0``, NaN, ±inf and
values past 2³² exercise, and the NaNs a bitonic network leaves in place
make ``dest`` fall, which only the replayed search gives. The counting
pass, the host counts and the one rung's sizes are held on their own.
Tolerance: exact bytes, with one stated exception: under the reference's
64-bit scope ``jnp.sum`` widens the sort tail's receive count to int64;
the port keeps int32 counts, compared by value there.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import bsp_sort_safe, config_from_reference, datagen
from repro_torch.core.api import _radix_exact_ladder
from repro_torch.core.sort_radix import host_send_counts, prepare_radix_spmd, radix_boundaries
from test_torch_float_keys import assert_bytes, to_torch
from test_torch_harness import assert_same, config_fields, reference, x64

P, NP = 8, 512
I64 = np.iinfo(np.int64)


def mix(name: str, p: int = P, n_p: int = NP) -> np.ndarray:
    """The reference benchmark's radix mixes (``benchmarks/tables.py``)."""
    if name == "dense_int":
        return datagen.dense_int(p, n_p, seed=21, domain=4 * p)
    if name == "expert_id":
        return datagen.dense_int(p, n_p, seed=22, domain=p)
    if name == "U":
        return datagen.generate("U", p, n_p, seed=21)
    if name == "zipf_skew":
        return datagen.generate("zipf", p, n_p, seed=21)
    x = np.random.default_rng(21).integers(-(2**62), 2**62, (p, n_p), dtype=np.int64)
    x[0, :2] = (I64.min, I64.max)
    return x


def run_both(x: np.ndarray, cfg_kw: dict, n_values: int = 0):
    """Both packages' overflow-safe sorts; bytes and counters must agree."""
    import jax.numpy as jnp

    ref = reference()
    p, n_p = x.shape
    vals = [np.arange(x.size, dtype=np.int32).reshape(x.shape)][:n_values]
    rcfg = ref.SortConfig(p=p, n_per_proc=n_p, route="radix", **cfg_kw)
    with x64(x.dtype == np.int64):
        rres, rvals, rstats = ref.bsp_sort_safe(jnp.asarray(x), rcfg, values=[jnp.asarray(v) for v in vals])
        rbuf, rcount, rover = (np.asarray(a) for a in (rres.buf, rres.count, rres.overflow))
        rvals = [np.asarray(v) for v in rvals]
    res, pvals, stats = bsp_sort_safe(
        to_torch(x), config_from_reference(config_fields(rcfg)), values=vals, device="cpu"
    )
    assert_bytes(rbuf, res.buf, "buf")
    if x.dtype == np.int64:  # the 64-bit scope widens the sort tail's count sum
        assert np.array_equal(rcount, res.count.numpy()) and res.count.dtype == torch.int32
    else:
        assert_same(rcount, res.count, "count")
    assert bool(rover) == bool(res.overflow)
    assert len(pvals) == n_values
    for rv, pv in zip(rvals, pvals):
        assert_same(rv, pv, "payload")
    assert stats.as_row() == rstats.as_row()
    assert stats.attempts == {"radix": 1} and stats.retries == 0
    return res


#: (local_sort, merge, merge_backend, payloads)
CONFIGS = [
    ("bitonic", "tree", "pallas", 0),
    ("lax", "sort", "xla", 1),
    ("radix", "tree", "xla", 1),
]


@pytest.mark.parametrize("local_sort,merge,backend,n_values", CONFIGS)
@pytest.mark.parametrize("name", ["dense_int", "expert_id", "U", "zipf_skew", "U64"])
def test_radix_route_matches_reference(name, local_sort, merge, backend, n_values):
    x = mix(name)
    cfg = dict(local_sort=local_sort, merge=merge, merge_backend=backend, pair_capacity="exact")
    res = run_both(x, cfg, n_values)
    out = np.concatenate([res.buf[k, : int(res.count[k])].numpy() for k in range(P)])
    assert np.array_equal(out, np.sort(x.ravel()))


def float_keys(dtype: str, seed: int = 0) -> np.ndarray:
    """±0.0, NaN (both signs), ±inf, fractions, negatives and values past
    2³² (the saturating cast's every branch)."""
    choice = np.asarray([-0.0, 0.0, np.nan, -np.nan, np.inf, -np.inf, 0.5, 3.7, -1.5, -3e9, 5e9,
                         7e4, 123.0], np.float32)
    x = choice[np.random.default_rng(seed).integers(0, len(choice), (P, NP))]
    if dtype == "bfloat16":
        import ml_dtypes

        return x.astype(ml_dtypes.bfloat16)
    return x


@pytest.mark.parametrize("n_values", [0, 1])
@pytest.mark.parametrize("local_sort,merge,backend", [("lax", "sort", "xla"), ("bitonic", "tree", "pallas"),
                                                      ("bitonic", "sort", "xla")])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_float_keys_take_the_saturating_cast(dtype, local_sort, merge, backend, n_values):
    cfg = dict(local_sort=local_sort, merge=merge, merge_backend=backend, pair_capacity="exact")
    run_both(float_keys(dtype), cfg, n_values)


def reference_boundaries(xs: np.ndarray) -> np.ndarray:
    import jax
    import jax.numpy as jnp

    reference()
    from repro.core.sort_radix import radix_boundaries as ref_boundaries

    with x64(xs.dtype == np.int64):
        fn = jax.vmap(lambda r: ref_boundaries(r, xs.shape[0], "bsp"), axis_name="bsp")
        return np.asarray(fn(jnp.asarray(xs)))


@pytest.mark.parametrize("name", ["dense_int", "expert_id", "U", "zipf_skew", "U64", "float32", "bfloat16",
                                  "int64 full range", "one key"])
def test_radix_boundaries_and_host_counts_match_reference(name):
    if name in ("float32", "bfloat16"):
        x = float_keys(name, seed=3)
        xs = np.sort(x.astype(np.float32), axis=1).astype(x.dtype)
    elif name == "int64 full range":
        xs = np.sort(np.random.default_rng(4).integers(I64.min, I64.max, (P, NP), dtype=np.int64), axis=1)
        xs[0, 0], xs[-1, -1] = I64.min, I64.max
    elif name == "one key":
        xs = np.full((P, NP), 123456, np.int32)
    else:
        xs = np.sort(mix(name), axis=1)
    want = reference_boundaries(xs)
    got = radix_boundaries(to_torch(xs), P)
    assert_same(want, got, "boundaries")
    reference()
    from repro.core.sort_radix import host_send_counts as ref_counts

    assert_same(ref_counts(want), host_send_counts(got), "send counts")


@pytest.mark.parametrize("name", ["dense_int", "zipf_skew", "U64"])
def test_one_rung_sizes_match_reference(name):
    """The rung's ``pair_cap_override`` and ``n_max_override``."""
    import jax.numpy as jnp

    ref = reference()
    from repro.core.api import SortExecutor, _radix_exact_ladder as ref_ladder

    x = mix(name)
    rcfg = ref.SortConfig(p=P, n_per_proc=NP, route="radix", pair_capacity="exact")
    with x64(x.dtype == np.int64):
        rprep = SortExecutor().prepare_vmap(rcfg, 0)(jnp.asarray(x))
        ((rname, rtier),) = ref_ladder(rcfg, rprep)
    cfg = config_from_reference(config_fields(rcfg))
    ((name_, tier),) = _radix_exact_ladder(cfg, prepare_radix_spmd(torch.from_numpy(x), cfg))
    assert name_ == rname == "radix"
    fields = {f.name for f in dataclasses.fields(tier)}
    assert {k: getattr(tier, k) for k in fields} == {k: v for k, v in config_fields(rtier).items() if k in fields}
    assert (tier.pair_cap, tier.n_max) == (rtier.pair_cap, rtier.n_max)


def test_one_bucket_skew_needs_one_rung():
    """Every key equal: the whole input lands in one range bucket, and the
    counted capacity still fits it on the first and only rung."""
    x = np.full((P, 256), 123456, np.int32)
    res = run_both(x, dict(pair_capacity="exact", algorithm="det"))
    assert int(res.count.sum()) == x.size
