"""The K1–K4 wrappers against the JAX package's kernel ops.

On the CPU every wrapper takes its kernel's plain version, so these tests
hold the padding, tiling, clamping and window logic around each kernel,
and the plain version itself, against the Pallas kernels run in interpret
mode. The cases are those of ``tests/test_kernels_fast.py`` plus a
multi-tile K1 row, K1's uint32 and bfloat16 keys, the key-value sort K4,
keys whose ties differ in their bits (the networks are not stable), and
K2 and K3 on int64 keys (the reference under its 64-bit scope).
Tolerance: exact bytes. The kernels themselves run on the card
(``test_kernels_match_plain_on_card``); K1 and K4's source also runs on the
CPU in ``test_torch_bitonic_emulated.py``.
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
from test_torch_harness import assert_same, reference, x64


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


#: every key dtype at the narrow widths and past one tile; the wide tiles
#: (slow in interpret mode) for one integer and one float dtype
KV_CASES = [
    (kind, shape)
    for kind in ("int32", "uint32", "float32", "bfloat16")
    for shape in ((1, 17), (5, 100), (1, 16384 + 300))
] + [(kind, shape) for kind in ("int32", "float32") for shape in ((3, 4096), (2, 16384))]


def _keys(kind: str, shape, seed: int) -> np.ndarray:
    """Keys with heavy ties: int32, uint32 (above 2³¹ too), float32 with
    ±0.0, or bfloat16."""
    rng = np.random.default_rng(seed)
    if kind == "int32":
        return rng.integers(0, 50, shape).astype(np.int32)
    if kind == "uint32":
        return (rng.integers(0, 40, shape).astype(np.uint32) * np.uint32(100_000_000))
    if kind == "float32":
        return np.asarray([-0.0, 0.0, 1.5, -2.0], np.float32)[rng.integers(0, 4, shape)]
    import ml_dtypes

    return rng.integers(-8, 8, shape).astype(np.float32).astype(ml_dtypes.bfloat16)


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy()).view(torch.uint32)
    return torch.from_numpy(a.copy())


def _bytes_equal(ref, got: torch.Tensor, what: str) -> None:
    r = np.asarray(ref)
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[got.element_size()]
    t = got.contiguous().view(bits).numpy()
    assert r.shape == t.shape, f"{what}: shape {t.shape} != {r.shape}"
    assert r.tobytes() == t.tobytes(), f"{what}: bytes differ"


@pytest.mark.parametrize("kind", ["uint32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 17), (5, 100), (2, 4096)])
def test_bitonic_sort_new_dtypes_match_reference(kind, shape):
    import jax.numpy as jnp

    x = _keys(kind, shape, 8)
    want = _ref_ops("bitonic").sort(jnp.asarray(x))
    got = bops.sort(_torch(x))
    assert got.dtype == _torch(x).dtype
    _bytes_equal(want, got, f"sort {kind}")


def test_bitonic_sort_multi_tile_uint32():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 2**32, (1, bops.MAX_WIDTH + 77), dtype=np.uint64).astype(np.uint32)
    _bytes_equal(np.sort(x, axis=-1), bops.sort(_torch(x)), "multi-tile uint32")


@pytest.mark.parametrize("kind,shape", KV_CASES)
def test_sort_kv_matches_reference(kind, shape):
    """Keys and values, ties and ±0.0 included, in the network's own order."""
    import jax.numpy as jnp

    keys = _keys(kind, shape, 9)
    vals = np.arange(np.prod(shape), dtype=np.int32).reshape(shape)
    rk, rv = _ref_ops("bitonic").sort_kv(jnp.asarray(keys), jnp.asarray(vals))
    gk, gv = bops.sort_kv(_torch(keys), torch.from_numpy(vals))
    _bytes_equal(rk, gk, "keys")
    _bytes_equal(rv, gv, "values")
    if shape[1] > 100:
        return
    rk1, rv1 = _ref_ops("bitonic").sort_kv(jnp.asarray(keys[0]), jnp.asarray(vals[0]))
    gk1, gv1 = bops.sort_kv(_torch(keys[0]), torch.from_numpy(vals[0]))
    _bytes_equal(rk1, gk1, "keys 1-D")
    _bytes_equal(rv1, gv1, "values 1-D")


def test_sort_kv_moves_values_of_other_widths():
    """int64 and float16 values ride the same swaps as int32 ones."""
    keys = torch.from_numpy(_keys("int32", (3, 300), 10))
    idx = torch.arange(900, dtype=torch.int32).reshape(3, 300)
    k32, v32 = bops.sort_kv(keys, idx)
    k64, v64 = bops.sort_kv(keys, idx.long())
    k16, v16 = bops.sort_kv(keys, idx.to(torch.float16))
    assert torch.equal(k32, k64) and torch.equal(k32, k16)
    assert torch.equal(v64, v32.long()) and torch.equal(v16, v32.to(torch.float16))


@pytest.mark.parametrize("keyset", ["signed_zeros", "nans"])
def test_merge_partitioned_float_ties_match_reference(keyset):
    """The merge network's order of -0.0/+0.0, and its NaN placement."""
    import jax.numpy as jnp

    rng = np.random.default_rng(12)
    choice = {"signed_zeros": [-0.0, 0.0, 3.0], "nans": [np.nan, 1.0, -1.0]}[keyset]
    a = np.asarray(choice, np.float32)[rng.integers(0, 3, (3, 1500))]
    b = np.asarray(choice, np.float32)[rng.integers(0, 3, (3, 1500))]
    if keyset == "signed_zeros":
        a, b = np.sort(a, axis=-1), np.sort(b, axis=-1)
    want = _ref_ops("merge_path").merge_partitioned(jnp.asarray(a), jnp.asarray(b))
    _bytes_equal(want, mops.merge_partitioned(torch.from_numpy(a), torch.from_numpy(b)), keyset)


def test_bitonic_sort_rejects_bad_tiles():
    with pytest.raises(ValueError):
        bops.sort_tiles(torch.zeros((2, 96), dtype=torch.int32))
    with pytest.raises(ValueError):
        bops.sort_tiles(torch.zeros((2, 2 * bops.MAX_WIDTH), dtype=torch.int32))
    assert bops.supports(torch.zeros(4, dtype=torch.float32))
    assert bops.supports(torch.zeros(4, dtype=torch.uint32))
    assert bops.supports(torch.zeros(4, dtype=torch.bfloat16))
    assert not bops.supports(torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError):
        bops.sort_kv_tiles(torch.zeros((2, 128), dtype=torch.int32), torch.zeros((2, 64)))


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
    """Each CUDA kernel equals its plain version bit for bit (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")

    def same(a, b):
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return a.dtype == b.dtype and torch.equal(a.view(bits), b.view(bits))

    g = torch.Generator(device="cuda").manual_seed(0)
    _build.reset_counts()
    for dtype in (torch.int32, torch.float32, torch.bfloat16):
        x = torch.randint(-(2**30), 2**30, (16, 16384), device="cuda", generator=g).to(dtype)
        x[0, :64] = -0.0 if dtype != torch.int32 else 0
        assert same(bops.sort_tiles(x), bref.sort_tiles(x))
        xm = torch.randint(0, 2**20, (4, 65536), device="cuda", generator=g).to(dtype)
        assert same(bops.sort(xm), torch.sort(xm, dim=-1).values)
    xu = torch.randint(0, 2**31, (16, 4096), device="cuda", generator=g).to(torch.int32)
    xu = xu.view(torch.uint32)
    assert same(bops.sort_tiles(xu), bref.sort_tiles(xu))
    # every tile width (each has its own schedule), every key dtype, with
    # ±0.0 and NaN rows for the float keys
    for dtype in (torch.int32, torch.uint32, torch.float32, torch.bfloat16):
        for lg in range(7, 15):
            x = _card_tile_keys(dtype, 4, 1 << lg, g, ties=False)
            assert same(bops.sort_tiles(x), bref.sort_tiles(x)), (dtype, 1 << lg)
    keys = torch.randint(0, 50, (8, 16384), device="cuda", generator=g).int()
    for vals in (torch.arange(8 * 16384, device="cuda").reshape(8, 16384),
                 torch.arange(8 * 16384, device="cuda", dtype=torch.int32).reshape(8, 16384),
                 torch.ones((8, 16384), device="cuda", dtype=torch.float16)):
        k, v = bops.sort_kv_tiles(keys, vals)
        rk, rv = bref.sort_kv_tiles(keys, vals)
        assert same(k, rk) and same(v, rv)
    # K4 with heavy ties (the values' order is the network's), 2-, 4- and
    # 8-byte values
    for dtype in (torch.int32, torch.uint32, torch.float32, torch.bfloat16):
        for w in (128, 512, 1024, 16384):
            k = _card_tile_keys(dtype, 3, w, g, ties=True)
            for vdt in (torch.int16, torch.int32, torch.int64):
                v = torch.randperm(3 * w, device="cuda", generator=g).reshape(3, w).to(vdt)
                gk, gv = bops.sort_kv_tiles(k, v)
                rk, rv = bref.sort_kv_tiles(k, v)
                assert same(gk, rk) and same(gv, rv), (dtype, w, vdt)
    with pytest.raises(TypeError):
        bops.sort_kv_tiles(keys, torch.zeros((8, 16384), device="cuda", dtype=torch.uint8))
    data = torch.sort(torch.randint(0, 500, (8, 1256), device="cuda", generator=g).int(), dim=-1).values
    data[1] = data[1].flip(0)  # a row out of order: the masked count
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
        choice = torch.tensor([-0.0, 0.0, float("nan"), 1.0], device="cuda")
        fa = choice[torch.randint(0, 4, (8, w), device="cuda", generator=g)]
        fb = choice[torch.randint(0, 4, (8, w), device="cuda", generator=g)]
        for dt in (torch.float32, torch.bfloat16):
            ga, gb = fa.to(dt), fb.to(dt)
            assert same(mops.merge_partitioned(ga, gb), mref.merge_windows(ga, gb, tile, 2 * w))
    _rank_merge_edges_on_card(g)
    counts = _build.counts()
    for name in ("bitonic_sort_tiles", "bitonic_sort_kv_tiles", "splitter_ranks", "merge_sorted_tiles",
                 "merge_sorted_tiles_float"):
        assert counts[name] > 0, name


def _card_tile_keys(dtype, rows, w, g, ties):
    """(rows, w) keys on the card: wide random keys, or heavy ties; float
    keys get a row of -0.0/+0.0 runs and one of NaNs (both signs), uint32
    keys run above 2³¹ and hold the sentinel."""
    if ties:
        x = torch.randint(0, 50, (rows, w), device="cuda", generator=g)
        if dtype.is_floating_point:
            choice = torch.tensor([-0.0, 0.0, 1.5, -2.0, float("nan")], device="cuda")
            return choice[x % 5].to(dtype)
        return (x.int() * 100_000_000).view(torch.uint32) if dtype == torch.uint32 else x.int()
    x = torch.randint(-(2**30), 2**30, (rows, w), device="cuda", generator=g)
    if dtype == torch.uint32:
        x = x.int() * 2
        x[0, :5] = -1  # the uint32 sentinel
        return x.view(torch.uint32)
    if not dtype.is_floating_point:
        return x.int()
    x = x.float()
    x[0, : w // 3] = -0.0
    x[0, w // 6 : w // 2] = 0.0
    x[1, ::7] = float("nan")
    x[1, 3::11] = -float("nan")
    return x.to(dtype)


def _rank_merge_edges_on_card(g):
    """K2 on each route and K3's int32 spans at their edges, bit for bit
    against the plain versions (the cases of test_torch_rank_merge_edges)."""
    imax = torch.iinfo(torch.int32).max

    def runs(rows, n, hi):
        x = torch.sort(torch.randint(0, hi, (rows, n), device="cuda", generator=g).int(), dim=-1).values
        keep = torch.randint(0, n + 1, (rows, 1), device="cuda", generator=g)
        return torch.where(torch.arange(n, device="cuda") < keep, x, imax).contiguous()

    def plain(data, q, side):
        tag = torch.full(q.shape, 1 if side == "right" else -1, dtype=torch.int32, device="cuda")
        zeros = torch.zeros(q.shape, dtype=torch.int32, device="cuda")
        return sref.ranks(data, q, tag, zeros, torch.zeros(data.shape[0], dtype=torch.int32, device="cuda"))

    pos = torch.sort(torch.randint(0, 3000, (8, 1256), device="cuda", generator=g).int(), dim=-1).values
    pos += torch.arange(1256, dtype=torch.int32, device="cuda")  # strictly increasing
    o = torch.arange(2512, dtype=torch.int32, device="cuda").expand(8, 2512)  # row stride 0
    data, q = runs(8, 1256, 500), runs(8, 2512, 520)
    wide, wq = runs(2, 79008, 10**6), runs(2, 79008, 10**6)
    step2 = (torch.arange(10, dtype=torch.int32, device="cuda")[::2],  # strided 1-D query rows
             torch.sort(torch.randint(0, 520, (900,), device="cuda", generator=g).int()).values[::2])
    for side in ("left", "right"):
        assert torch.equal(sops.rank_in(pos, o, side=side), plain(pos, o, side))
        for q1 in step2:
            assert torch.equal(sops.rank_in(pos[0], q1, side=side), plain(pos[:1], q1[None].contiguous(), side)[0])
        for qq in (q, q[:, torch.randperm(2512, device="cuda", generator=g)].contiguous()):
            assert torch.equal(sops.rank_in(data, qq, side=side), plain(data, qq, side))
        assert torch.equal(sops.rank_in(wide, wq, side=side)[:1], plain(wide[:1], wq[:1], side))
        choice = torch.tensor([-0.0, 0.0, 1.0, float("inf")], device="cuda")
        for dt, n, s in ((torch.float32, 300, 500), (torch.bfloat16, 300, 500), (torch.float32, 3000, 2000)):
            # rows of one tile, and of several (n + s > 4096)
            fd = torch.sort(choice[torch.randint(0, 4, (4, n), device="cuda", generator=g)], dim=-1).values
            fd[0, n // 2] = float("nan")  # out of order: the masked count
            fd[1, -30:] = float("nan")  # NaN tail: in order
            fq = torch.sort(choice[torch.randint(0, 4, (4, s), device="cuda", generator=g)], dim=-1).values
            fq[2, -3:] = float("nan")  # NaN queries: a search each
            fd, fq = fd.to(dt), fq.to(dt)
            got = sops._ranks(fd, fq, None, 1 if side == "right" else -1, None, None)
            assert torch.equal(got, plain(fd, fq, side))
    x = torch.sort(torch.randint(0, 40, (16, 1256), device="cuda", generator=g).int(), dim=-1).values
    keys = x.gather(1, torch.randint(0, 1256, (16, 300), device="cuda", generator=g))
    procs = torch.randint(0, 8, (16, 300), device="cuda", generator=g).int()
    idx = torch.randint(0, 1256, (16, 300), device="cuda", generator=g).int()
    me = torch.randint(0, 8, (16,), device="cuda", generator=g).int()
    order = torch.argsort((keys.long() << 32) | (procs.long() << 16) | idx.long(), dim=-1)
    for k, p, i in ([t.gather(1, order) for t in (keys, procs, idx)], (keys, procs, idx)):
        assert torch.equal(sops.splitter_ranks(x, k, p, i, me), sref.ranks(x, k, p, i, me))
        got = sops.splitter_ranks(x[0], k[0, ::2], p[0, ::2], i[0, ::2], me[0])  # strided tags too
        assert torch.equal(got, sref.ranks(x[:1], *(t[:1, ::2].contiguous() for t in (k, p, i)), me[:1])[0])
    for w, widths in ((1, (1, 2)), (1256, (2000, 2512)), (1921, (2815, 2816, 2817, 3840, 3841, 3842)),
                      (40000, (79008,))):
        a, b = runs(4, w, 10**6), runs(4, w, 10**6)
        tile = min(mops.TILE, mops._pow2_at_least(w))
        for width in widths:
            assert torch.equal(mops.merge_partitioned(a, b, width), mref.merge_windows(a, b, tile, width))
    a = runs(8, 700, 100)
    sent, same = torch.full_like(a, imax), torch.full_like(a, 7)
    for pa, pb in ((a, sent), (sent, a), (same, same.clone())):
        for width in (1000, 1400):
            assert torch.equal(mops.merge_partitioned(pa, pb, width), mref.merge_windows(pa, pb, 1024, width))


I64 = np.iinfo(np.int64)


def _int64_runs(rows: int, n: int, seed: int, tails: bool = True) -> np.ndarray:
    """Sorted int64 rows over the whole range, the extremes included, with
    sentinel (int64 max) tails of random length."""
    rng = np.random.default_rng(seed)
    x = rng.integers(I64.min, I64.max, (rows, n), dtype=np.int64)
    x[0, :3] = I64.min
    x[-1, -2:] = I64.max
    x[:, 5:9] = x[:, 4:5]  # ties
    x = np.sort(x, axis=-1)
    if tails:
        keep = rng.integers(0, n + 1, (rows, 1))
        x = np.where(np.arange(n) < keep, x, I64.max)
    return x


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("n,q", [(256, 256), (1000, 100), (5000, 2048)])
def test_rank_in_int64_matches_reference(side, n, q):
    import jax.numpy as jnp

    data = _int64_runs(2, n, 20)
    queries = np.random.default_rng(21).integers(I64.min, I64.max, (2, q), dtype=np.int64)
    queries[:, :4] = (I64.min, I64.max, data[0, 7], data[1, n // 2])
    with x64():
        ops = _ref_ops("searchsorted")
        want = np.stack([np.asarray(ops.rank_in(jnp.asarray(d), jnp.asarray(qq), side=side))
                         for d, qq in zip(data, queries)])
    assert_same(want, sops.rank_in(torch.from_numpy(data), torch.from_numpy(queries), side=side), "ranks")
    # the merge tail's broadcast query row (stride 0)
    o = torch.arange(q, dtype=torch.int64).expand(2, q)
    pos = np.sort(np.random.default_rng(22).integers(0, 3 * q, (2, n)), axis=-1) + np.arange(n)
    with x64():
        want = np.stack([np.asarray(ops.rank_in(jnp.asarray(r), jnp.arange(q, dtype=jnp.int64), side=side))
                         for r in pos])
    assert_same(want, sops.rank_in(torch.from_numpy(pos), o, side=side), "broadcast ranks")


def test_splitter_ranks_int64_matches_reference():
    import jax.numpy as jnp

    x = _int64_runs(1, 1000, 23, tails=False)[0]
    rng = np.random.default_rng(24)
    sk = x[rng.integers(0, 1000, 31)]
    sp = rng.integers(0, 8, 31).astype(np.int32)
    si = rng.integers(0, 1000, 31).astype(np.int32)
    with x64():
        want = _ref_ops("searchsorted").splitter_ranks(
            jnp.asarray(x), jnp.asarray(sk), jnp.asarray(sp), jnp.asarray(si), jnp.asarray(3, jnp.int32)
        )
        want = np.asarray(want)
    got = sops.splitter_ranks(torch.from_numpy(x), torch.from_numpy(sk), torch.from_numpy(sp),
                              torch.from_numpy(si), 3)
    assert_same(want, got, "splitter_ranks int64")


@pytest.mark.parametrize("w,width", [(100, None), (1500, None), (1500, 1507), (64, 100), (1, 1)])
def test_merge_partitioned_int64_matches_reference(w, width):
    import jax.numpy as jnp

    a, b = _int64_runs(3, w, 25), _int64_runs(3, w, 26)
    b[1] = I64.max  # one side all sentinel
    with x64():
        want = np.asarray(_ref_ops("merge_path").merge_partitioned(jnp.asarray(a), jnp.asarray(b)))
    out_w = 2 * w if width is None else width
    got = mops.merge_partitioned(torch.from_numpy(a), torch.from_numpy(b), width=width)
    assert_same(want[:, :out_w], got, "merge_partitioned int64")
    assert_same(np.sort(np.concatenate([a, b], axis=-1), axis=-1)[:, :out_w], got, "oracle")


@pytest.mark.cuda
def test_int64_kernels_match_plain_on_card():
    """K2 and K3 on int64 keys equal their plain versions bit for bit (needs
    the card): rows of one tile and of several, sorted, unsorted and
    broadcast query rows, tagged splitters, clipped merge widths, the
    int64 extremes; and the launches count under their int64 names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    _build.reset_counts()

    def plain(data, q, side):
        tag = torch.full(q.shape, 1 if side == "right" else -1, dtype=torch.int32, device="cuda")
        zeros = torch.zeros(q.shape, dtype=torch.int32, device="cuda")
        return sref.ranks(data, q, tag, zeros, torch.zeros(data.shape[0], dtype=torch.int32, device="cuda"))

    g = np.random.default_rng(30)
    for rows, n, s in ((16, 1256, 2512), (4, 5000, 3000), (2, 79008, 79008)):
        data = torch.from_numpy(_int64_runs(rows, n, 31)).cuda()
        q = torch.from_numpy(_int64_runs(rows, s, 32)).cuda()
        shuffled = q[:, torch.from_numpy(g.permutation(s)).cuda()].contiguous()
        for side in ("left", "right"):
            for qq in (q, shuffled):
                assert torch.equal(sops.rank_in(data, qq, side=side)[:2], plain(data[:2], qq[:2], side))
    pos = torch.from_numpy(np.sort(g.integers(0, 3000, (8, 1256)), axis=-1) + np.arange(1256)).cuda()
    o = torch.arange(2512, dtype=torch.int64, device="cuda").expand(8, 2512)
    for side in ("left", "right"):
        assert torch.equal(sops.rank_in(pos, o, side=side), plain(pos, o.contiguous(), side))
    x = torch.from_numpy(_int64_runs(16, 1256, 33, tails=False)).cuda()
    keys = x.gather(1, torch.from_numpy(g.integers(0, 1256, (16, 300))).cuda())
    procs = torch.from_numpy(g.integers(0, 8, (16, 300)).astype(np.int32)).cuda()
    idx = torch.from_numpy(g.integers(0, 1256, (16, 300)).astype(np.int32)).cuda()
    me = torch.from_numpy(g.integers(0, 8, 16).astype(np.int32)).cuda()
    assert torch.equal(sops.splitter_ranks(x, keys, procs, idx, me), sref.ranks(x, keys, procs, idx, me))
    for rows, w, widths in ((64, 1256, (2512, 2000)), (8, 3000, (5001, 6000)), (4, 40000, (79008,)),
                            (100, 1, (1, 2))):
        a = torch.from_numpy(_int64_runs(rows, w, 34)).cuda()
        b = torch.from_numpy(_int64_runs(rows, w, 35)).cuda()
        tile = min(mops.TILE, mops._pow2_at_least(w))
        for width in widths:
            assert torch.equal(mops.merge_partitioned(a, b, width), mref.merge_windows(a, b, tile, width))
    counts = _build.counts()
    assert counts["splitter_ranks_int64"] > 0 and counts["merge_sorted_tiles_int64"] > 0
    assert counts.get("splitter_ranks", 0) == 0 and counts.get("merge_sorted_tiles", 0) == 0
