"""Edge cases of the K2 and K3 wrappers that the merge-path kernels rely on.

K2 (``kernels/searchsorted/ops.py``) reads one query row broadcast over
the rows in place (row stride 0), classes rows by the order of their run
and queries, and returns counts that never exceed n without a clamp. K3
(``kernels/merge_path/ops.py``) cuts int32 merges into spans of
``int_span(width)`` outputs and clips to ``width``. On the CPU the
wrappers take their plain versions, so these tests hold that wrapper
logic and the plain versions against the JAX package's ops, run with its
Pallas kernels in interpret mode, row by row. Tolerance: exact bytes.
"""
from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.merge_path import ops as mops
from repro_torch.kernels.searchsorted import ops as sops
from test_torch_harness import assert_same, reference

INT_MAX = np.iinfo(np.int32).max


def _ref_ops(name: str):
    reference()
    return importlib.import_module(f"repro.kernels.{name}.ops")


def _rank_in_rows(data: np.ndarray, queries: np.ndarray, side: str) -> np.ndarray:
    """The JAX package's ``rank_in`` (one run per call), row by row."""
    import jax.numpy as jnp

    ops = _ref_ops("searchsorted")
    return np.stack([np.asarray(ops.rank_in(jnp.asarray(d), jnp.asarray(q), side=side))
                     for d, q in zip(data, queries)])


def _runs(rng, rows: int, n: int, hi: int = 60) -> np.ndarray:
    """Sorted int32 runs with sentinel tails of random length."""
    x = np.sort(rng.integers(0, hi, (rows, n)).astype(np.int32), axis=-1)
    for r, keep in enumerate(rng.integers(0, n + 1, rows)):
        x[r, keep:] = INT_MAX
    return x


@pytest.mark.parametrize("side", ["left", "right"])
def test_rank_in_query_row_broadcast(side):
    """The merge tail's output slots: arange(2w) expanded over the rows,
    ranked in strictly increasing rank positions; read with row stride 0."""
    rng = np.random.default_rng(20)
    rows, w = 3, 150
    pos = np.sort(rng.choice(2 * w + 40, (rows, w), replace=True), axis=-1).astype(np.int32)
    pos = pos + np.arange(w, dtype=np.int32)  # strictly increasing
    o = torch.arange(2 * w, dtype=torch.int32).expand(rows, 2 * w)
    assert sops.query_row_stride(o) == 0
    assert sops._rows(o).data_ptr() == o.data_ptr()  # not copied
    want = _rank_in_rows(pos, np.broadcast_to(np.arange(2 * w, dtype=np.int32), (rows, 2 * w)), side)
    assert_same(want, sops.rank_in(torch.from_numpy(pos), o, side=side), "broadcast row")


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_rank_in_sorted_and_unsorted_queries(side, order):
    """Sorted query rows (the merge route) and the same queries shuffled
    (the search route) give the same ranks, the reference's."""
    rng = np.random.default_rng(21)
    data = _runs(rng, 3, 200)
    q = _runs(rng, 3, 330, hi=70)
    if order == "shuffled":
        q = rng.permuted(q, axis=-1)
    want = _rank_in_rows(data, q, side)
    assert_same(want, sops.rank_in(torch.from_numpy(data), torch.from_numpy(q), side=side), order)


@pytest.mark.parametrize("side", ["left", "right"])
def test_rank_in_nan_runs(side):
    """Float runs with ±0.0 ties: row 0 with a NaN inside (out of order, the
    masked count), row 1 with a NaN tail (in order); queries sorted in row
    0, with NaN keys in row 1."""
    rng = np.random.default_rng(22)
    choice = np.asarray([-0.0, 0.0, 1.0, -1.0, np.inf], np.float32)
    data = np.sort(choice[rng.integers(0, 5, (2, 180))], axis=-1)
    data[0, 90] = np.nan
    data[1, -20:] = np.nan
    q = np.sort(choice[rng.integers(0, 5, (2, 260))], axis=-1)
    q[1, -7:] = np.nan
    want = _rank_in_rows(data, q, side)
    assert_same(want, sops.rank_in(torch.from_numpy(data), torch.from_numpy(q), side=side), "NaN runs")


@pytest.mark.parametrize("order", ["lexicographic", "as drawn"])
def test_splitter_ranks_tagged(order):
    """Tagged splitters with ties on the key, sorted by (key, proc, idx) per
    row (the merge route) and as drawn (the search route)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(23)
    rows, n, s = 3, 250, 40
    x = np.sort(rng.integers(0, 30, (rows, n)).astype(np.int32), axis=-1)
    sk = np.take_along_axis(x, rng.integers(0, n, (rows, s)), axis=-1)
    sp = rng.integers(0, 8, (rows, s)).astype(np.int32)
    si = rng.integers(0, n, (rows, s)).astype(np.int32)
    me = rng.integers(0, 8, rows).astype(np.int32)
    if order == "lexicographic":
        perm = np.lexsort((si, sp, sk), axis=-1)
        sk, sp, si = (np.take_along_axis(t, perm, axis=-1) for t in (sk, sp, si))
    ops = _ref_ops("searchsorted")
    want = np.stack([
        np.asarray(ops.splitter_ranks(jnp.asarray(x[r]), jnp.asarray(sk[r]), jnp.asarray(sp[r]),
                                      jnp.asarray(si[r]), jnp.asarray(me[r])))
        for r in range(rows)
    ])
    got = sops.splitter_ranks(*(torch.from_numpy(t) for t in (x, sk, sp, si, me)))
    assert_same(want, got, order)


def test_splitter_ranks_float_runs_with_nans():
    """+inf splitter keys on runs with NaN tails: the JAX wrapper's +inf
    pads count by the tagged compare (proc below, equal with idx past n,
    above), then the clamp to n."""
    import jax.numpy as jnp

    rng = np.random.default_rng(27)
    rows, n, s = 4, 150, 24
    x = np.sort(rng.integers(0, 5, (rows, n)).astype(np.float32), axis=-1)
    x[:, -rng.integers(1, 60, rows)[0]:] = np.nan
    x[1, 3] = np.inf
    sk = np.where(rng.random((rows, s)) < 0.5, np.inf, rng.integers(0, 5, (rows, s))).astype(np.float32)
    sp = rng.integers(2, 5, (rows, s)).astype(np.int32)
    si = rng.integers(n - 20, n + 200, (rows, s)).astype(np.int32)
    me = np.full(rows, 3, np.int32)
    ops = _ref_ops("searchsorted")
    want = np.stack([
        np.asarray(ops.splitter_ranks(jnp.asarray(x[r]), jnp.asarray(sk[r]), jnp.asarray(sp[r]),
                                      jnp.asarray(si[r]), jnp.asarray(me[r])))
        for r in range(rows)
    ])
    got = sops.splitter_ranks(*(torch.from_numpy(t) for t in (x, sk, sp, si, me)))
    assert_same(want, got, "float pads")


@pytest.mark.parametrize("side", ["left", "right"])
def test_ranks_never_above_n(side):
    """Sentinel-valued queries over runs that end in sentinels: the count
    is over the n real elements, so no clamp is needed to stay <= n."""
    rng = np.random.default_rng(24)
    n = 130
    data = _runs(rng, 3, n)
    data[0, -30:] = INT_MAX
    q = np.full((3, 50), INT_MAX, np.int32)
    q[:, :10] = np.sort(rng.integers(0, 60, (3, 10)), axis=-1)
    got = sops.rank_in(torch.from_numpy(data), torch.from_numpy(q), side=side)
    assert int(got.max()) <= n
    assert_same(_rank_in_rows(data, q, side), got, "sentinel queries")


def test_query_row_stride_layouts():
    q = torch.zeros((4, 6), dtype=torch.int32)
    assert sops.query_row_stride(q) == 6
    assert sops.query_row_stride(q[:1]) == 6
    assert sops.query_row_stride(q[0].expand(4, 6)) == 0
    assert sops.query_row_stride(torch.zeros((6, 4), dtype=torch.int32).t()) is None
    assert sops.query_row_stride(q[:, ::2]) is None
    assert sops.query_row_stride(q[:1, ::2]) is None  # one row, not contiguous
    assert sops.query_row_stride(q[:1, :1]) == 1
    strided = q[:, ::2]
    assert sops._rows(strided).is_contiguous()
    assert sops._rows(torch.arange(5)).shape == (1, 5)
    one = torch.arange(10, dtype=torch.int32)[::2]
    assert sops.query_row_stride(one.reshape(1, -1)) is None
    assert sops._rows(one).is_contiguous() and sops._rows(one).tolist() == [[0, 2, 4, 6, 8]]


@pytest.mark.parametrize("side", ["left", "right"])
def test_rank_in_strided_query_row(side):
    """One run and a 1-D query tensor that is a strided view (every other
    element): ranked as the copy of its elements would be."""
    rng = np.random.default_rng(28)
    data = _runs(rng, 1, 120)[0]
    q = np.sort(rng.integers(0, 70, 90).astype(np.int32))
    want = _rank_in_rows(data[None], q[None, ::2], side)[0]
    assert_same(want, sops.rank_in(torch.from_numpy(data), torch.from_numpy(q)[::2], side=side), "strided")


#: (rows, W, widths to check) — width < 2W, W = 1, and widths straddling
#: the int32 route's spans (2816 = 256 x 11, 3840 = 256 x 15)
MERGE_CASES = [
    (3, 1, (1, 2)),
    (2, 300, (1, 299, 301, 600)),
    (2, 1921, (2815, 2816, 2817, 3840, 3841, 3842)),
]


@pytest.mark.parametrize("rows,w,widths", MERGE_CASES)
def test_merge_partitioned_widths(rows, w, widths):
    import jax.numpy as jnp

    rng = np.random.default_rng(25)
    a, b = _runs(rng, rows, w, hi=1000), _runs(rng, rows, w, hi=1000)
    want = np.asarray(_ref_ops("merge_path").merge_partitioned(jnp.asarray(a), jnp.asarray(b)))
    for width in widths:
        got = mops.merge_partitioned(torch.from_numpy(a), torch.from_numpy(b), width=width)
        assert_same(want[:, :width], got, f"width {width}")


@pytest.mark.parametrize("case", ["a all sentinel", "b all sentinel", "all equal"])
def test_merge_partitioned_degenerate_sides(case):
    import jax.numpy as jnp

    rng = np.random.default_rng(26)
    rows, w = 2, 700
    a = _runs(rng, rows, w, hi=100)
    b = np.full((rows, w), INT_MAX, np.int32)
    if case == "a all sentinel":
        a, b = b, a
    elif case == "all equal":
        a, b = np.full((rows, w), 7, np.int32), np.full((rows, w), 7, np.int32)
    want = np.asarray(_ref_ops("merge_path").merge_partitioned(jnp.asarray(a), jnp.asarray(b)))
    got = mops.merge_partitioned(torch.from_numpy(a), torch.from_numpy(b))
    assert_same(want, got, case)
    assert_same(want[:, :1000], mops.merge_partitioned(torch.from_numpy(a), torch.from_numpy(b), 1000),
                f"{case}, clipped")


@pytest.mark.parametrize("out_w", [1, 2, 255, 256, 257, 2512, 2816, 2817, 3840, 3841, 5024, 79008, 131072])
def test_int_span_covers_each_row(out_w):
    """Spans are whole blocks of an odd item count within the limit, cover
    the row, and none of them is empty."""
    span = mops.int_span(out_w)
    items = span // mops.THREADS
    assert span % mops.THREADS == 0 and items % 2 == 1 and items <= mops.MAX_ITEMS
    spans = -(-out_w // span)
    assert spans * span >= out_w > (spans - 1) * span
    assert spans == -(-out_w // (mops.THREADS * mops.MAX_ITEMS))
