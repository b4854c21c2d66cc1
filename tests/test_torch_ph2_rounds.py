"""Ph2's merge rounds after the K1 tiles (``kernels/bitonic/ops.py`` ``sort``)
against the JAX package's ``bitonic.ops.sort``, on the CPU.

Integer rows take K3's merge path on the card; here the same round loop
runs through ``merge_partitioned``'s plain window merge (the route is
forced), so the pairing of each round's rows (even with odd), the doubling
widths, the uint32 bias and the last round's clip to n are held without a
card. That window merge copies its views contiguous first: K3's reads at a
row stride are held by ``tests/test_torch_merge_path_emulated.py`` and on
the card by
``tests/test_torch_kernels.py::test_bitonic_sort_merge_path_rounds_on_card``.
Float rows keep the rank merges.
Tolerance: exact bytes.
"""
from __future__ import annotations

import contextlib

import numpy as np
import pytest

from repro_torch.kernels.bitonic import ops as bops
from repro_torch.kernels.merge_path import ops as mops
from test_torch_kernels import _bytes_equal, _ref_ops, _torch


class _StageLog:
    """Stands in for ``obs.trace.stage`` in ``kernels/bitonic/ops.py``:
    records each stage's name and counts."""

    def __init__(self):
        self.seen = []

    def __call__(self, name, **counts):
        self.seen.append((name, counts))
        return contextlib.nullcontext()


#: tiles a row -> (n a power of two, n short of one): both pad to the same width
ROUND_CASES = {
    2: (2 * bops.MAX_WIDTH, bops.MAX_WIDTH + 300),
    4: (4 * bops.MAX_WIDTH, 3 * bops.MAX_WIDTH + 5),
    64: (64 * bops.MAX_WIDTH, 64 * bops.MAX_WIDTH - 1000),
}


@pytest.mark.parametrize("kind", ["int32", "uint32"])
@pytest.mark.parametrize("tiles", sorted(ROUND_CASES))
def test_bitonic_sort_merge_path_rounds_match_reference(monkeypatch, kind, tiles):
    """Ph2's K3 rounds, driven on the CPU through ``merge_partitioned``'s
    window merge: pairs taken as the even and odd rows of each round's
    buffer, the widths doubling, the uint32 bias, the last round clipped to
    n; the bytes are the JAX package's ``bitonic.ops.sort``, and the stage
    says which route ran and how many rounds. One reference call holds
    both sizes: the short rows padded with the sentinel as that wrapper
    pads them (integer keys equal to the sentinel are equal in every bit)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(tiles * 7 + len(kind))
    rows = 2 if tiles < 64 else 1
    dt, top = (np.int32, np.iinfo(np.int32).max) if kind == "int32" else (np.uint32, np.iinfo(np.uint32).max)
    w = ROUND_CASES[tiles][0]
    x = rng.integers(np.iinfo(dt).min, top, (2 * rows, w), dtype=np.int64).astype(dt)
    x[0, :40] = top  # real keys equal to the sentinel
    x[-1, 100:3000] = top // 2 + 7  # a run of ties across a tile
    x[rows:, ROUND_CASES[tiles][1]:] = top  # the short rows as the reference pads them
    want = np.asarray(_ref_ops("bitonic").sort(jnp.asarray(x)))
    monkeypatch.setattr(bops, "_merge_route", lambda t: "merge_path")
    rounds = tiles.bit_length() - 1
    for half, n in enumerate(ROUND_CASES[tiles]):
        part = slice(half * rows, (half + 1) * rows)
        log = _StageLog()
        monkeypatch.setattr(bops, "stage", log)
        before = mops.LAUNCHES.n
        got = bops.sort(_torch(x[part, :n]))
        assert got.shape == (rows, n) and got.dtype == _torch(x).dtype
        _bytes_equal(want[part, :n], got, f"{kind} n={n}")
        assert mops.LAUNCHES.n == before  # the CPU route launches nothing
        assert log.seen[-1] == ("local_sort.rank_merge", {"keys": rows * w, "route": "merge_path", "rounds": rounds})


@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_bitonic_sort_float_tiles_keep_rank_merges(monkeypatch, kind):
    """Float rows take the rank merges, bit for bit the JAX package's: a row
    of -0.0/+0.0 ties, and a row with NaNs of both signs, whose tiles the
    network leaves out of order, so that two keys can take one position
    and leave another holding the JAX wrapper's zero."""
    import jax.numpy as jnp

    rng = np.random.default_rng(60)
    n = 3 * bops.MAX_WIDTH + 5
    choice = np.asarray([-0.0, 0.0, 1.5, -2.0], np.float32)
    x = choice[rng.integers(0, 4, (2, n))]
    x[1, rng.choice(n, 300, replace=False)] = np.where(rng.random(300) < 0.5, np.nan, -np.nan)
    if kind == "bfloat16":
        import ml_dtypes

        x = x.astype(ml_dtypes.bfloat16)
    log = _StageLog()
    monkeypatch.setattr(bops, "stage", log)
    got = bops.sort(_torch(x))
    assert log.seen[-1][1]["route"] == "rank" and log.seen[-1][1]["rounds"] == 2
    _bytes_equal(_ref_ops("bitonic").sort(jnp.asarray(x)), got, f"rank rounds {kind}")
