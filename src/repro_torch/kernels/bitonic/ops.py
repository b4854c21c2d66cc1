"""Wrappers for the bitonic tile sorts (``csrc/bitonic_sort.cu``).

K1 :func:`sort_tiles` and K4 :func:`sort_kv_tiles` are the dispatch
points: a CUDA tensor launches the kernel (or raises), a CPU tensor takes
the plain network in ``ref.py``. Keys are int32, uint32, float32 or
bfloat16. Around them the JAX package's wrapper logic:

* :func:`sort` — sentinel padding to a power of two ≥ 128, single tiles up
  to ``MAX_WIDTH``, and for wider rows ``MAX_WIDTH`` tiles sorted by the
  kernel and merged pairwise, round by round (the stages
  ``local_sort.tiles`` and ``local_sort.rank_merge`` of ``obs.trace``;
  the latter's ``route`` and ``rounds`` say how). Integer keys on the card
  take K3's merge path (``kernels/merge_path``), each round reading its
  pairs in place; float keys keep the JAX wrapper's rank merges, whose
  bytes on ``-0.0``/``+0.0`` ties and NaN tiles K3's routes do not give,
  and so does every CPU tensor. Equal integer keys are equal in every bit,
  so both routes give the JAX package's bytes;
* :func:`sort_kv` — keys padded with the sentinel and values with 0, one
  tile up to ``MAX_WIDTH``; wider rows take a stable argsort and a gather,
  as the JAX wrapper does. The network is not stable: equal keys may come
  out with their values in another order than they went in, as in the
  JAX package.
"""
from __future__ import annotations

import torch

from ...core.primitives import bias_unsigned, gather, scatter_, searchsorted, stable_sort, unbias_unsigned
from ...core.types import sentinel_for
from ...obs.trace import stage
from .. import _build
from ..merge_path import ops as merge_path_ops
from . import ref

#: widest single-tile sort: one CTA of 512 threads holding 32 keys each.
MAX_WIDTH = 16384
MIN_WIDTH = 128
_KERNEL_DTYPES = (torch.int32, torch.uint32, torch.float32, torch.bfloat16)
#: K4 moves values as opaque words of these sizes
_VALUE_BYTES = (2, 4, 8)

LAUNCHES = _build.counter("bitonic_sort_tiles")
KV_LAUNCHES = _build.counter("bitonic_sort_kv_tiles")


def _pow2_at_least(n: int, floor: int = MIN_WIDTH) -> int:
    w = floor
    while w < n:
        w *= 2
    return w


def supports(x: torch.Tensor) -> bool:
    return x.ndim in (1, 2) and x.dtype in _KERNEL_DTYPES


def _check_tile(x: torch.Tensor) -> None:
    width = x.shape[1]
    if width & (width - 1) or not MIN_WIDTH <= width <= MAX_WIDTH:
        raise ValueError(f"tile width must be a power of two in [128, 16384], got {width}")


def sort_tiles(x: torch.Tensor) -> torch.Tensor:
    """Sort every row of (rows, width); width a power of two in [128, 16384]."""
    _check_tile(x)
    if x.device.type == "cpu":
        return ref.sort_tiles(x)
    _build.check_cuda(x, "x")
    code = _build.dtype_code(x, _KERNEL_DTYPES)
    lib = _build.load()
    out = torch.empty_like(x)
    rc = lib.repro_bitonic_sort_rows(
        x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], code, _build.stream_handle()
    )
    _build.check_launch(lib, rc, "bitonic_sort_tiles")
    LAUNCHES.n += 1
    return out


def sort_kv_tiles(keys: torch.Tensor, vals: torch.Tensor):
    """K1's network on every key row of (rows, width), values swapped alongside."""
    _check_tile(keys)
    if vals.shape != keys.shape:
        raise ValueError(f"values {tuple(vals.shape)} must have the keys' shape {tuple(keys.shape)}")
    if keys.device.type == "cpu":
        return ref.sort_kv_tiles(keys, vals)
    _build.check_cuda(keys, "keys")
    _build.check_cuda(vals, "values")
    code = _build.dtype_code(keys, _KERNEL_DTYPES)
    vbytes = vals.element_size()
    if vbytes not in _VALUE_BYTES:
        raise TypeError(f"no kernel for {vals.dtype} values (it moves 2-, 4- or 8-byte words)")
    lib = _build.load()
    ko, vo = torch.empty_like(keys), torch.empty_like(vals)
    rc = lib.repro_bitonic_sort_kv_rows(
        keys.data_ptr(), vals.data_ptr(), ko.data_ptr(), vo.data_ptr(), keys.shape[0],
        keys.shape[1], code, vbytes, _build.stream_handle(),
    )
    _build.check_launch(lib, rc, "bitonic_sort_kv_tiles")
    KV_LAUNCHES.n += 1
    return ko, vo


def _pad(x: torch.Tensor, width: int, value) -> torch.Tensor:
    """``x`` padded to ``width`` columns, contiguous; ``x`` itself when it
    already is (the kernels and the plain networks never write their input)."""
    if width == x.shape[1] and x.is_contiguous():
        return x
    return torch.nn.functional.pad(x, (0, width - x.shape[1]), value=value).contiguous()


def sort(x: torch.Tensor) -> torch.Tensor:
    """Sort along the last axis of a 1-D or 2-D tensor."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    rows, n = x.shape
    sent = sentinel_for(x.dtype)
    if n <= MAX_WIDTH:
        out = sort_tiles(_pad(x, _pow2_at_least(n), sent))[:, :n]
        return out[0] if squeeze else out

    # multi-tile: sort MAX_WIDTH tiles in the kernel, then merge pairs.
    w = _pow2_at_least(n, MAX_WIDTH)
    t = w // MAX_WIDTH
    with stage("local_sort.tiles", keys=rows * w):
        tiles = sort_tiles(_pad(x, w, sent).reshape(rows * t, MAX_WIDTH))
    route = _merge_route(tiles)
    rounds = t.bit_length() - 1
    with stage("local_sort.rank_merge", keys=rows * w, route=route, rounds=rounds):
        if route == "merge_path":
            out = _merge_path_rounds(tiles, n, rounds)
        else:
            out = _rank_rounds(tiles, rows, n, rounds)
    return out[0] if squeeze else out


def _merge_route(tiles: torch.Tensor) -> str:
    """How :func:`sort` merges its tiles: ``"merge_path"`` (K3) for integer
    keys on the card, else ``"rank"``."""
    return "merge_path" if tiles.device.type == "cuda" and not tiles.is_floating_point() else "rank"


def _merge_path_rounds(tiles: torch.Tensor, n: int, rounds: int) -> torch.Tensor:
    """Merge (rows·2^rounds, W) sorted tiles into (rows, n) by K3, a round
    at a time: a pair is rows 2k and 2k+1 of the round's buffer, read in
    place (row stride 2W), and each round writes one (R/2, 2W) buffer, the
    last only its first ``n`` columns."""
    unsigned = tiles.dtype == torch.uint32
    if unsigned:  # K3 merges the order-keeping bias as int32
        tiles = bias_unsigned(tiles)
    for r in range(rounds):
        tiles = merge_path_ops.merge_partitioned(tiles[0::2], tiles[1::2], n if r == rounds - 1 else None)
    return unbias_unsigned(tiles) if unsigned else tiles


def _rank_rounds(tiles: torch.Tensor, rows: int, n: int, rounds: int) -> torch.Tensor:
    """The JAX wrapper's merge of (rows·2^rounds, W) sorted tiles into
    (rows, n): :func:`_rank_merge` rounds over (rows, tiles, W)."""
    tiles = tiles.reshape(rows, 2**rounds, MAX_WIDTH)
    unsigned = tiles.dtype == torch.uint32
    if unsigned:  # no uint32 searchsorted/scatter: merge the order-keeping bias
        tiles = bias_unsigned(tiles)
    for _ in range(rounds):
        tiles = _rank_merge(tiles[:, 0::2], tiles[:, 1::2])
    out = tiles[:, 0, :n]
    return unbias_unsigned(out) if unsigned else out


def _rank_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge sorted runs pairwise: out position = own idx + rank in other."""
    *lead, m = a.shape
    fa = a.reshape(-1, m).contiguous()
    fb = b.reshape(-1, m).contiguous()
    exact = a.is_floating_point()  # NaN tiles leave the network unsorted
    i = torch.arange(m, device=a.device)
    pos_a = i + searchsorted(fb, fa, "left", exact).long()
    pos_b = i + searchsorted(fa, fb, "right", exact).long()
    # a NaN tile can give two keys one position and leave another unwritten,
    # which holds the JAX wrapper's zero; integer positions are a permutation
    out = (torch.zeros if exact else torch.empty)((fa.shape[0], 2 * m), dtype=a.dtype, device=a.device)
    scatter_(out, 1, pos_a, fa)
    scatter_(out, 1, pos_b, fb)
    return out.reshape(*lead, 2 * m)


def _gather(t: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``t.gather(-1, order)`` for any dtype, bit-exact (uint32 by its int32 view)."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).gather(-1, order).view(torch.uint32)
    return gather(t, -1, order)


def sort_kv(keys: torch.Tensor, vals: torch.Tensor):
    """Key-value sort along the last axis of 1-D or 2-D (keys, values)."""
    squeeze = keys.ndim == 1
    if squeeze:
        keys, vals = keys[None, :], vals[None, :]
    rows, n = keys.shape
    if n > MAX_WIDTH:
        order = stable_sort(bias_unsigned(keys) if keys.dtype == torch.uint32 else keys)[1]
        ko, vo = _gather(keys, order), _gather(vals, order)
    else:
        w = _pow2_at_least(n)
        ko, vo = sort_kv_tiles(_pad(keys, w, sentinel_for(keys.dtype)), _pad(vals, w, 0))
        ko, vo = ko[:, :n], vo[:, :n]
    return (ko[0], vo[0]) if squeeze else (ko, vo)
