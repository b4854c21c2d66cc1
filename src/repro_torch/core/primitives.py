"""BSP primitives (paper §4) over an explicit leading processor dimension.

The JAX package runs one per-processor body under a named axis and
expresses Ph3–Ph5's supersteps as collectives. Here every tensor carries
the processor as dimension 0 and each collective is a tensor operation:

* ``all_to_all`` — a transpose of ``(p_src, p_dst, ...)``;
* ``all_gather`` — a broadcast (every processor sees every row);
* ``pmax`` / ``psum`` — reductions over dimension 0 (``.any()``, ``.sum()``);
* ``proc_id`` — ``torch.arange(p)``;
* ``exchange_with`` — the pairwise XOR-partner ``ppermute`` of a bitonic
  compare-split step, a row permutation;
* ``ppermute_shift`` — the ring's rotation, a roll along the processors.

The JAX package orders float keys with XLA's sort comparator: ``-0.0``
equals ``+0.0`` and every NaN is equal and above ``+inf``. :func:`sort_key`
gives that order as integers; :func:`stable_sort` sorts by it (on the card
``torch.sort`` of floats orders NaNs otherwise than on the CPU) and
:func:`searchsorted` reproduces ``jnp.searchsorted`` on it.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


def proc_id(p: int, device) -> torch.Tensor:
    return torch.arange(p, dtype=torch.int32, device=device)


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Deliver row ``[src, dst]`` to processor ``dst``: ``(p_dst, p_src, ...)``."""
    return x.transpose(0, 1).contiguous()


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every processor receives every row: ``(p, ...) -> (p, p, ...)`` view."""
    return x.unsqueeze(0).expand(x.shape[0], *x.shape)


def exchange_with(x, partner_xor: int):
    """Row ``k`` receives row ``k ^ partner_xor`` (a tuple maps elementwise)."""
    if isinstance(x, (tuple, list)):
        return type(x)(exchange_with(v, partner_xor) for v in x)
    perm = torch.arange(x.shape[0], device=x.device) ^ partner_xor
    return x[perm]


def ppermute_shift(x, shift: int = 1):
    """Row ``k`` receives row ``k - shift`` (mod p): processor i sends to
    i + shift around the ring. A tuple or list maps elementwise."""
    if isinstance(x, (tuple, list)):
        return type(x)(ppermute_shift(v, shift) for v in x)
    return torch.roll(x, shifts=shift, dims=0)


def exclusive_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.cumsum(x, dim=dim, dtype=x.dtype) - x


#: signed integer dtype of each element size, for bit views of float keys
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def gather(x: torch.Tensor, dim: int, index: torch.Tensor) -> torch.Tensor:
    """``x.gather(dim, index)``, bit-exact for every dtype: float keys move
    as integers of their width (the CPU gather rewrites bfloat16 NaNs)."""
    if not x.is_floating_point():
        return x.gather(dim, index)
    return x.view(_BITS[x.element_size()]).gather(dim, index).view(x.dtype)


def scatter_(buf: torch.Tensor, dim: int, index: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``buf.scatter_(dim, index, src)``, bit-exact as :func:`gather`."""
    if not buf.is_floating_point():
        return buf.scatter_(dim, index, src)
    bits = _BITS[buf.element_size()]
    buf.view(bits).scatter_(dim, index, src.view(bits))
    return buf


def lex_sort(operands: Sequence[torch.Tensor], num_keys: int) -> tuple:
    """Stable lexicographic sort along the last dimension (§5.1.1 tagged
    compare): stable argsorts of the keys, least significant key first."""
    order = None
    for key in reversed(operands[:num_keys]):
        k = key if order is None else gather(key, -1, order)
        step = stable_sort(k)[1]
        order = step if order is None else order.gather(-1, step)
    return tuple(gather(op, -1, order) for op in operands)


def lex_less(ka, pa, ia, kb, pb, ib):
    """(key, proc, idx) lexicographic strict less-than — §5.1.1's comparator."""
    return (ka < kb) | ((ka == kb) & ((pa < pb) | ((pa == pb) & (ia < ib))))


def take_rows(v: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``out[r, j, ...] = v[r, index[r, j], ...]`` for any trailing dims."""
    rows = torch.arange(v.shape[0], device=v.device).unsqueeze(1)
    return v[rows, index.long()]


# ------------------------------------------------- the JAX package's order
_INT_MIN = -(2**31)


def bias_unsigned(x: torch.Tensor) -> torch.Tensor:
    """uint32 -> int32 with the same order (``x ^ 0x80000000``, viewed)."""
    return x.view(torch.int32) ^ _INT_MIN


def unbias_unsigned(x: torch.Tensor) -> torch.Tensor:
    """Invert :func:`bias_unsigned`."""
    return (x ^ _INT_MIN).view(torch.uint32)


def sort_key(x: torch.Tensor) -> torch.Tensor:
    """Integers ordered as the JAX package's sort comparator orders ``x``.

    Floats are canonicalised first (``-0.0`` -> ``+0.0``, every NaN -> one
    positive NaN), then their bits are mapped to a signed integer of the
    same order. Integer tensors are returned as they are.
    """
    if not x.is_floating_point():
        return x
    if x.dtype == torch.float64:
        f, ity, width = x, torch.int64, 64
    else:
        f, ity, width = x.float(), torch.int32, 32
    f = torch.where(f == 0, torch.zeros((), dtype=f.dtype, device=f.device), f)
    f = torch.where(torch.isnan(f), torch.full((), float("nan"), dtype=f.dtype, device=f.device), f)
    b = f.view(ity)
    return b ^ ((b >> (width - 1)) & (2 ** (width - 1) - 1))


def canonical_nans(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 NaNs rewritten to the quiet NaN of their sign (``0x7fc0`` /
    ``0xffc0``); any other tensor unchanged.

    The JAX package's ops that compute on bfloat16 (``lax.sort``,
    ``jnp.where``, ``jnp.concatenate``) do this on XLA:CPU, since they run
    in float32 and round back; its gathers keep the bits. The port applies
    it where those ops stand (:func:`stable_sort`, the routing's row
    formation), on every device, with integer operations on the bits.
    """
    if x.dtype != torch.bfloat16:
        return x
    b = x.view(torch.int16)
    quiet = torch.where(b < 0, torch.full((), -64, dtype=torch.int16, device=x.device),  # 0xffc0
                        torch.full((), 0x7FC0, dtype=torch.int16, device=x.device))
    return torch.where((b & 0x7FFF) > 0x7F80, quiet, b).view(torch.bfloat16)


def stable_sort(x: torch.Tensor, dim: int = -1):
    """``(values, indices)`` of a stable ascending sort in the JAX package's
    order, the same on every device (float keys sort by :func:`sort_key`;
    bfloat16 NaNs come out canonical, as from ``lax.sort``)."""
    if not x.is_floating_point():
        return tuple(torch.sort(x, dim=dim, stable=True))
    order = torch.sort(sort_key(x), dim=dim, stable=True).indices
    return canonical_nans(gather(x, dim, order)), order


def searchsorted(
    arr: torch.Tensor, query: torch.Tensor, side: str = "left", exact_probes: bool = False
) -> torch.Tensor:
    """``jnp.searchsorted`` of (R, S) queries in (R, n) runs, int32.

    On a sorted run every binary search gives the same answer, and
    ``torch.searchsorted`` is taken. ``exact_probes=True`` replays the JAX
    function's own search (⌈lg(n+1)⌉ halving steps, its midpoints, its
    comparator), so the answer equals the JAX package's on a run that is
    not sorted too: a bitonic network leaves float runs with NaNs unsorted.
    """
    if side not in ("left", "right"):
        raise ValueError(f"unknown side {side!r}")
    n = arr.shape[-1]
    if not exact_probes:
        return torch.searchsorted(arr.contiguous(), query.contiguous(), side=side, out_int32=True)
    if n == 0:
        return torch.zeros(query.shape, dtype=torch.int32, device=query.device)
    ka, kq = sort_key(arr), sort_key(query)
    low = torch.zeros(query.shape, dtype=torch.int64, device=query.device)
    high = torch.full(query.shape, n, dtype=torch.int64, device=query.device)
    for _ in range(int(math.ceil(math.log2(n + 1)))):
        mid = (low + high) // 2
        v = ka.gather(-1, mid)
        go_left = kq <= v if side == "left" else kq < v
        low = torch.where(go_left, low, mid)
        high = torch.where(go_left, mid, high)
    return high.to(torch.int32)
