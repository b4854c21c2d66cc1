"""Plain PyTorch versions of the bitonic tile sorts (K1, K4).

Both run the JAX package's compare-exchange network
(``repro/kernels/bitonic/kernel.py`` ``_stage`` / ``_stage_kv``) stage by
stage, so they give its bytes where keys compare equal but differ in their
bits (``-0.0``/``+0.0``, NaNs) and, for K4, its order of equal keys' values:
the network is not stable.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.primitives import bias_unsigned, unbias_unsigned


def stage(x: torch.Tensor, k: int, j: int, vals: Optional[torch.Tensor] = None):
    """One compare-exchange substage: partner = index XOR j, region size k.

    Returns the keys, and the values swapped on the same predicate when
    ``vals`` is given (``(keys, vals)``).
    """
    r, w = x.shape
    g = w // (2 * j)
    x4 = x.reshape(r, g, 2, j)
    a, b = x4[:, :, 0], x4[:, :, 1]
    asc = (((torch.arange(g, device=x.device) * 2 * j) & k) == 0)[None, :, None]
    swap = torch.where(asc, a > b, a < b)
    keys = torch.stack([torch.where(swap, b, a), torch.where(swap, a, b)], 2).reshape(r, w)
    if vals is None:
        return keys
    v4 = vals.reshape(r, g, 2, j)
    va, vb = v4[:, :, 0], v4[:, :, 1]
    vals = torch.stack([torch.where(swap, vb, va), torch.where(swap, va, vb)], 2).reshape(r, w)
    return keys, vals


def _network(x: torch.Tensor, vals: Optional[torch.Tensor]):
    w = x.shape[1]
    unsigned = x.dtype == torch.uint32
    if unsigned:  # the CPU has no uint32 compare; the bias keeps the order
        x = bias_unsigned(x)
    k = 2
    while k <= w:
        j = k // 2
        while j >= 1:
            if vals is None:
                x = stage(x, k, j)
            else:
                x, vals = stage(x, k, j, vals)
            j //= 2
        k *= 2
    if unsigned:
        x = unbias_unsigned(x)
    return x if vals is None else (x, vals)


def sort_tiles(x: torch.Tensor) -> torch.Tensor:
    """Bitonic sort of every row of a (rows, width) tile; width a power of two."""
    return _network(x, None)


def sort_kv_tiles(keys: torch.Tensor, vals: torch.Tensor):
    """K1's network on the keys, each value swapped with its key."""
    return _network(keys, vals)
