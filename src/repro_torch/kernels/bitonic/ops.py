"""Wrappers for the bitonic tile-sort kernel (K1, ``csrc/bitonic_sort.cu``).

:func:`sort_tiles` is the one dispatch point: a CUDA tensor launches the
kernel, a CPU tensor takes the plain version in ``ref.py``. :func:`sort`
keeps the JAX package's wrapper logic around it: sentinel padding to a
power of two ≥ 128, single tiles up to ``MAX_WIDTH``, and for wider rows
``MAX_WIDTH`` tiles sorted by the kernel and combined by rank merges.
"""
from __future__ import annotations

import torch

from ...core.types import sentinel_for
from .. import _build
from . import ref

#: widest single-tile sort: one 16384-key row fills 64 KiB of shared memory.
MAX_WIDTH = 16384
MIN_WIDTH = 128
_KERNEL_DTYPES = (torch.int32, torch.float32)

LAUNCHES = _build.counter("bitonic_sort_tiles")


def _pow2_at_least(n: int, floor: int = MIN_WIDTH) -> int:
    w = floor
    while w < n:
        w *= 2
    return w


def supports(x: torch.Tensor) -> bool:
    return x.ndim in (1, 2) and x.dtype in _KERNEL_DTYPES


def sort_tiles(x: torch.Tensor) -> torch.Tensor:
    """Sort every row of (rows, width); width a power of two in [128, 16384]."""
    rows, width = x.shape
    if width & (width - 1) or not MIN_WIDTH <= width <= MAX_WIDTH:
        raise ValueError(f"tile width must be a power of two in [128, 16384], got {width}")
    if x.device.type == "cpu":
        return ref.sort_tiles(x)
    _build.check_cuda(x, "x")
    code = _build.dtype_code(x)
    lib = _build.load()
    out = torch.empty_like(x)
    rc = lib.repro_bitonic_sort_rows(
        x.data_ptr(), out.data_ptr(), rows, width, code, _build.stream_handle()
    )
    _build.check_launch(lib, rc, "bitonic_sort_tiles")
    LAUNCHES.n += 1
    return out


def sort(x: torch.Tensor) -> torch.Tensor:
    """Sort along the last axis of a 1-D or 2-D tensor."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    rows, n = x.shape
    sent = sentinel_for(x.dtype)
    if n <= MAX_WIDTH:
        w = _pow2_at_least(n)
        xp = torch.nn.functional.pad(x, (0, w - n), value=sent)
        out = sort_tiles(xp.contiguous())[:, :n]
        return out[0] if squeeze else out

    # multi-tile: sort MAX_WIDTH tiles in the kernel, then merge pairs.
    w = _pow2_at_least(n, MAX_WIDTH)
    xp = torch.nn.functional.pad(x, (0, w - n), value=sent)
    t = w // MAX_WIDTH
    tiles = sort_tiles(xp.reshape(rows * t, MAX_WIDTH).contiguous()).reshape(
        rows, t, MAX_WIDTH
    )
    while tiles.shape[1] > 1:
        tiles = _rank_merge(tiles[:, 0::2], tiles[:, 1::2])
    out = tiles[:, 0, :n]
    return out[0] if squeeze else out


def _rank_merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge sorted runs pairwise: out position = own idx + rank in other."""
    *lead, m = a.shape
    fa = a.reshape(-1, m).contiguous()
    fb = b.reshape(-1, m).contiguous()
    i = torch.arange(m, device=a.device)
    pos_a = i + torch.searchsorted(fb, fa)
    pos_b = i + torch.searchsorted(fa, fb, right=True)
    out = torch.empty((fa.shape[0], 2 * m), dtype=a.dtype, device=a.device)
    out.scatter_(1, pos_a, fa)
    out.scatter_(1, pos_b, fb)
    return out.reshape(*lead, 2 * m)
