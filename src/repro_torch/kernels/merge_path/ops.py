"""Wrappers for the merge-path merge kernel (K3, ``csrc/merge_path.cu``).

* :func:`merge_partitioned` — merge of sorted (rows, W) pairs cut into
  output spans, used by the Ph6 rank-merge tail for key-only pairs under
  ``merge_backend="pallas"``. A CUDA tensor takes one of two routes:

  - the merge route, for int32 and int64 keys (the latter counted under
    ``merge_sorted_tiles_int64``) and for float32/bfloat16 rows free of
    NaNs: a partition kernel splits the merge path at every span boundary
    and a merge kernel merges each span of :func:`int_span` outputs. On
    float keys a CTA also merges again, by the TPU's network, every
    reference ``TILE`` span whose window holds both ``-0.0`` and ``+0.0``
    (only there can a stable merge's bytes differ from the network's);
  - the network route, for float rows that may hold a NaN: a diagonal
    kernel replays the JAX package's search and the TPU's network merges
    each ``TILE``-wide window.

  Float calls (both routes counted under ``merge_sorted_tiles_float``)
  choose on the device from a NaN flag, so no call reads the device from
  the host. A CPU tensor takes the window merge in ``ref.py``. ``width``
  produces only the first output columns (the merge tree clips every round
  to the receive bound). Keys are int32, float32, bfloat16 or int64; the
  bytes equal the JAX package's, ties of ``-0.0``/``+0.0`` and NaNs
  included.
* :func:`merge` — whole-row merge of rows of any two widths: both sides are
  padded with the sentinel to one power-of-two width ≥ 128 and merged.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.types import sentinel_for
from .. import _build
from . import ref

#: the reference's output span per window (power of two ≤ 1024): the float
#: keys' network window, and the CPU path's window, as the JAX package's.
TILE = 1024
#: merge route: threads per merge CTA, and the most outputs each merges.
THREADS, MAX_ITEMS = 256, 15

_KERNEL_DTYPES = (torch.int32, torch.float32, torch.bfloat16, torch.int64)

LAUNCHES = _build.counter("merge_sorted_tiles")
LAUNCHES_INT64 = _build.counter("merge_sorted_tiles_int64")
LAUNCHES_FLOAT = _build.counter("merge_sorted_tiles_float")


def _pow2_at_least(n: int, floor: int = 128) -> int:
    w = floor
    while w < n:
        w *= 2
    return w


def int_span(out_w: int) -> int:
    """Outputs per CTA of the merge route: THREADS x an odd item count (at
    most MAX_ITEMS), as few spans per row as that allows, evened out over
    them. Odd, so each thread's outputs fall in distinct shared-memory
    banks; any span gives the same bytes (float keys: with the reference
    spans of mixed zeros merged again by the network)."""
    spans = -(-max(out_w, 1) // (THREADS * MAX_ITEMS))
    items = -(-max(out_w, 1) // (spans * THREADS)) | 1
    return THREADS * items


def merge_partitioned(
    a: torch.Tensor, b: torch.Tensor, width: Optional[int] = None,
    has_nan: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Merge sorted (rows, W) pairs; returns the first ``width`` (default
    2W) columns of each merged row, value-identical to a stable merge.

    ``has_nan`` (float keys): a one-element bool tensor on the keys'
    device, True if any row of the call may hold a NaN; False sends every
    row down the merge route, which needs every row sorted (a NaN-free row
    of a sort that holds NaNs elsewhere may not be). The merge tree hands
    every round the flag it reduced once from its keys; left None, it is
    reduced here from ``a`` and ``b`` on the device. The host never reads
    it. Ignored on the CPU, whose window merge is exact on every input.
    """
    if a.shape != b.shape or a.dtype != b.dtype or a.ndim != 2:
        raise ValueError("a and b must be (rows, W) of one dtype")
    if has_nan is not None and (has_nan.dtype != torch.bool or has_nan.numel() != 1):
        raise ValueError("has_nan must be a one-element bool tensor")
    rows, W = a.shape
    out_w = 2 * W if width is None else min(width, 2 * W)
    tile = min(TILE, _pow2_at_least(W))
    if a.device.type == "cpu":
        return ref.merge_windows(a.contiguous(), b.contiguous(), tile, out_w)
    _build.check_cuda(a, "a")
    _build.check_cuda(b, "b")
    code = _build.dtype_code(a, _KERNEL_DTYPES)
    lib = _build.load()
    out = torch.empty((rows, out_w), dtype=a.dtype, device=a.device)
    span = int_span(out_w)
    # the merge route's splits at its span boundaries, first and last
    # included; float keys: or the network route's diagonals, one a window
    scratch = rows * (-(-out_w // span) + 1)
    flag = None
    if a.is_floating_point():
        scratch = max(scratch, rows * -(-out_w // tile))
        if has_nan is None:
            has_nan = torch.isnan(a).any() | torch.isnan(b).any()
        if has_nan.device != a.device:
            raise ValueError(f"has_nan must be on {a.device}, got {has_nan.device}")
        flag = has_nan.contiguous()
    splits = torch.empty((max(scratch, 1),), dtype=torch.int32, device=a.device)
    rc = lib.repro_merge_path(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), splits.data_ptr(), rows, W, out_w, span, tile,
        None if flag is None else flag.data_ptr(), code, _build.stream_handle(),
    )
    _build.check_launch(lib, rc, "merge_sorted_tiles")
    if a.is_floating_point():
        LAUNCHES_FLOAT.n += 1
    else:
        (LAUNCHES_INT64 if a.dtype == torch.int64 else LAUNCHES).n += 1
    return out


def merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Merge sorted rows of a (rows, na) and b (rows, nb) -> (rows, na+nb)."""
    squeeze = a.ndim == 1
    if squeeze:
        a, b = a[None, :], b[None, :]
    na, nb = a.shape[1], b.shape[1]
    sent = sentinel_for(a.dtype)
    w = _pow2_at_least(max(na, nb))
    ap = torch.nn.functional.pad(a, (0, w - na), value=sent).contiguous()
    bp = torch.nn.functional.pad(b, (0, w - nb), value=sent).contiguous()
    out = merge_partitioned(ap, bp, width=na + nb)
    return out[0] if squeeze else out
