"""Wrappers for the merge-path merge kernel (K3, ``csrc/merge_path.cu``).

* :func:`merge_partitioned` — merge of sorted (rows, W) pairs cut into
  output spans, used by the Ph6 rank-merge tail for key-only pairs under
  ``merge_backend="pallas"``. A CUDA tensor launches two kernels: for int32
  and int64 keys (the latter counted under ``merge_sorted_tiles_int64``)
  a partition kernel splits the merge path at every span boundary and
  a merge kernel merges each span of :func:`int_span` outputs; for float
  keys a diagonal kernel replays the JAX package's search and the TPU's
  network merges each ``TILE``-wide window. A CPU tensor takes the window
  merge in ``ref.py``. ``width`` produces only the first output columns
  (the merge tree clips every round to the receive bound). Keys are int32,
  float32, bfloat16 or int64; the bytes equal the JAX package's, ties of
  ``-0.0``/``+0.0`` and NaNs included.
* :func:`merge` — whole-row merge of rows of any two widths: both sides are
  padded with the sentinel to one power-of-two width ≥ 128 and merged.
"""
from __future__ import annotations

from typing import Optional

import torch

from ...core.types import sentinel_for
from .. import _build
from . import ref

#: output span per window of the float route (power of two ≤ 1024), and
#: the CPU path's window, as the JAX package's.
TILE = 1024
#: integer route: threads per merge CTA, and the most outputs each merges.
THREADS, MAX_ITEMS = 256, 15

_KERNEL_DTYPES = (torch.int32, torch.float32, torch.bfloat16, torch.int64)

LAUNCHES = _build.counter("merge_sorted_tiles")
LAUNCHES_INT64 = _build.counter("merge_sorted_tiles_int64")


def _pow2_at_least(n: int, floor: int = 128) -> int:
    w = floor
    while w < n:
        w *= 2
    return w


def int_span(out_w: int) -> int:
    """Outputs per CTA of the integer route: THREADS x an odd item count (at
    most MAX_ITEMS), as few spans per row as that allows, evened out over
    them. Odd, so each thread's outputs fall in distinct shared-memory
    banks; any span gives the same bytes for integer keys."""
    spans = -(-max(out_w, 1) // (THREADS * MAX_ITEMS))
    items = -(-max(out_w, 1) // (spans * THREADS)) | 1
    return THREADS * items


def merge_partitioned(a: torch.Tensor, b: torch.Tensor, width: Optional[int] = None) -> torch.Tensor:
    """Merge sorted (rows, W) pairs; returns the first ``width`` (default
    2W) columns of each merged row, value-identical to a stable merge."""
    if a.shape != b.shape or a.dtype != b.dtype or a.ndim != 2:
        raise ValueError("a and b must be (rows, W) of one dtype")
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
    # the first kernel's answers: the windows' diagonals (float keys), or the
    # merge path's splits at the span boundaries, first and last included
    if a.is_floating_point():
        span, splits = tile, rows * -(-out_w // tile)
    else:
        span = int_span(out_w)
        splits = rows * (-(-out_w // span) + 1)
    diag = torch.empty((max(splits, 1),), dtype=torch.int32, device=a.device)
    rc = lib.repro_merge_path(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), diag.data_ptr(), rows, W, out_w, span,
        code, _build.stream_handle(),
    )
    _build.check_launch(lib, rc, "merge_sorted_tiles")
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
