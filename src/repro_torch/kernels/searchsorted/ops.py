"""Wrappers for the splitter-rank kernel (K2, ``csrc/splitter_ranks.cu``).

Two entry points share the one kernel, batched over rows (the JAX
package's are vmapped):

* :func:`splitter_ranks` — ranks of tagged §5.1.1 splitters (key, proc,
  idx) in sorted runs;
* :func:`rank_in` — ``searchsorted`` ranks (left/right) of queries in
  sorted runs, the rank computation of the Ph6 rank-merge tail
  (``core/merge._rank`` under ``merge_backend="pallas"``). The side is the
  query's proc tag against row proc 0: -1 makes the comparator strictly
  less (left), +1 less-or-equal (right).

:func:`_ranks` is the one dispatch point: a CUDA tensor launches the
kernel, a CPU tensor takes the plain version in ``ref.py``. Keys are
int32, float32, bfloat16 or int64 (the segmented sort's composites; their
launches count under ``splitter_ranks_int64``). Both count over the n real elements, so no
rank exceeds n. The JAX wrappers pad each run with the sentinel to a block
multiple and clamp the count to n; a pad counts for a query key equal to
the sentinel, which changes a rank only on float runs that hold NaNs
(:func:`_with_jax_pads` adds it back). The CUDA kernel routes each row by
its order: run and queries in order merge as one merge path, queries out
of order search the run one by one, and a run out of order (NaNs) counts
element by element.
A query tensor may be one row broadcast over the rows (``expand``, row
stride 0), as the merge tail's output slots are; it is not copied.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from . import ref

_KERNEL_DTYPES = (torch.int32, torch.float32, torch.bfloat16, torch.int64)

LAUNCHES = _build.counter("splitter_ranks")
LAUNCHES_INT64 = _build.counter("splitter_ranks_int64")


def query_row_stride(q: torch.Tensor) -> Optional[int]:
    """Elements from one row of a (B, S) query tensor to the next, where
    the kernel reads it in place: S for rows one after another, 0 for one
    row broadcast over the rows. None for any other layout."""
    B, S = q.shape
    if S > 1 and q.stride(1) != 1:
        return None
    if B == 1 or S == 0:
        return S
    return q.stride(0) if q.stride(0) in (0, S) else None


def _ranks(x, qkey, qproc, proc_tag: int, qidx, me) -> torch.Tensor:
    """(B, S) ranks; ``qproc``/``qidx``/``me`` may be None (proc_tag / 0 / 0)."""
    B, n = x.shape
    S = qkey.shape[1]
    if qkey.shape[0] != B or qkey.dtype != x.dtype:
        raise ValueError("queries must be (B, S) of the runs' dtype")
    if x.device.type == "cpu":
        zeros_q = torch.zeros((B, S), dtype=torch.int32)
        qp = torch.full((B, S), proc_tag, dtype=torch.int32) if qproc is None else qproc
        qi = zeros_q if qidx is None else qidx
        m = torch.zeros((B,), dtype=torch.int32) if me is None else me
        return ref.ranks(x, qkey, qp, qi, m)
    _build.check_cuda(x, "runs")
    stride = query_row_stride(qkey)
    if qkey.device.type != "cuda" or stride is None:
        raise ValueError("queries must be CUDA rows in place or one row broadcast over the rows")
    ptrs = []
    for name, t, shape in (("query procs", qproc, (B, S)), ("query idxs", qidx, (B, S)), ("row procs", me, (B,))):
        if t is not None:
            if t.dtype != torch.int32 or tuple(t.shape) != shape:
                raise ValueError(f"{name} must be int32 of shape {shape}")
            if len(shape) == 1:
                _build.check_cuda(t, name)
            elif t.device.type != "cuda" or query_row_stride(t) != stride:
                raise ValueError(f"{name} must be laid out as the query keys")
        ptrs.append(None if t is None else t.data_ptr())
    code = _build.dtype_code(x, _KERNEL_DTYPES)
    lib = _build.load()
    buf = torch.empty((B * S + B,), dtype=torch.int32, device=x.device)  # ranks, row flags
    out = buf.data_ptr()
    rc = lib.repro_splitter_ranks(
        x.data_ptr(), n, qkey.data_ptr(), ptrs[0], proc_tag, ptrs[1], stride, ptrs[2],
        S, B, out + 4 * B * S, out, code, _build.stream_handle(),
    )
    _build.check_launch(lib, rc, "splitter_ranks")
    (LAUNCHES_INT64 if x.dtype == torch.int64 else LAUNCHES).n += 1
    return buf[: B * S].view(B, S)


def _jax_pads(n: int) -> int:
    """Sentinel pads the JAX wrappers append to a run of n (``block`` there)."""
    block = min(2048, -(-n // 128) * 128)
    return -(-n // block) * block - n if n else 0


def _with_jax_pads(ranks, n: int, qkey, qproc, qidx, me) -> torch.Tensor:
    """The JAX wrappers' answer on float runs: their pads (key +inf, index
    n, n+1, ...) count for +inf query keys by the same tagged compare, and
    the sum is clamped to n. Unchanged wherever the n real elements all
    count (every run without NaNs)."""
    npad = _jax_pads(n)
    qp = qproc.to(torch.int64)
    me = me.reshape(-1, 1).to(torch.int64)
    tied = torch.where(me == qp, (qidx.to(torch.int64) - n).clamp(0, npad), 0)
    hits = torch.where(me < qp, npad, tied)
    return torch.where(qkey == float("inf"), (ranks + hits).clamp(max=n), ranks).to(torch.int32)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(rows, S): a 1-D tensor as one row; a layout the kernel cannot read copied."""
    t = t.reshape(1, -1) if t.ndim == 1 else t
    return t if query_row_stride(t) is not None else t.contiguous()


def splitter_ranks(x_sorted, split_keys, split_proc, split_idx, me) -> torch.Tensor:
    """Bucket boundaries of tagged splitters in sorted runs.

    x_sorted (B, n) or (n,); split_* (B, S) or (S,); me (B,) or scalar.
    Returns int32 ranks of the splitters' shape, each at most n.
    """
    squeeze = x_sorted.ndim == 1
    x = _rows(x_sorted).contiguous()
    B = x.shape[0]
    me = torch.as_tensor(me, dtype=torch.int32, device=x.device).reshape(-1).expand(B).contiguous()
    q = [_rows(t) for t in (split_keys, split_proc.to(torch.int32), split_idx.to(torch.int32))]
    if len({query_row_stride(t) for t in q}) > 1:  # keys and tags read with one stride
        q = [t.contiguous() for t in q]
    ranks = _ranks(x, q[0], q[1], 0, q[2], me)
    if x.is_floating_point():
        ranks = _with_jax_pads(ranks, x.shape[1], *q, me)
    return ranks[0] if squeeze else ranks


def rank_in(data: torch.Tensor, queries: torch.Tensor, side: str = "left") -> torch.Tensor:
    """Rank of each query in sorted runs — ``searchsorted`` semantics.

    side="left": #{i : data_i < q}; side="right": #{i : data_i <= q}.
    data (B, n) or (n,); queries (B, S) or (S,), or one row expanded over
    the B rows. Returns int32 ranks, each at most n.
    """
    if side not in ("left", "right"):
        raise ValueError(f"unknown side {side!r}")
    squeeze = data.ndim == 1
    x, q = _rows(data).contiguous(), _rows(queries)
    ranks = _ranks(x, q, None, 1 if side == "right" else -1, None, None)
    if side == "right" and x.is_floating_point():  # a left pad never counts
        one = torch.ones((), dtype=torch.int32, device=x.device)
        ranks = _with_jax_pads(ranks, x.shape[1], q, one, one * 0, one * 0)
    return ranks[0] if squeeze else ranks
