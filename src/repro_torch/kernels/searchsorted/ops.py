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
kernel, a CPU tensor takes the plain version in ``ref.py``. Both results
are clamped to n, as the JAX package's wrappers clamp theirs. Keys are
int32, float32 or bfloat16. The JAX kernel's answer is a masked count;
the CUDA kernel binary-searches each row whose order makes that count a
prefix (sorted, NaNs last) and counts the others element by element.
"""
from __future__ import annotations

import torch

from .. import _build
from . import ref

_KERNEL_DTYPES = (torch.int32, torch.float32, torch.bfloat16)

LAUNCHES = _build.counter("splitter_ranks")


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
    for name, t in (("runs", x), ("queries", qkey)):
        _build.check_cuda(t, name)
    tags = []
    for name, t, shape in (("query procs", qproc, (B, S)), ("query idxs", qidx, (B, S)), ("row procs", me, (B,))):
        if t is not None:
            _build.check_cuda(t, name)
            if t.dtype != torch.int32 or tuple(t.shape) != shape:
                raise ValueError(f"{name} must be int32 of shape {shape}")
        tags.append(None if t is None else t.data_ptr())
    code = _build.dtype_code(x, _KERNEL_DTYPES)
    lib = _build.load()
    out = torch.empty((B, S), dtype=torch.int32, device=x.device)
    row_ok = torch.empty((B,), dtype=torch.int32, device=x.device)
    rc = lib.repro_splitter_ranks(
        x.data_ptr(), n, qkey.data_ptr(), tags[0], proc_tag, tags[1], tags[2],
        S, B, row_ok.data_ptr(), out.data_ptr(), code, _build.stream_handle(),
    )
    _build.check_launch(lib, rc, "splitter_ranks")
    LAUNCHES.n += 1
    return out


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous() if t.ndim == 2 else t.reshape(1, -1).contiguous()


def splitter_ranks(x_sorted, split_keys, split_proc, split_idx, me) -> torch.Tensor:
    """Bucket boundaries of tagged splitters in sorted runs.

    x_sorted (B, n) or (n,); split_* (B, S) or (S,); me (B,) or scalar.
    Returns int32 ranks of the splitters' shape, clamped to n.
    """
    squeeze = x_sorted.ndim == 1
    x = _rows(x_sorted)
    B, n = x.shape
    me = torch.as_tensor(me, dtype=torch.int32, device=x.device).reshape(-1).expand(B)
    ranks = _ranks(
        x, _rows(split_keys), _rows(split_proc.to(torch.int32)), 0,
        _rows(split_idx.to(torch.int32)), me.contiguous(),
    )
    ranks = torch.clamp(ranks, max=n)
    return ranks[0] if squeeze else ranks


def rank_in(data: torch.Tensor, queries: torch.Tensor, side: str = "left") -> torch.Tensor:
    """Rank of each query in sorted runs — ``searchsorted`` semantics.

    side="left": #{i : data_i < q}; side="right": #{i : data_i <= q}.
    data (B, n) or (n,); queries (B, S) or (S,). Returns int32, clamped to n.
    """
    if side not in ("left", "right"):
        raise ValueError(f"unknown side {side!r}")
    squeeze = data.ndim == 1
    x = _rows(data)
    ranks = _ranks(x, _rows(queries), None, 1 if side == "right" else -1, None, None)
    ranks = torch.clamp(ranks, max=x.shape[1])
    return ranks[0] if squeeze else ranks
