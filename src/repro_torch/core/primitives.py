"""BSP primitives (paper §4) over an explicit leading processor dimension.

The JAX package runs one per-processor body under a named axis and
expresses Ph3–Ph5's supersteps as collectives. Here every tensor carries
the processor as dimension 0 and each collective is a tensor operation:

* ``all_to_all`` — a transpose of ``(p_src, p_dst, ...)``;
* ``all_gather`` — a broadcast (every processor sees every row);
* ``pmax`` / ``psum`` — reductions over dimension 0 (``.any()``, ``.sum()``);
* ``proc_id`` — ``torch.arange(p)``.
"""
from __future__ import annotations

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


def exclusive_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.cumsum(x, dim=dim, dtype=x.dtype) - x


def lex_sort(operands: Sequence[torch.Tensor], num_keys: int) -> tuple:
    """Stable lexicographic sort along the last dimension (§5.1.1 tagged
    compare): stable argsorts of the keys, least significant key first."""
    order = None
    for key in reversed(operands[:num_keys]):
        k = key if order is None else key.gather(-1, order)
        step = torch.sort(k, dim=-1, stable=True).indices
        order = step if order is None else order.gather(-1, step)
    return tuple(op.gather(-1, order) for op in operands)


def lex_less(ka, pa, ia, kb, pb, ib):
    """(key, proc, idx) lexicographic strict less-than — §5.1.1's comparator."""
    return (ka < kb) | ((ka == kb) & ((pa < pb) | ((pa == pb) & (ia < ib))))


def take_rows(v: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``out[r, j, ...] = v[r, index[r, j], ...]`` for any trailing dims."""
    rows = torch.arange(v.shape[0], device=v.device).unsqueeze(1)
    return v[rows, index.long()]
