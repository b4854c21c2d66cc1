"""[BSI] — Batcher's bitonic sort across processors (paper §6.2 item 3).

Classic hypercube compare-split: after a local sort, lg p · (lg p + 1)/2
supersteps; in each, partners (k, k XOR 2^j) exchange their n/p-key runs,
one keeps the lower half of the merge and the other the upper half. Always
exactly n/p keys per processor, so no capacity machinery, but Θ(lg² p)
routing rounds of n/p words against the sample sorts' single round. Key
only, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch

from . import primitives as prim
from .local_sort import local_sort
from .types import SortConfig


def _compare_split(xs: torch.Tensor, other: torch.Tensor, keep_low: torch.Tensor) -> torch.Tensor:
    n_p = xs.shape[1]
    merged = prim.stable_sort(torch.cat([xs, other], dim=1))[0]
    return torch.where(keep_low, merged[:, :n_p], merged[:, n_p:])


def sort_bitonic_spmd(
    x: torch.Tensor, cfg: SortConfig, values: Sequence[torch.Tensor] = (), procs=None
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor, torch.Tensor]:
    if values:
        raise NotImplementedError("[BSI] baseline is key-only")
    rows, n_p = x.shape
    procs = prim.procs_or_local(procs, cfg.p)
    me = procs.proc_id(x.device)
    xs, _ = local_sort(x, cfg.local_sort)
    for i in range(int(math.log2(cfg.p))):
        for j in range(i, -1, -1):
            other = procs.exchange_with(xs, 1 << j)
            up = ((me >> (i + 1)) & 1) == 0
            lower_half = ((me >> j) & 1) == 0
            xs = _compare_split(xs, other, (up == lower_half)[:, None])
    count = torch.full((rows,), n_p, dtype=torch.int32, device=x.device)
    return xs, [], count, torch.zeros((rows,), dtype=torch.bool, device=x.device)
