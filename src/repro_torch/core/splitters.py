"""Sampling and splitter machinery of SORT_DET_BSP (Fig. 1 steps 4–9).

* deterministic regular oversampling — s evenly spaced keys of every run
  (+ the local max by saturation), Fig. 1 step 4;
* transparent duplicate tagging (§5.1.1): only sample/splitter records
  carry explicit (processor, index) tags;
* parallel sample sort by gather: the o(n) sample of all processors is
  sorted with one stable lexicographic sort (every processor would compute
  the same result, so it is computed once and replicated);
* :func:`searchsorted_tagged` — Ph4's vectorized binary search of the
  tagged splitters in every sorted run under the (key, proc, idx) order.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from . import primitives as prim
from .types import SortConfig

Tagged = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (keys, procs, idxs)


def regular_sample(x_sorted: torch.Tensor, cfg: SortConfig) -> Tagged:
    """s segment right-boundaries of every run (p, n_p) -> three (p, s)."""
    p, n_p = x_sorted.shape
    s, x = cfg.s, cfg.segment_len
    dev = x_sorted.device
    pos = torch.arange(1, s + 1, device=dev) * x - 1
    idx = torch.clamp(pos, max=n_p - 1).to(torch.int32)
    keys = x_sorted[:, idx.long()]
    procs = prim.proc_id(p, dev)[:, None].expand(p, s)
    return keys, procs, idx.expand(p, s)


def sample_sort_gather(sample: Tagged) -> Tagged:
    """All-gather the sample (proc-major) and sort it lexicographically."""
    gathered = tuple(a.reshape(-1) for a in sample)
    return prim.lex_sort(gathered, num_keys=3)


def select_splitters(cfg: SortConfig, sorted_sample: Tagged) -> Tagged:
    """Fig. 1 step 6: the p-1 splitters at positions i·s-1, replicated (p, p-1)."""
    p, s = cfg.p, cfg.s
    pos = torch.arange(1, p, device=sorted_sample[0].device) * s - 1
    return tuple(a[pos].unsqueeze(0).expand(p, p - 1).contiguous() for a in sorted_sample)


def searchsorted_tagged(x_sorted: torch.Tensor, splitters: Tagged) -> torch.Tensor:
    """Partition boundaries (p, p+1) int32 of every run by the tagged splitters.

    Element j of processor ``me`` lies left of splitter (ks, ps, is) iff
    (x[j], me, j) < (ks, ps, is); the predicate is monotone along a sorted
    run, so ⌈lg(n_p+1)⌉ halving steps count it.
    """
    p, n_p = x_sorted.shape
    sk, sp, si = splitters
    dev = x_sorted.device
    me = prim.proc_id(p, dev)[:, None]
    nq = sk.shape[1]
    lo = torch.zeros((p, nq), dtype=torch.int32, device=dev)
    hi = torch.full((p, nq), n_p, dtype=torch.int32, device=dev)
    for _ in range(max(1, math.ceil(math.log2(n_p + 1)))):
        active = lo < hi  # converged lanes must not move (mid == hi is out of range)
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        xm = x_sorted.gather(1, torch.clamp(mid, 0, n_p - 1).long())
        less = prim.lex_less(xm, me, mid, sk, sp, si)
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    zeros = torch.zeros((p, 1), dtype=torch.int32, device=dev)
    return torch.cat([zeros, lo, torch.full_like(zeros, n_p)], dim=1)


def splitter_stage(x_sorted: torch.Tensor, cfg: SortConfig) -> Tagged:
    """Ph3 for ``det``: regular sample, sample sort, splitter selection."""
    if cfg.algorithm != "det":
        raise NotImplementedError(
            f"algorithm={cfg.algorithm!r} is not ported yet (see ROADMAP.md, queue 1)"
        )
    if cfg.sample_sort != "gather":
        raise NotImplementedError(
            "sample_sort='bitonic' is not ported yet (see ROADMAP.md, queue 1)"
        )
    sample = regular_sample(x_sorted, cfg)
    return select_splitters(cfg, sample_sort_gather(sample))
