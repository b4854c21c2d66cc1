"""Sampling and splitter machinery (Fig. 1 steps 4–9, Fig. 3 step 4).

* deterministic regular oversampling — s evenly spaced keys of every run
  (+ the local max by saturation), Fig. 1 step 4;
* randomized oversampling — s positions of every run, drawn by the caller
  (:func:`sample_positions`; the JAX package draws them from ``jax.random``,
  which torch cannot reproduce, so its tests hand both packages the same
  positions), Fig. 3 step 4;
* transparent duplicate tagging (§5.1.1): only sample/splitter records
  carry explicit (processor, index) tags;
* parallel sample sort by ``gather`` (the o(n) sample of all processors is
  sorted with one stable lexicographic sort, computed once and replicated)
  or by ``bitonic`` (Batcher's compare-split over the processor dimension,
  the paper's scheme);
* :func:`searchsorted_tagged` — Ph4's vectorized binary search of the
  tagged splitters in every sorted run under the (key, proc, idx) order.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import primitives as prim
from .types import SortConfig, to_device

Tagged = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (keys, procs, idxs)


def regular_sample(x_sorted: torch.Tensor, cfg: SortConfig, procs=None) -> Tagged:
    """s segment right-boundaries of every run (rows, n_p) -> three (rows, s)."""
    rows, n_p = x_sorted.shape
    procs = prim.procs_or_local(procs, cfg.p)
    s, x = cfg.s, cfg.segment_len
    dev = x_sorted.device
    pos = torch.arange(1, s + 1, device=dev) * x - 1
    idx = torch.clamp(pos, max=n_p - 1).to(torch.int32)
    keys = x_sorted[:, idx.long()]
    tags = procs.proc_id(dev)[:, None].expand(rows, s)
    return keys, tags, idx.expand(rows, s)


def sample_positions(cfg: SortConfig, generator: torch.Generator, device) -> torch.Tensor:
    """(p, s) int32 uniform positions in every run, drawn on the host.

    Drawn from a CPU generator so the card and the CPU take the same sample
    (and every rank of a sharded sort the same table: each keeps its row).
    Sorted per processor for ``iran`` (the run is sorted, so sorting the
    positions sorts the sample), left as drawn for ``ran``.
    """
    pos = torch.randint(0, cfg.n_per_proc, (cfg.p, cfg.s), generator=generator)
    if cfg.algorithm == "iran":
        pos = torch.sort(pos, dim=1).values
    return to_device(pos.to(torch.int32), device)


def random_sample(x_sorted: torch.Tensor, positions: torch.Tensor, procs=None) -> Tagged:
    """The keys of every run (rows, n_p) at its positions (rows, s), tagged."""
    rows, s = positions.shape
    procs = prim.procs_or_local(procs, rows)
    tags = procs.proc_id(x_sorted.device)[:, None].expand(rows, s)
    idx = positions.to(torch.int32)
    return prim.take_rows(x_sorted, idx), tags, idx


def sample_sort_gather(sample: Tagged, procs=None) -> Tagged:
    """All-gather the sample (proc-major) and sort it lexicographically."""
    procs = prim.procs_or_local(procs, sample[0].shape[0])
    gathered = tuple(procs.gather_rows(a).reshape(-1) for a in sample)
    return prim.lex_sort(gathered, num_keys=3)


def _merge_split_tagged(a: Tagged, b: Tagged, keep_low: torch.Tensor) -> Tagged:
    """Bitonic compare-split: merge two sorted tagged runs, keep one half."""
    m = a[0].shape[1]
    cat = tuple(torch.cat([ai, bi], dim=1) for ai, bi in zip(a, b))
    merged = prim.lex_sort(cat, num_keys=3)
    return tuple(torch.where(keep_low, t[:, :m], t[:, m:]) for t in merged)


def sample_sort_bitonic(sample: Tagged, p: int, procs=None) -> Tagged:
    """Batcher's bitonic sort of the tagged sample over the processors.

    Every run (rows, s) must be sorted already. lg p · (lg p + 1)/2
    compare-split supersteps, each one exchange with the XOR partner.
    """
    procs = prim.procs_or_local(procs, p)
    lgp = int(math.log2(p))
    me = procs.proc_id(sample[0].device)
    cur = tuple(a.contiguous() for a in sample)
    for i in range(lgp):
        for j in range(i, -1, -1):
            other = procs.exchange_with(cur, 1 << j)
            up = ((me >> (i + 1)) & 1) == 0
            lower_half = ((me >> j) & 1) == 0
            cur = _merge_split_tagged(cur, other, (up == lower_half)[:, None])
    return cur


def select_splitters(cfg: SortConfig, sorted_sample: Tagged, mode: str = "gather", procs=None) -> Tagged:
    """Fig. 1 step 6: the p-1 splitters, replicated (rows, p-1).

    ``gather``: positions i·s-1 of the replicated sorted sample.
    ``bitonic``: splitter i is the last record of processor i-1's sorted
    run, broadcast by one all_gather of one record per processor.
    """
    p, s = cfg.p, cfg.s
    procs = prim.procs_or_local(procs, p)
    if mode == "gather":
        pos = torch.arange(1, p, device=sorted_sample[0].device) * s - 1
        picked = tuple(a[pos] for a in sorted_sample)
    else:
        picked = tuple(procs.gather_rows(a[:, -1])[:-1] for a in sorted_sample)
    return tuple(a.unsqueeze(0).expand(procs.rows, p - 1).contiguous() for a in picked)


def searchsorted_tagged(x_sorted: torch.Tensor, splitters: Tagged, procs=None) -> torch.Tensor:
    """Partition boundaries (rows, p+1) int32 of every run by the tagged splitters.

    Element j of processor ``me`` lies left of splitter (ks, ps, is) iff
    (x[j], me, j) < (ks, ps, is); the predicate is monotone along a sorted
    run, so ⌈lg(n_p+1)⌉ halving steps count it.
    """
    rows, n_p = x_sorted.shape
    sk, sp, si = splitters
    dev = x_sorted.device
    me = prim.procs_or_local(procs, rows).proc_id(dev)[:, None]
    nq = sk.shape[1]
    lo = torch.zeros((rows, nq), dtype=torch.int32, device=dev)
    hi = torch.full((rows, nq), n_p, dtype=torch.int32, device=dev)
    for _ in range(max(1, math.ceil(math.log2(n_p + 1)))):
        active = lo < hi  # converged lanes must not move (mid == hi is out of range)
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        xm = x_sorted.gather(1, torch.clamp(mid, 0, n_p - 1).long())
        less = prim.lex_less(xm, me, mid, sk, sp, si)
        lo = torch.where(active & less, mid + 1, lo)
        hi = torch.where(active & ~less, mid, hi)
    zeros = torch.zeros((rows, 1), dtype=torch.int32, device=dev)
    return torch.cat([zeros, lo, torch.full_like(zeros, n_p)], dim=1)


def splitter_stage(
    x_sorted: torch.Tensor, cfg: SortConfig, positions: Optional[torch.Tensor] = None, procs=None
) -> Tagged:
    """Full Ph3: sampling, sample sort and splitter selection.

    ``det`` takes the regular sample; ``iran`` the keys at ``positions``
    (rows, s), a sample drawn anew for every ladder rung.
    """
    procs = prim.procs_or_local(procs, cfg.p)
    if cfg.algorithm == "det":
        sample = regular_sample(x_sorted, cfg, procs)
    else:
        if positions is None:
            raise ValueError(f"algorithm={cfg.algorithm!r} needs sample positions")
        sample = random_sample(x_sorted, positions, procs)
    return splitters_from_sorted_sample(cfg, sample, procs)


def splitters_from_sorted_sample(cfg: SortConfig, sample: Tagged, procs=None) -> Tagged:
    """The configured sample sort of a tagged (rows, s) sample and the
    splitter selection after it: replicated (rows, p-1) splitters."""
    procs = prim.procs_or_local(procs, cfg.p)
    if cfg.sample_sort == "gather":
        return select_splitters(cfg, sample_sort_gather(sample, procs), "gather", procs)
    return select_splitters(cfg, sample_sort_bitonic(sample, cfg.p, procs), "bitonic", procs)
