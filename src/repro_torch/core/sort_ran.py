"""SORT_RAN_BSP (Fig. 2) — the classic one-round randomized sample sort.

The pattern the paper departs from: sample and select splitters first,
route, then sort locally. Step 9's set formation (the paper's D·n/p
operation) is the untagged rank of every key among the splitters plus a
stable argsort by destination; step 12 is a full stable local sort of the
receive buffer, not a merge.

Nothing here is tier-invariant: :func:`prepare_ran_spmd` wraps the input
and :func:`route_ran_spmd` runs everything on the rung's sample positions.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import merge as merge_mod
from . import primitives as prim
from . import routing
from .types import PreparedSort, SortConfig


def prepare_ran_spmd(
    x: torch.Tensor, cfg: SortConfig, values: Sequence[torch.Tensor] = (), procs=None
) -> PreparedSort:
    """No tier-invariant work: the classic sample sort sorts locally last."""
    return PreparedSort(xs=x, vals=tuple(values), splits=None)


def route_ran_spmd(
    prep: PreparedSort, cfg: SortConfig, positions: torch.Tensor, procs=None
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor, torch.Tensor]:
    x, values = prep.xs, list(prep.vals)
    p, rows = cfg.p, x.shape[0]
    procs = prim.procs_or_local(procs, p)
    dev = x.device
    # Fig. 2 steps 2-5: the sample of every processor, gathered and sorted
    # (computed once and replicated); step 6: p-1 evenly spaced splitters
    ybar = prim.stable_sort(procs.gather_rows(prim.take_rows(x, positions)).reshape(-1))[0]
    splits = ybar[torch.arange(1, p, device=dev) * cfg.s - 1]
    # step 9: destination of every key, then a stable sort by destination
    exact = x.is_floating_point()
    dest = prim.searchsorted(splits.expand(rows, p - 1), x, "right", exact)
    dest_sorted, order = prim.stable_sort(dest)
    xg = prim.gather(x, 1, order)
    vals = [prim.take_rows(v, order) for v in values]
    edges = torch.arange(p + 1, dtype=torch.int32, device=dev).expand(rows, p + 1)
    bounds = prim.searchsorted(dest_sorted, edges, "left")
    # steps 10-11: routing; step 12: full local sort of the receive buffer
    buf, vbufs, count, overflow = routing.route(xg, bounds, cfg, vals, procs)
    merged, mvals = merge_mod.merge_by_sort(buf, vbufs)
    return merged, mvals, count, overflow


def sort_ran_spmd(
    x: torch.Tensor, cfg: SortConfig, positions: torch.Tensor, values: Sequence[torch.Tensor] = (), procs=None
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor, torch.Tensor]:
    return route_ran_spmd(prepare_ran_spmd(x, cfg, values), cfg, positions, procs)
