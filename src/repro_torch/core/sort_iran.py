"""SORT_IRAN_BSP (Fig. 3) — the paper's randomized algorithm.

Local sort first, then randomized oversampling (s = 2ω²·lg n per
processor), the sample sort, one balanced routing round and a final stable
multi-way merge. It shares Ph4–Ph6, and §5.1.1's duplicate handling, with
SORT_DET_BSP.

Only Ph2 does not depend on the capacity tier: the sample is drawn anew for
every ladder rung, so a retry is an independent splitter trial (re-routing
with the splitters that just overflowed would fail the same way on skewed
inputs). :func:`prepare_iran_spmd` carries the sorted run and
:func:`route_iran_spmd` runs Ph3–Ph6 on the rung's sample positions.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import routing, splitters
from .local_sort import local_sort
from .types import PreparedSort, SortConfig


def prepare_iran_spmd(
    x: torch.Tensor, cfg: SortConfig, values: Sequence[torch.Tensor] = (), procs=None
) -> PreparedSort:
    """Tier-invariant stage: Ph2 stable local sort (keys + payload)."""
    xs, vals = local_sort(x, cfg.local_sort, values)
    return PreparedSort(xs=xs, vals=tuple(vals), splits=None)


def route_iran_spmd(
    prep: PreparedSort, cfg: SortConfig, positions: torch.Tensor, procs=None
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Tier-dependent stages: Ph3 splitters from the (rows, s) sample
    positions, Ph4 partition, Ph5 routing, Ph6 merge."""
    splits = splitters.splitter_stage(prep.xs, cfg, positions, procs)
    bounds = splitters.searchsorted_tagged(prep.xs, splits, procs)
    return routing.route_and_merge(prep.xs, bounds, cfg, list(prep.vals), procs)


def sort_iran_spmd(
    x: torch.Tensor, cfg: SortConfig, positions: torch.Tensor, values: Sequence[torch.Tensor] = (), procs=None
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor, torch.Tensor]:
    return route_iran_spmd(prepare_iran_spmd(x, cfg, values), cfg, positions, procs)
