"""SORT_DET_BSP (Fig. 1) — deterministic regular-oversampling sample sort.

Phases over the (p, n_per_proc) layout:
  Ph2 SeqSort  — stable local sort of every run;
  Ph3 Sampling — regular oversampling, sample sort, splitter selection;
  Ph4 Prefix   — tagged binary-search partition of every run;
  Ph5 Routing  — the single balanced h-relation (capacity of the tier);
  Ph6 Merging  — stable multi-way merge of the received sorted runs.

Ph2/Ph3 do not depend on the capacity tier, so the overflow-safe driver
runs :func:`prepare_det_spmd` once and re-enters :func:`route_det_spmd`
per ladder rung. Each phase runs in an ``obs.trace.stage`` (``local_sort``,
``splitters``, ``partition``; Ph5/Ph6 in ``routing.route_and_merge``).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..obs.trace import stage
from . import routing, splitters
from .local_sort import local_sort
from .types import PreparedSort, SortConfig


def prepare_det_spmd(
    x: torch.Tensor, cfg: SortConfig, values: Sequence[torch.Tensor] = (), procs=None
) -> PreparedSort:
    """Tier-invariant stages: Ph2 local sort + Ph3 sample/splitters."""
    with stage("local_sort", keys=x.numel()):
        xs, vals = local_sort(x, cfg.local_sort, values)
    with stage("splitters", keys=xs.numel()):
        splits = splitters.splitter_stage(xs, cfg, procs=procs)
    return PreparedSort(xs=xs, vals=tuple(vals), splits=splits)


def route_det_spmd(
    prep: PreparedSort, cfg: SortConfig, procs=None
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Tier-dependent stages: Ph4 partition, Ph5 routing, Ph6 merge."""
    with stage("partition", keys=prep.xs.numel()):
        bounds = splitters.searchsorted_tagged(prep.xs, prep.splits, procs)
    return routing.route_and_merge(prep.xs, bounds, cfg, list(prep.vals), procs)


def sort_det_spmd(
    x: torch.Tensor, cfg: SortConfig, values: Sequence[torch.Tensor] = (), procs=None
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor, torch.Tensor]:
    return route_det_spmd(prepare_det_spmd(x, cfg, values, procs), cfg, procs)
