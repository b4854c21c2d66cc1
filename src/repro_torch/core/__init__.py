"""BSP sorting over p simulated processors, or one processor per rank of a
``torch.distributed`` mesh axis: SORT_DET_BSP, SORT_IRAN_BSP,
SORT_RAN_BSP and [BSI] (``SortConfig.algorithm``), the radix route and the
radix local sort ([DSR]/[RSR]).

Public API:
    SortConfig, SortResult, PreparedSort — configuration / result types
    bsp_sort                             — one sort at the config's capacity
    bsp_sort_sharded,
    bsp_sort_sharded_safe                — the same, one processor per rank
                                           of a mesh axis
    bsp_sort_safe / bsp_sort_safe_launch,
    InFlightSort                         — overflow-safe driver: prepare once,
                                           then the route stage per rung of
                                           the capacity ladder
    TierStats                            — per-tier retry counters
    SortExecutor, default_executor       — registry of the stage callables
    phase_fns                            — Ph2..Ph6 as separate callables
    gathered_output                      — valid prefixes concatenated
    predict, BSPMachine, CRAY_T3D        — the BSP (p, L, g) cost model
    pack_segments, sort_segments,
    segmented_sort_safe,
    segmented_sort_launch                — many ragged requests fused into one
                                           (segment, key)-tagged sort
    config_from_reference,
    prepared_from_reference,
    planner_from_reference,
    view_from_reference,
    fault_plan_from_reference,
    service_config_from_reference,
    params_from_reference                — carry state from the JAX package
    datagen                              — §6.3 benchmark input distributions
"""
from .api import (
    InFlightSort,
    SortExecutor,
    TierStats,
    bsp_sort,
    bsp_sort_safe,
    bsp_sort_safe_launch,
    bsp_sort_sharded,
    bsp_sort_sharded_safe,
    default_executor,
    gathered_output,
    phase_fns,
    spmd_prepare_fn,
    spmd_route_fn,
    spmd_sort_fn,
)
from .bsp import BSPMachine, CRAY_T3D, Prediction, predict, theoretical_max_imbalance
from .convert import (
    config_from_reference,
    fault_plan_from_reference,
    opt_state_from_reference,
    params_from_reference,
    planner_from_reference,
    prepared_from_reference,
    service_config_from_reference,
    tree_to_reference,
    view_from_reference,
)
from .segmented import (
    InFlightSegmentedSort,
    PackedSegments,
    SegmentedResult,
    pack_segments,
    segmented_sort_launch,
    segmented_sort_safe,
    sort_segments,
)
from .types import PreparedSort, SortConfig, SortResult, sentinel_for

from . import datagen  # noqa: F401

__all__ = [
    "BSPMachine",
    "CRAY_T3D",
    "InFlightSegmentedSort",
    "InFlightSort",
    "PackedSegments",
    "Prediction",
    "PreparedSort",
    "SegmentedResult",
    "SortConfig",
    "SortExecutor",
    "SortResult",
    "TierStats",
    "bsp_sort",
    "bsp_sort_safe",
    "bsp_sort_safe_launch",
    "bsp_sort_sharded",
    "bsp_sort_sharded_safe",
    "config_from_reference",
    "datagen",
    "default_executor",
    "fault_plan_from_reference",
    "gathered_output",
    "pack_segments",
    "opt_state_from_reference",
    "params_from_reference",
    "phase_fns",
    "planner_from_reference",
    "predict",
    "prepared_from_reference",
    "segmented_sort_launch",
    "service_config_from_reference",
    "segmented_sort_safe",
    "sentinel_for",
    "sort_segments",
    "spmd_prepare_fn",
    "spmd_route_fn",
    "spmd_sort_fn",
    "theoretical_max_imbalance",
    "tree_to_reference",
    "view_from_reference",
]
