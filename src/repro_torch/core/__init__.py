"""BSP sorting over p simulated processors: SORT_DET_BSP, SORT_IRAN_BSP,
SORT_RAN_BSP and [BSI] (``SortConfig.algorithm``).

Public API:
    SortConfig, SortResult, PreparedSort — configuration / result types
    bsp_sort                             — one sort at the config's capacity
    bsp_sort_safe / bsp_sort_safe_launch,
    InFlightSort                         — overflow-safe driver: prepare once,
                                           then the route stage per rung of
                                           the capacity ladder
    TierStats                            — per-tier retry counters
    gathered_output                      — valid prefixes concatenated
    config_from_reference,
    prepared_from_reference              — carry state from the JAX package
    datagen                              — §6.3 benchmark input distributions
"""
from .api import (
    InFlightSort,
    TierStats,
    bsp_sort,
    bsp_sort_safe,
    bsp_sort_safe_launch,
    gathered_output,
)
from .convert import config_from_reference, prepared_from_reference
from .types import PreparedSort, SortConfig, SortResult, sentinel_for

from . import datagen  # noqa: F401

__all__ = [
    "InFlightSort",
    "PreparedSort",
    "SortConfig",
    "SortResult",
    "TierStats",
    "bsp_sort",
    "bsp_sort_safe",
    "bsp_sort_safe_launch",
    "config_from_reference",
    "datagen",
    "gathered_output",
    "prepared_from_reference",
    "sentinel_for",
]
