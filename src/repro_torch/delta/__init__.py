"""Delta sort of the port — incremental sorted-view maintenance.

Near-sorted streams do not pay the full O(n log n) ladder: only the
out-of-place Δ routes through the fused h-relation, and one rank merge
folds it into the standing run. ``fold.py`` holds the composite lift that
makes the result byte-identical to a cold sort, ``view.py`` the stateful
``SortedView`` (folds and §5.1.1 tombstones). The JAX package's
``repro.delta``, ported.
"""
from .fold import (
    InFlightDeltaSort,
    drop_positions,
    lift_positions,
    merge_sorted_runs,
    near_sorted_sort,
    near_sorted_sort_launch,
    split_sorted_run,
)
from .view import SortedView

__all__ = [
    "InFlightDeltaSort",
    "SortedView",
    "drop_positions",
    "lift_positions",
    "merge_sorted_runs",
    "near_sorted_sort",
    "near_sorted_sort_launch",
    "split_sorted_run",
]
