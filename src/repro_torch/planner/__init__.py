"""Adaptive capacity planner of the port — segment-aware oversampling
bounds plus traffic-learned tier selection for fused sorts.

Host code (numpy), a copy of the JAX package's ``repro.planner`` that
imports nothing of it; its decisions and its JSON history are the same,
so a history written by either package loads into the other.

    fingerprint.py   sort-free workload summary (sizes, lane segment
                     spread, sampled duplicate fractions, key dtype +
                     sampled range/balance) + bucket keys
    capacity.py      segment-aware w.h.p. pair-capacity bound for striped
                     fused batches; solves for the oversampling ratio
    planner.py       CapacityPlanner: bucket → (route, starting tier, ω)
                     with JSON-persisted fault-rate feedback; balanced
                     integer-key batches take route="radix"
                     (count-then-distribute, single exact-capacity rung);
                     near-sorted single-segment batches take route="delta"
                     (``repro_torch.delta`` fold — only the out-of-place Δ
                     moves)

Consumers: a planned segmented sort (fingerprint → ``plan`` →
``pack_segments(layout=decision.layout)`` → ``segmented_sort_safe`` with
the decision's capacity → ``record``), and the ``planner=`` policy of
``repro_torch.core.bsp_sort_safe``.
"""
from .capacity import planned_cap_for, segment_aware_pair_cap, solve_omega
from .fingerprint import (
    Fingerprint,
    bucket_key,
    fingerprint_arrays,
    lane_spread,
    radix_share,
    sampled_dup_fraction,
    sampled_range_bits,
    sampled_sortedness,
)
from .planner import CapacityPlanner, PlanDecision

__all__ = [
    "CapacityPlanner",
    "Fingerprint",
    "PlanDecision",
    "bucket_key",
    "fingerprint_arrays",
    "lane_spread",
    "planned_cap_for",
    "radix_share",
    "sampled_dup_fraction",
    "sampled_range_bits",
    "sampled_sortedness",
    "segment_aware_pair_cap",
    "solve_omega",
]
