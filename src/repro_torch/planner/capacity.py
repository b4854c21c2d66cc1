"""Segment-aware w.h.p. pair-capacity bound for striped fused batches.

Why the classic bound fails fused batches — and what restores it
----------------------------------------------------------------
The whp pair capacity (``SortConfig.pair_cap``, Claim 5.1 scale) assumes
each lane's run is a value-representative ~n/p share of the input, so each
(src, dst) routing cell carries ~n/p² keys. The *contiguous* segment
packing breaks that structurally: a lane's run spans only a couple of
segments, and because the fused sorted order is segment-major, the lane's
whole run routes to the destination covering its own global position range
(max pair load ≈ n_per_proc — measured, not just theorized, by the JAX
package's planner tests). That is why multi-segment batches were pinned to
the ``exact`` tier.

The *striped* layout (``core/segmented.pack_segments(layout="striped")``)
gives every lane ~1/p of every segment, making lanes representative again.
What remains — and what this module bounds — are the second-order
concentrations the classic bound never had to face:

* **small segments**: a segment that fits inside one routing bucket
  contributes its whole per-lane chunk ``m̂_s = ⌈m_s/p⌉`` to a single
  (src, dst) cell, granularity the n/p² term ignores;
* **duplicates**: a value block sorts contiguously ordered by source
  (lane, idx) — the §5.1.1 tag order — so a lane's copies of one value
  land in one bucket. A segment with top-value share δ_s can concentrate
  ``δ_s · m̂_s`` extra keys into a cell;
* **pads**: striped packing gives pads distinct interleaved composites, so
  the pad tail behaves like one perfectly-spread segment (δ = 0); the
  single-segment int32 path keeps constant sentinel pads, i.e. δ = 1.

The bound: slide a window of the whp bucket width
``W = ⌈(1 + 1/ω) · n_per_proc⌉`` over the segment extents of the fused
sorted order and take

    load(t) = Σ_s  m̂_s · min(1, overlap_s(t)/m_s + δ_s)

maximized over window positions t (piecewise linear in t, so evaluating
every breakpoint — overlap kinks at segment/window-edge alignments plus
the duplicate-clip kinks where the min saturates — is exact). The
returned capacity adds Chernoff-style slack ``ω·√load + ω`` for the
hypergeometric fluctuation of which values a lane's chunk drew. The
oversampling regulator ω is *the* tunable: it widens the window (more
splitter fluctuation tolerated → smaller failure probability) and scales
the slack, and :func:`solve_omega` picks it by minimizing routed volume
p·cap(ω) plus the Ph3 sample cost 2ω²·lg n the paper's analysis charges.

Validation: the JAX package's Monte-Carlo fault-rate check
packs adversarial multi-segment batches (U/G/B/DD/zipf keys, zipf sizes)
and asserts the bound's observed starting-tier fault rate stays within the
planner's whp target.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

from .fingerprint import Fingerprint


#: above this segment count the exact O(R²) breakpoint scan hands over to
#: the O(R) conservative sweep — host-side planning must never rival the
#: sort it plans (a flood of tiny requests can put thousands of segments
#: in one batch)
MAX_EXACT_SCAN_SEGMENTS = 512


def _window_load_max_coarse(
    sizes: np.ndarray, dups: np.ndarray, p: int, width: float
) -> float:
    """O(R) upper bound on the exact window scan for huge segment counts.

    Per overlapped segment, ``m̂·min(1, ov/m + δ) ≤ ov/p + 1 + ⌈m/p⌉·δ``
    (since ``m̂ ≤ m/p + 1`` and ``ov ≤ m``), so any window's load is at
    most ``W/p + (#overlapped segments) + Σ ⌈m/p⌉·δ``. The overlap set
    only changes at segment enter/leave events, so one two-pointer sweep
    over segments maximizes the count and dup-mass terms together. Looser
    than the exact scan (it charges every overlapped segment a full +1 of
    rotation granularity) but always ≥ it — a plan from this path is
    conservative, never unsound.
    """
    m = sizes.astype(np.float64)
    ends = np.cumsum(m)
    starts = ends - m
    dup_mass = np.ceil(m / p) * dups
    best, j, count, dmass = 0.0, 0, 0, 0.0
    # windows whose LEFTMOST overlapped segment is i: the right edge can
    # reach up to ends[i] + width (left edge just inside segment i), so
    # the maximal overlap set is every j with starts[j] < ends[i] + width
    for i in range(len(m)):
        while j < len(m) and starts[j] < ends[i] + width:
            count += 1
            dmass += dup_mass[j]
            j += 1
        best = max(best, count + dmass)
        count -= 1
        dmass -= dup_mass[i]
    return width / p + best


def _window_load_max(
    sizes: np.ndarray, dups: np.ndarray, p: int, width: int
) -> float:
    """Max over window positions of Σ m̂_s·min(1, overlap/m_s + δ_s).

    The load is piecewise linear in the window start t, so its maximum sits
    at a breakpoint. Per segment those are: the four overlap kinks (window
    edge meets a segment edge — t ∈ {start−W, end−W, start, end}) and the
    two duplicate-clip kinks where ``overlap/m + δ`` saturates at 1
    (overlap = (1−δ)·m on the entering and leaving flank). Evaluating every
    breakpoint makes the scan exact; a starts/ends-only candidate set
    undersizes the bound on dup-heavy mixes (caught in review by brute
    force, now pinned in tests). Beyond ``MAX_EXACT_SCAN_SEGMENTS`` the
    O(R²) scan hands over to the O(R) conservative sweep.
    """
    if len(sizes) > MAX_EXACT_SCAN_SEGMENTS:
        total = float(sizes.sum())
        return _window_load_max_coarse(
            sizes, dups, p, float(min(width, total))
        )
    m = sizes.astype(np.float64)
    ends = np.cumsum(m)
    starts = ends - m
    m_hat = np.ceil(m / p)
    total = float(ends[-1])
    width = float(min(width, total))
    clip = (1.0 - np.minimum(dups, 1.0)) * m  # overlap where the min clips
    raw = np.concatenate(
        [
            starts, ends, starts - width, ends - width,
            starts + clip - width, ends - clip,
        ]
    )
    # the dup term applies only to OVERLAPPED segments (a duplicate block
    # concentrates inside its segment's extent, not everywhere), which
    # makes the load jump at ov = 0 boundaries — evaluate an epsilon inside
    # each breakpoint too, so the supremum of an open piece is not missed
    eps = max(total, 1.0) * 1e-9
    cand = np.unique(
        np.clip(np.concatenate([raw, raw - eps, raw + eps]), 0.0, total - width)
    )
    best = 0.0
    for t in cand:
        ov = np.clip(np.minimum(ends, t + width) - np.maximum(starts, t), 0.0, None)
        term = m_hat * np.minimum(1.0, ov / m + dups)
        load = float(np.where(ov > 0.0, term, 0.0).sum())
        best = max(best, load)
    return best


def segment_aware_pair_cap(
    sizes: Sequence[int],
    p: int,
    n_per_proc: int,
    *,
    omega: Optional[float] = None,
    dup_fractions: Optional[Sequence[float]] = None,
    pad_dup: float = 0.0,
) -> int:
    """Per-(src, dst) capacity bound for a striped-packed fused batch.

    ``sizes``/``dup_fractions`` describe the real segments; the
    ``p·n_per_proc − Σsizes`` pad tail is appended as one more segment with
    top-value share ``pad_dup`` (0.0 for the striped distinct-pad lift, 1.0
    for the single-segment constant int32 sentinel). Returns keys, not
    bytes; unaligned — ``SortConfig.pair_cap`` handles pad_align and the
    exact-tier clamp.
    """
    n = p * n_per_proc
    if omega is None:
        omega = max(1.0, math.sqrt(math.log2(max(n, 2))))
    sizes = [int(s) for s in sizes]
    dups = (
        list(dup_fractions)
        if dup_fractions is not None
        else [0.0] * len(sizes)
    )
    if len(dups) != len(sizes):
        raise ValueError("dup_fractions must align with sizes")
    pad = n - sum(sizes)
    if pad < 0:
        raise ValueError(f"batch of {sum(sizes)} keys exceeds n={n}")
    seg = [(s, d) for s, d in zip(sizes, dups) if s > 0]
    if pad > 0:
        seg.append((pad, float(pad_dup)))
    if not seg:
        return 0
    arr = np.asarray([s for s, _ in seg], np.int64)
    dar = np.asarray([d for _, d in seg], np.float64)
    width = int(math.ceil((1.0 + 1.0 / omega) * n_per_proc))
    load = _window_load_max(arr, dar, p, width)
    cap = load + omega * math.sqrt(load) + omega
    return int(math.ceil(cap))


def solve_omega(
    sizes: Sequence[int],
    p: int,
    n_per_proc: int,
    *,
    dup_fractions: Optional[Sequence[float]] = None,
    pad_dup: float = 0.0,
    grid: Tuple[float, ...] = (0.5, 1.0, 2.0, 4.0),
) -> Tuple[float, int]:
    """Pick the oversampling regulator the bound solves best under.

    Cost model per lane: routed volume ``p · cap(ω)`` (the p pair cells)
    plus the randomized Ph3 sample ``2·ω²·lg n`` the paper charges
    (Fig. 2/3 step 1). The grid spans ω₀·{½,1,2,4} around the paper's
    default ω₀ = √(lg n) — a fixed menu, so planner-chosen configs stay a
    bounded set for the executor registry. Returns ``(omega, cap_keys)``.
    """
    n = p * n_per_proc
    omega0 = max(1.0, math.sqrt(math.log2(max(n, 2))))
    best = None
    for mult in grid:
        om = max(1.0, omega0 * mult)
        cap = segment_aware_pair_cap(
            sizes, p, n_per_proc,
            omega=om, dup_fractions=dup_fractions, pad_dup=pad_dup,
        )
        cost = p * cap + 2.0 * om * om * math.log2(max(n, 2))
        if best is None or cost < best[0]:
            best = (cost, om, cap)
    return best[1], best[2]


def planned_cap_for(fp: Fingerprint, *, single_segment: bool = False) -> Tuple[float, int]:
    """(omega, pair cap) for a fingerprinted batch; pad regime from layout."""
    return solve_omega(
        fp.sizes,
        fp.p,
        fp.n_per_proc,
        dup_fractions=fp.dup_fractions,
        # single-segment batches keep the raw-int32 path whose pads are the
        # constant sentinel (fully concentrated); striped multi-segment
        # batches get the distinct interleaved pad lift (fully spread)
        pad_dup=1.0 if single_segment else 0.0,
    )
