"""Workload fingerprints — the cheap, sort-free summary a batch is planned by.

The capacity planner must decide a starting tier *before* sorting, from
quantities that cost o(n·log n) to compute:

* shape: total keys, processor lanes, the pow2 ``n_per_proc`` bucket;
* structure: segment count and per-segment sizes (known exactly from the
  request queue — no data inspection needed);
* **lane segment spread** — how many segments overlap each lane's run under
  the *contiguous* packing geometry. ``lane_spread_max == 1`` is the
  single-segment hot path; anything larger is the regime where contiguous
  packing value-clusters lanes and the planner switches to the striped
  layout (``core/segmented.pack_segments(layout="striped")``);
* **sampled duplicate fraction** per segment — the share of the segment
  occupied by its most frequent key value, estimated from a bounded sample.
  Duplicate blocks sort contiguously (ordered by source (lane, idx) under
  the stable pipeline), so a lane's copies of one value concentrate into
  one routing bucket; the segment-aware capacity bound
  (``planner.capacity``) inflates per-segment contributions by this
  fraction;
* **key dtype + sampled key-range shape** — whether the keys are integers
  (``int_key``), how many bits span the sampled value range
  (``key_range_bits``), and the estimated busiest-bucket share under
  range-normalized p-bucketing (``radix_share``). These drive the
  *route* decision: integer keys whose mass spreads evenly over their
  observed range (dense expert-id-like domains, uniform draws, fused
  multi-segment composites — their dense segment-id prefix dominates the
  bucketing) take the count-then-distribute ``route="radix"`` path and
  skip the splitter superstep entirely; skewed ranges (zipf heads) stay
  on the sample route whose splitters adapt to the mass.

Fingerprints quantize into **buckets** (:func:`bucket_key`): pow2 segment
count, coarse duplicate level, exact (p, n_per_proc) shape. Buckets are the
unit of traffic learning — the planner's fault history is kept per bucket,
so the key must be coarse enough to accumulate statistics and fine enough
that one rung fits all members.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.segmented import _pow2_n_per_proc, contiguous_lane_sizes

#: sample size per segment for the duplicate-fraction estimate
DUP_SAMPLE = 64

#: adjacent-pair sample size for the sortedness probe
SORT_SAMPLE = 256

#: quantization grain of the sortedness estimate (sixteenths) — routing
#: thresholds compare against a coarse grid, not a noisy raw fraction, so
#: two near-identical batches can't flap across the delta boundary
SORT_QUANT = 16


@dataclasses.dataclass(frozen=True)
class Fingerprint:
    """Sort-free workload summary of one (to-be-)fused batch."""

    n_keys: int
    p: int
    n_per_proc: int  # pow2 bucket the batch packs into
    sizes: Tuple[int, ...]  # per-segment lengths, submit order
    lane_spread_max: int  # segments overlapping the busiest contiguous lane
    lane_spread_mean: float
    dup_fractions: Tuple[float, ...]  # sampled per-segment top-value share
    int_key: bool = True  # integer key dtype (radix route applicability)
    key_range_bits: int = 31  # bits spanning the sampled value range
    radix_share: float = 1.0  # est. busiest range-bucket share (1.0 = worst)
    # sampled in-order adjacent-pair share, quantized to 1/SORT_QUANT
    # (1.0 = sorted, ~0.5 = shuffled). Probed only for single-segment int
    # batches — the delta fold route's applicability domain; fused batches
    # report 0.0 and never route delta.
    sorted_frac: float = 0.0

    @property
    def n_segments(self) -> int:
        return len(self.sizes)

    @property
    def dup_fraction(self) -> float:
        """Size-weighted mean duplicate fraction of the batch."""
        if not self.sizes or self.n_keys == 0:
            return 0.0
        w = np.asarray(self.sizes, np.float64)
        return float((w * np.asarray(self.dup_fractions)).sum() / w.sum())

    @property
    def pad_keys(self) -> int:
        return self.p * self.n_per_proc - self.n_keys


def _sampled(keys: np.ndarray, sample: int, seed: int) -> np.ndarray:
    """``min(len, sample)`` keys drawn by a deterministic rng."""
    n = int(keys.shape[0])
    if n <= sample:
        return np.asarray(keys)
    idx = np.random.default_rng(seed).choice(n, size=sample, replace=False)
    return np.asarray(keys)[idx]


def sampled_dup_fraction(
    keys: np.ndarray, sample: int = DUP_SAMPLE, seed: int = 0
) -> float:
    """Estimate the share of ``keys`` held by its most frequent value.

    Samples ``min(len, sample)`` keys (deterministic rng) and returns the
    top sampled value's frequency share — an upward-biased-enough estimate
    for capacity planning (the JAX package's Monte-Carlo test checks the
    *bound built on it*, not the estimator in isolation).
    """
    pick = _sampled(keys, sample, seed)
    if pick.size == 0:
        return 0.0
    _, counts = np.unique(pick, return_counts=True)
    return float(counts.max() / pick.size)


def sampled_sortedness(
    keys: np.ndarray, sample: int = SORT_SAMPLE, seed: int = 0
) -> float:
    """Quantized estimate of the in-order adjacent-pair share of ``keys``.

    Samples ``min(n-1, sample)`` adjacent pairs (deterministic rng) and
    returns the fraction with ``keys[i] <= keys[i+1]``, snapped to the
    1/``SORT_QUANT`` grid. A sorted stream scores 1.0; a shuffled one
    ~0.5; a sorted run with Δ·n scattered updates ~1 − 2Δ (each displaced
    key breaks at most its two incident pairs) — so the probe doubles as a
    Δ-share estimate: Δ/n ≈ (1 − sorted_frac) / 2. Mis-estimation is a
    cost-only risk; the delta route is byte-identical to the ladder
    whatever the true sortedness.
    """
    k = np.asarray(keys).reshape(-1)
    m = int(k.shape[0]) - 1
    if m < 1:
        return 1.0
    if m <= sample:
        idx = np.arange(m)
    else:
        idx = np.random.default_rng(seed).choice(m, size=sample, replace=False)
    frac = float(np.mean(k[idx] <= k[idx + 1]))
    return round(frac * SORT_QUANT) / SORT_QUANT


def sampled_range_bits(samples: Sequence[np.ndarray]) -> int:
    """Bits spanning the global sampled key range (0 = single value)."""
    nonempty = [s for s in samples if s.size]
    if not nonempty:
        return 0
    lo = min(int(s.min()) for s in nonempty)
    hi = max(int(s.max()) for s in nonempty)
    return int(hi - lo).bit_length()


def radix_share(
    samples: Sequence[np.ndarray], sizes: Sequence[int], p: int
) -> float:
    """Estimated busiest-bucket share under range-normalized p-bucketing.

    This is the balance the ``route="radix"`` destination function
    (``core.sort_radix.radix_boundaries``) would achieve — 1/p is perfect,
    1.0 aims everything at one processor (still *correct* under radix, the
    capacity is exact either way, but the busiest proc serializes the
    merge). Single-segment batches estimate it from the sampled raw keys;
    fused multi-segment batches from the segment sizes alone — the
    composite's dense segment-id prefix dominates the range, so buckets are
    runs of ``⌈R/p⌉`` consecutive segments (a conservative estimate for
    small R, where the low key bits would subdivide further).
    """
    sizes = [int(s) for s in sizes]
    total = sum(sizes)
    if total == 0 or p <= 0:
        return 1.0
    if len(sizes) > 1:
        width = (len(sizes) - 1) // p + 1
        shares = np.zeros(p, np.float64)
        for i, s in enumerate(sizes):
            shares[min(i // width, p - 1)] += s
        return float(shares.max() / total)
    s = np.asarray(samples[0])
    if s.size == 0:
        return 1.0
    lo, hi = int(s.min()), int(s.max())
    width = (hi - lo) // p + 1
    b = (s.astype(np.int64) - lo) // width
    return float(np.bincount(b, minlength=p).max() / s.size)


def lane_spread(sizes: Sequence[int], p: int) -> Tuple[int, float]:
    """(max, mean) segments overlapping each lane under contiguous packing.

    Contiguous packing deals the submit-order concatenation into p
    even-share lanes; a lane "overlaps" every segment that contributes at
    least one key to it. This is the geometry that value-clusters lanes:
    spread ≈ R/p means each lane sees only a sliver of the batch's value
    range.
    """
    sizes = [int(s) for s in sizes if int(s) > 0]
    total = sum(sizes)
    if not sizes or p <= 0 or total == 0:
        return 0, 0.0
    bounds = np.cumsum([0] + sizes)  # segment extents in submit order
    spreads = []
    off = 0
    # the same lane deal pack_segments uses — shared so the fingerprint
    # can never drift from the actual contiguous packing geometry
    for c in contiguous_lane_sizes(total, p):
        if c == 0:
            spreads.append(0)
            continue
        lo = np.searchsorted(bounds, off, side="right") - 1
        hi = np.searchsorted(bounds, off + c - 1, side="right") - 1
        spreads.append(int(hi - lo + 1))
        off += c
    return int(max(spreads)), float(np.mean(spreads))


def fingerprint_arrays(
    arrays: Sequence[np.ndarray],
    p: int,
    *,
    n_per_proc: Optional[int] = None,
    min_n_per_proc: int = 8,
    sample: int = DUP_SAMPLE,
    seed: int = 0,
) -> Fingerprint:
    """Fingerprint a batch of ragged request arrays without sorting them."""
    sizes = tuple(int(np.asarray(a).shape[0]) for a in arrays)
    total = sum(sizes)
    n_p = n_per_proc or _pow2_n_per_proc(total, p, min_n_per_proc)
    smax, smean = lane_spread(sizes, p)
    picks = [
        _sampled(np.asarray(a).reshape(-1), sample, seed + i)
        for i, a in enumerate(arrays)
    ]
    dups = tuple(
        float(np.unique(s, return_counts=True)[1].max() / s.size)
        if s.size
        else 0.0
        for s in picks
    )
    int_key = all(
        np.issubdtype(np.asarray(a).dtype, np.integer) for a in arrays
    )
    return Fingerprint(
        n_keys=total,
        p=p,
        n_per_proc=n_p,
        sizes=sizes,
        lane_spread_max=smax,
        lane_spread_mean=smean,
        dup_fractions=dups,
        int_key=int_key,
        key_range_bits=sampled_range_bits(picks) if int_key else 31,
        radix_share=radix_share(picks, sizes, p) if int_key else 1.0,
        sorted_frac=(
            sampled_sortedness(np.asarray(arrays[0]).reshape(-1), seed=seed)
            if int_key and len(arrays) == 1
            else 0.0
        ),
    )


def _pow2_bucket(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length() if x > 0 else 0


def dup_level(frac: float) -> int:
    """Coarse duplicate regime: 0 = distinct-ish, 1 = mixed, 2 = heavy."""
    return 0 if frac < 0.05 else (1 if frac < 0.35 else 2)


def bucket_key(fp: Fingerprint) -> str:
    """The traffic-learning bucket this fingerprint falls into.

    Shape is exact (each (p, n_per_proc) is its own executor entry
    anyway); segment count rounds to a power of two; duplicates quantize to
    three levels. O(log n · log R · 3) distinct buckets across any traffic.
    """
    return (
        f"p{fp.p}/npp{fp.n_per_proc}"
        f"/segs{_pow2_bucket(fp.n_segments)}/dup{dup_level(fp.dup_fraction)}"
    )
