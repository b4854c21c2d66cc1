"""Sorting benchmark input distributions (paper §6.3, after [39,40,41]).

Seven generators producing the (p, n_per_proc) int32 global layout. The
paper's [Z]/[RD] sets are omitted by the paper's own choice (§6.3: results
match [DD]/[WR] and are never worse than [U]).

Service-workload additions beyond the paper's sets (the sort-service
benchmark sorts *many small requests*, a regime §6.3 never exercises):

* ``zipf`` / :func:`zipf_keys` — duplicate-heavy Zipf-distributed keys
  (heavy head: a handful of values covers most of the mass — the §5.1.1
  duplicate-tagging stress in its naturally occurring form);
* :func:`zipf_sizes` — skewed *request-size* mix for a batch of concurrent
  sort requests (sizes ∝ rank^-alpha: a few big requests, a long tail of
  tiny ones — the fusion win case);
* ``dense_int`` / :func:`dense_int` — small-domain integer keys
  (expert-id-like), the count-then-distribute ``route="radix"`` flagship.

INT_MAX = 2^31 (values in [0, 2^31 - 1], 32-bit signed — paper's setting).
"""
from __future__ import annotations

import numpy as np

INT_MAX = 2**31


def _rngs(p: int, seed: int):
    # paper: processor i's seed is 21 + 1001*i
    return [np.random.default_rng(seed + 21 + 1001 * i) for i in range(p)]


def uniform(p: int, n_p: int, seed: int = 0) -> np.ndarray:
    """[U] — uniform in [0, INT_MAX)."""
    return np.stack([r.integers(0, INT_MAX, n_p, dtype=np.int64) for r in _rngs(p, seed)]).astype(np.int32)


def gaussian(p: int, n_p: int, seed: int = 0) -> np.ndarray:
    """[G] — mean of four uniform draws."""
    out = []
    for r in _rngs(p, seed):
        out.append(sum(r.integers(0, INT_MAX, n_p, dtype=np.int64) for _ in range(4)) // 4)
    return np.stack(out).astype(np.int32)


def bucket_sorted(p: int, n_p: int, seed: int = 0) -> np.ndarray:
    """[B] — per proc, p equal buckets; bucket i uniform in its 1/p range."""
    w = INT_MAX // p
    out = []
    for r in _rngs(p, seed):
        per = n_p // p
        parts = [
            r.integers(i * w, (i + 1) * w, per, dtype=np.int64) for i in range(p)
        ]
        rest = n_p - per * p
        if rest:
            parts.append(r.integers(0, INT_MAX, rest, dtype=np.int64))
        out.append(np.concatenate(parts))
    return np.stack(out).astype(np.int32)


def g_group(p: int, n_p: int, seed: int = 0, g: int = 2) -> np.ndarray:
    """[g-G] — procs in groups of g; bucket ranges rotated by jg + p/2 + i."""
    w = INT_MAX // p
    out = []
    rngs = _rngs(p, seed)
    for k in range(p):
        j = k // g
        per = n_p // g
        parts = []
        for i in range(g):
            lo = ((j * g + p // 2 + i) % p) * w
            parts.append(rngs[k].integers(lo, lo + w, per, dtype=np.int64))
        rest = n_p - per * g
        if rest:
            parts.append(rngs[k].integers(0, INT_MAX, rest, dtype=np.int64))
        out.append(np.concatenate(parts))
    return np.stack(out).astype(np.int32)


def staggered(p: int, n_p: int, seed: int = 0) -> np.ndarray:
    """[S] — proc i<p/2 in range (2i+1)/p; proc i>=p/2 in range (i-p/2)/p."""
    w = INT_MAX // p
    out = []
    rngs = _rngs(p, seed)
    for i in range(p):
        lo = ((2 * i + 1) * w) if i < p // 2 else ((i - p // 2) * w)
        out.append(rngs[i].integers(lo, lo + w, n_p, dtype=np.int64))
    return np.stack(out).astype(np.int32)


def deterministic_duplicates(p: int, n_p: int, seed: int = 0) -> np.ndarray:
    """[DD] — duplicates-heavy set after [39,40]: the first p/2 procs hold
    lg n everywhere, the next p/4 procs lg(n/2), …; the last proc's run is
    itself halved into runs of lg(n/p), lg(n/(2p)), …"""
    n = p * n_p
    lg = int(np.log2(max(n, 2)))
    x = np.zeros((p, n_p), np.int32)
    start, size, v = 0, max(p // 2, 1), lg
    while start < p - 1 and size >= 1:
        x[start : min(start + size, p - 1)] = v
        start += size
        size = max(size // 2, 1)
        v = max(v - 1, 0)
        if size == 1 and start >= p - 1:
            break
    # last processor: halving runs
    off, run, v = 0, max(n_p // 2, 1), int(np.log2(max(n // p, 2)))
    while off < n_p:
        x[p - 1, off : off + run] = v
        off += run
        run = max(run // 2, 1)
        v = max(v - 1, 0)
    return x


def worst_regular(p: int, n_p: int, seed: int = 0) -> np.ndarray:
    """[WR] — worst case for plain regular sampling [39]: the sorted sequence
    dealt cyclically, so every proc's evenly spaced sample is (nearly)
    identical and un-oversampled splitters maximally misbalance buckets."""
    n = p * n_p
    scale = max(INT_MAX // max(n, 1), 1)
    j = np.arange(n_p, dtype=np.int64)[None, :]
    i = np.arange(p, dtype=np.int64)[:, None]
    return ((j * p + i) * scale).astype(np.int32)


def zipf_keys(p: int, n_p: int, seed: int = 0, alpha: float = 1.5) -> np.ndarray:
    """[zipf] — duplicate-heavy keys, frequency of value v ∝ v^-alpha.

    The head values repeat across every processor (unlike [DD]'s per-proc
    blocks), so both the splitter tagging and the routing see naturally
    colliding duplicates.
    """
    return np.stack(
        [np.minimum(r.zipf(alpha, n_p), INT_MAX - 1) for r in _rngs(p, seed)]
    ).astype(np.int32)


def dense_int(p: int, n_p: int, seed: int = 0, domain: int = 64) -> np.ndarray:
    """[dense_int] — small-domain integer keys, uniform in [0, domain).

    The expert-id-like workload of MoE dispatch and segment tags: every key
    is drawn from a tiny dense domain, so *all* high bits agree and
    duplicates dominate (each value repeats ~n/domain times). Sampling-based
    splitter selection pays its full Ph3 cost to learn a range a single
    counting pass reads off directly — the flagship case for
    ``route="radix"``.
    """
    return np.stack(
        [r.integers(0, domain, n_p, dtype=np.int64) for r in _rngs(p, seed)]
    ).astype(np.int32)


NEAR_SORTED_PATTERNS = ("appended", "scattered", "rotated")


def near_sorted(
    n: int, delta_frac: float, pattern: str = "appended", seed: int = 0
) -> np.ndarray:
    """1-D near-sorted stream: sorted uniform base with Δ = ``delta_frac``·n
    keys out of place. The delta subsystem's workload generator (bench table
    ``delta`` + tests) — three disruption families:

    * ``appended`` — a sorted run of n−Δ keys with Δ fresh uniform draws
      appended unsorted (the arrival-stream / leaderboard-refill shape);
    * ``scattered`` — a fully sorted run with Δ positions overwritten by
      fresh uniform draws in place (the update-heavy shape — planted values
      may be arbitrarily far from their sorted position);
    * ``rotated`` — the leading Δ-block moved to the tail (a block rotation:
      locally sorted everywhere but globally displaced).

    ``delta_frac=0`` returns a fully sorted stream for every pattern.
    """
    n = int(n)
    d = min(n, int(round(n * float(delta_frac))))
    rng = np.random.default_rng(seed + 21)
    if pattern == "appended":
        base = np.sort(rng.integers(0, INT_MAX, n - d, dtype=np.int64))
        tail = rng.integers(0, INT_MAX, d, dtype=np.int64)
        out = np.concatenate([base, tail])
    elif pattern == "scattered":
        out = np.sort(rng.integers(0, INT_MAX, n, dtype=np.int64))
        if d:
            idx = rng.choice(n, size=d, replace=False)
            out[idx] = rng.integers(0, INT_MAX, d, dtype=np.int64)
    elif pattern == "rotated":
        base = np.sort(rng.integers(0, INT_MAX, n, dtype=np.int64))
        out = np.concatenate([base[d:], base[:d]])
    else:
        raise ValueError(
            f"unknown near-sorted pattern {pattern!r} "
            f"(use one of {NEAR_SORTED_PATTERNS})"
        )
    return out.astype(np.int32)


def zipf_sizes(
    n_requests: int, total: int, seed: int = 0, alpha: float = 1.2
) -> np.ndarray:
    """Skewed request-size mix: size of rank-r request ∝ r^-alpha, shuffled.

    Deterministic in ``seed``; sizes are ≥ 1 and sum exactly to ``total``
    (the residual lands on the largest request). Models the serving-side
    regime of a few big sorts amid a long tail of tiny ones.
    """
    assert total >= n_requests >= 1
    w = 1.0 / np.arange(1, n_requests + 1, dtype=np.float64) ** alpha
    sizes = np.maximum((w / w.sum() * total).astype(np.int64), 1)
    # clamping the tail to >= 1 can overshoot ``total`` (when total is close
    # to n_requests most floor-shares are 0): shave the excess off the
    # largest entries, never below 1 — total >= n_requests guarantees the
    # shave terminates. Any rounding shortfall lands on the largest request.
    excess = int(sizes.sum()) - total
    order = np.argsort(-sizes)
    i = 0
    while excess > 0:
        j = order[i % n_requests]
        take = min(excess, int(sizes[j]) - 1)
        sizes[j] -= take
        excess -= take
        i += 1
    if excess < 0:
        sizes[order[0]] -= excess
    assert sizes.min() >= 1 and sizes.sum() == total
    rng = np.random.default_rng(seed + 21)
    rng.shuffle(sizes)
    return sizes


DISTRIBUTIONS = {
    "U": uniform,
    "G": gaussian,
    "B": bucket_sorted,
    "2-G": g_group,
    "S": staggered,
    "DD": deterministic_duplicates,
    "WR": worst_regular,
    "zipf": zipf_keys,
    "dense_int": dense_int,
}


def generate(name: str, p: int, n_p: int, seed: int = 0) -> np.ndarray:
    return DISTRIBUTIONS[name](p, n_p, seed)
