"""Fold machinery — rank-merging a Δ batch into a standing sorted run.

The paper's §5.1.1 tag trick makes every comparison a total order by
lifting keys to composites whose low bits carry a position tag. The same
lift turns *incremental* sorting into a closed-form fold: for a stream
that is already sorted except for Δ out-of-place keys,

    comp = (key + 2^31) << 31 | original_position        (int64)

is strictly increasing over the in-place subsequence, distinct everywhere,
and ordered exactly like the stable sort of the raw stream — so merging
the kept run with the Δ run on composites reproduces the full stable
argsort by construction (the low bits of the merged sequence ARE the
argsort), and the result equals a cold ``bsp_sort_safe`` of the stream.

* :func:`split_sorted_run`, :func:`lift_positions`,
  :func:`drop_positions` — host code (numpy), the JAX package's, copied:
  an O(n) two-pass scan extracts the out-of-place Δ (drop the elements
  that break order with a neighbour, then keep the record highs of the
  rest); its quality moves cost, never correctness.
* :func:`merge_sorted_runs` — the rank-merge tail
  (:func:`repro_torch.core.merge._rank_merge_two`, one row): ranks of one
  run in the other, every payload riding the same gather. Under
  ``backend="pallas"`` the ranks come from the rank kernel (K2), int64
  composites from its int64 route. Runs are padded to power-of-two widths
  and the output is cut at eighth-of-run steps, as in the JAX package
  (where it bounds the compile cache), so the kernel sees the same row
  shapes; the result is trimmed to the valid keys.
* :func:`near_sorted_sort_launch` — the planner-routed path: split the
  stream, sort ONLY the Δ composites through the fused h-relation at a
  ``(p, Δ/p)`` layout and the exact pair capacity (no retry is possible),
  then one rank merge against the kept run.

Results are tensors on the run's device (the merge runs there); the JAX
package enters its 64-bit scope around the int64 work, which torch needs
not.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core.api import InFlightSort, SortExecutor, TierStats, bsp_sort_safe_launch, gathered_output
from ..core.merge import _rank_merge_two
from ..core.segmented import SegmentedResult, _pow2_n_per_proc, contiguous_lane_sizes
from ..core.types import SortConfig, resolve_device, round_up, sentinel_for

#: low bits of the fold composite holding the original position; the
#: (biased) int32 key sits above. 31 + 32 bits keeps the composite inside
#: positive int64 with the int64-max sentinel strictly past every real
#: composite (positions are bounded by the int32 index space anyway).
POS_BITS = 31
POS_MASK = (np.int64(1) << POS_BITS) - 1
_KEY_BIAS = np.int64(1) << 31


def lift_positions(keys: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """(int32 key, position) -> order-preserving int64 fold composites.

    Strictly increasing in lexicographic (key, pos) — ordered exactly like
    the stable sort of ``keys`` — and all distinct, so a merge of two lifted
    runs needs no tie-break rule at all.
    """
    k = np.asarray(keys, np.int64)
    p = np.asarray(pos, np.int64)
    assert p.size == 0 or int(p.max()) < (1 << POS_BITS) - 1
    return ((k + _KEY_BIAS) << POS_BITS) | p


def drop_positions(comp):
    """Invert :func:`lift_positions`: composites -> (int32 keys, int32
    positions). A tensor stays on its device; anything else is numpy."""
    if isinstance(comp, torch.Tensor):
        keys = ((comp >> POS_BITS) - int(_KEY_BIAS)).to(torch.int32)
        return keys, (comp & int(POS_MASK)).to(torch.int32)
    comp = np.asarray(comp, np.int64)
    keys = ((comp >> POS_BITS) - _KEY_BIAS).astype(np.int32)
    return keys, (comp & POS_MASK).astype(np.int32)


def split_sorted_run(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Index split of a stream into (kept sorted run, out-of-place Δ).

    Pass 1 drops every element that violates order with a neighbour —
    scattered in-place updates (a huge value planted early) are removed
    here, before they can become the running max and condemn everything
    after them. Pass 2 keeps the record highs of the remainder, which
    handles the patterns pass 1 is blind to (a rotated leading block is
    locally sorted but globally displaced). ``keys[kept]`` is always
    non-decreasing.
    """
    k = np.asarray(keys).reshape(-1)
    n = k.shape[0]
    if n == 0:
        e = np.zeros(0, np.int64)
        return e, e.copy()
    prev_ok = np.empty(n, bool)
    prev_ok[0] = True
    np.greater_equal(k[1:], k[:-1], out=prev_ok[1:])
    next_ok = np.empty(n, bool)
    next_ok[-1] = True
    np.less_equal(k[:-1], k[1:], out=next_ok[:-1])
    idx = np.flatnonzero(prev_ok & next_ok)
    sub = k[idx]
    if sub.size:
        kept_idx = idx[sub >= np.maximum.accumulate(sub)]  # record highs
    else:
        kept_idx = idx
    mask = np.zeros(n, bool)
    mask[kept_idx] = True
    return kept_idx.astype(np.int64), np.flatnonzero(~mask).astype(np.int64)


def _pow2_width(n: int, floor: int = 8) -> int:
    return max(floor, 1 << max(0, int(n) - 1).bit_length())


def _on(a, device: torch.device) -> torch.Tensor:
    """``a`` (numpy or tensor) as a flat-leading tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def merge_sorted_runs(
    a_keys,
    b_keys,
    a_vals: Sequence = (),
    b_vals: Sequence = (),
    *,
    backend: str = "xla",
    device=None,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Stable merge of two sorted runs (a first on ties) + payloads.

    One rank computation on the keys; every payload rides the same gather
    (``core/merge`` semantics). Inputs are numpy arrays or tensors; the
    merge runs on ``a_keys``'s device if it is a tensor, else on
    ``device``, and returns tensors there, trimmed to the ``na + nb`` keys.
    """
    dev = a_keys.device if isinstance(a_keys, torch.Tensor) else resolve_device(device)
    a = _on(a_keys, dev).reshape(-1)
    b = _on(b_keys, dev).reshape(-1)
    assert a.dtype == b.dtype and len(a_vals) == len(b_vals)
    na, nb = int(a.numel()), int(b.numel())
    if nb == 0:
        return a.clone(), [_on(v, dev).clone() for v in a_vals]
    if na == 0:
        return b.clone(), [_on(v, dev).clone() for v in b_vals]
    wa, wb = _pow2_width(na), _pow2_width(nb)
    step = max(64, wa // 8)
    w_out = min(wa + wb, round_up(na + nb, step))
    sent = sentinel_for(a.dtype)
    ka = torch.full((1, wa), sent, dtype=a.dtype, device=dev)
    ka[0, :na] = a
    kb = torch.full((1, wb), sent, dtype=b.dtype, device=dev)
    kb[0, :nb] = b
    va, vb = [], []
    for av, bv in zip(a_vals, b_vals):
        av, bv = _on(av, dev), _on(bv, dev)
        pa = torch.zeros((1, wa) + av.shape[1:], dtype=av.dtype, device=dev)
        pa[0, :na] = av
        pb = torch.zeros((1, wb) + bv.shape[1:], dtype=bv.dtype, device=dev)
        pb[0, :nb] = bv
        va.append(pa)
        vb.append(pb)
    ca = torch.tensor([na], dtype=torch.int32, device=dev)
    cb = torch.tensor([nb], dtype=torch.int32, device=dev)
    out, vout, _ = _rank_merge_two(ka, ca, kb, cb, sent, va, vb, backend=backend, w_out=w_out)
    return out[0, : na + nb], [v[0, : na + nb] for v in vout]


def sort_delta_comps_launch(
    comp: np.ndarray,
    p: int,
    *,
    min_n_per_proc: int = 8,
    executor: Optional[SortExecutor] = None,
    stats: Optional[TierStats] = None,
    obs_handle=None,
    device=None,
) -> Tuple[Optional[InFlightSort], int]:
    """Launch the Δ composites through the fused h-relation (non-blocking).

    The Δ batch gets its own ``(p, n_p)`` layout sized to Δ and runs at the
    exact pair capacity, so the fold can never retry. Pads are the int64
    sentinel; the composites are distinct and strictly below it, so the
    valid Δ prefix of the gathered output is exact. Returns
    ``(flight | None, n_per_proc)``.
    """
    dn = int(comp.size)
    if dn == 0:
        return None, min_n_per_proc
    n_p = _pow2_n_per_proc(dn, p, min_n_per_proc)
    rows = np.full((p, n_p), np.iinfo(np.int64).max, np.int64)
    off = 0
    for k, c in enumerate(contiguous_lane_sizes(dn, p)):
        rows[k, :c] = comp[off : off + c]
        off += c
    cfg = SortConfig(p=p, n_per_proc=n_p, algorithm="iran", pair_capacity="exact", obs=obs_handle)
    dev = resolve_device(device)
    flight = bsp_sort_safe_launch(torch.from_numpy(rows).to(dev), cfg, stats=stats, executor=executor, device=dev)
    return flight, n_p


@dataclasses.dataclass
class InFlightDeltaSort:
    """A launched near-sorted request awaiting its Δ sort and fold.

    The host split is done and the Δ composites' sort is in the device
    queue; :meth:`wait` waits for it, rank-merges the Δ run into the kept
    run and unlifts the composites to (keys, stable argsort). It waits and
    returns as ``InFlightSegmentedSort`` does.
    """

    comp_kept: torch.Tensor  # lifted kept run, strictly increasing, on the device
    n_delta: int
    flight: Optional[InFlightSort]  # None when the stream was sorted
    stats: TierStats
    n_per_proc: int  # the Δ sort's power-of-two bucket
    tracer: Optional[object] = None
    t_launched: float = 0.0
    backend: str = "xla"

    def done(self) -> bool:
        return self.flight is None or self.flight.done()

    def wait(self) -> SegmentedResult:
        if self.flight is not None:
            res, _, _ = self.flight.wait()
            d = gathered_output(res)[: self.n_delta]
        else:
            d = torch.zeros(0, dtype=torch.int64, device=self.comp_kept.device)
        merged, _ = merge_sorted_runs(self.comp_kept, d, backend=self.backend)
        keys, order = drop_positions(merged)
        if self.tracer is not None:
            n = keys.numel()
            self.tracer.add_span(
                "fold",
                self.t_launched,
                cat="delta",
                tid="main",
                delta_n=self.n_delta,
                view_n=n - self.n_delta,
                share=round(self.n_delta / max(n, 1), 4),
                route="delta",
            )
        return SegmentedResult(keys=[keys], order=[order], stats=self.stats, tier="delta",
                               n_per_proc=self.n_per_proc)


def near_sorted_sort_launch(
    keys,
    p: int,
    *,
    min_n_per_proc: int = 8,
    executor: Optional[SortExecutor] = None,
    stats: Optional[TierStats] = None,
    obs_handle=None,
    backend: str = "xla",
    device=None,
) -> InFlightDeltaSort:
    """Launch the delta route for one near-sorted request (non-blocking).

    Split → lift → Δ-sized fused sort of the out-of-place composites →
    (at :meth:`InFlightDeltaSort.wait`) one rank merge. The result equals
    the cold ladder's byte for byte — keys and stable argsort — whatever
    the split extracted.
    """
    if isinstance(keys, torch.Tensor):
        keys = keys.cpu().numpy()
    arr = np.asarray(keys, np.int32).reshape(-1)
    dev = resolve_device(device)
    stats = stats if stats is not None else TierStats()
    kept_idx, delta_idx = split_sorted_run(arr)
    comp_kept = torch.from_numpy(lift_positions(arr[kept_idx], kept_idx)).to(dev)
    comp_delta = lift_positions(arr[delta_idx], delta_idx)
    tracer = obs.resolve_tracer(obs_handle)
    flight, n_p = sort_delta_comps_launch(
        comp_delta, p, min_n_per_proc=min_n_per_proc, executor=executor, stats=stats,
        obs_handle=obs_handle, device=dev,
    )
    return InFlightDeltaSort(
        comp_kept=comp_kept,
        n_delta=int(delta_idx.size),
        flight=flight,
        stats=stats,
        n_per_proc=n_p,
        tracer=tracer,
        t_launched=tracer.now() if tracer is not None else 0.0,
        backend=backend,
    )


def near_sorted_sort(keys, p: int, **kw) -> SegmentedResult:
    """Blocking wrapper over :func:`near_sorted_sort_launch`."""
    return near_sorted_sort_launch(keys, p, **kw).wait()
