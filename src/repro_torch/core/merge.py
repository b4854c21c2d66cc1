"""Ph6 — stable multi-way merging of the routed buckets (Fig. 1 step 12).

* ``sort`` — one stable re-sort of every processor's capacity buffer; the
  buffer is ordered by (source proc, local idx), so a stable key sort is
  the paper's stable merge.
* ``tree`` — lg p rounds of pairwise rank merges, every processor's pairs
  batched as rows: each a-element lands at ``own_idx + rank_in_other``
  (left run first on ties), and the inverse permutation is itself a rank
  search, so every round is ranks plus gathers. Payloads ride the same
  gather.

``merge_backend="pallas"`` (the JAX package's name) takes the hand-written
kernels: ranks through K2 (``kernels/searchsorted``) and key-only pairwise
merges through K3 (``kernels/merge_path``). Both are value-identical to the
plain path. Pads (key == sentinel) stay at the tail throughout.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..kernels.merge_path import ops as mp_ops
from ..kernels.searchsorted import ops as ss_ops
from . import primitives as prim
from .primitives import take_rows
from .types import sentinel_for


def merge_by_sort(
    buf: torch.Tensor, values: Sequence[torch.Tensor] = ()
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Stable re-sort of (p, cap) buffers (+ payloads); pads stay at the tail."""
    merged, perm = prim.stable_sort(buf)
    return merged, [take_rows(v, perm) for v in values]


def _rank(
    data: torch.Tensor, queries: torch.Tensor, side: str, backend: str, exact: bool
) -> torch.Tensor:
    """int32 searchsorted ranks of (R, S) queries in the sorted (R, n) runs.

    ``exact`` (float keys) replays ``jnp.searchsorted``'s probes, which
    decide where a NaN lands in a run the network left unsorted.
    """
    if backend == "pallas":
        return ss_ops.rank_in(data, queries, side=side)
    return prim.searchsorted(data, queries, side, exact)


def _mask_rows(valid: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Zero the payload entries of invalid slots (``valid`` is (R, w))."""
    m = valid.reshape(valid.shape + (1,) * (v.ndim - 2))
    return torch.where(m, v, torch.zeros((), dtype=v.dtype, device=v.device))


def _rank_merge_two(
    ka: torch.Tensor,
    ca: torch.Tensor,
    kb: torch.Tensor,
    cb: torch.Tensor,
    sent,
    va: Sequence[torch.Tensor] = (),
    vb: Sequence[torch.Tensor] = (),
    backend: str = "xla",
    w_out: Optional[int] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]:
    """Stable merge of sorted padded row pairs -> ((R, w_out), payloads, count).

    pos_a(i) = i + #{j < cb : b_j < a_i} is strictly increasing over the
    valid prefix (pads park past every output slot), so output slot o holds
    a-element ``A(o)-1`` if ``pos_a[A(o)-1] == o`` (``A(o) = #{pos_a <= o}``)
    and b-element ``o - A(o)`` otherwise. ``w_out`` (default 2w) truncates
    the output to a known bound on the valid total.
    """
    R, wa = ka.shape
    wb = kb.shape[1]
    w2 = wa + wb
    w_out = w2 if w_out is None else min(w_out, w2)
    dev = ka.device
    o = torch.arange(w_out, dtype=torch.int32, device=dev).expand(R, w_out)
    if wa == 0 or wb == 0:
        # one run empty: pass the other through, re-masking pads so a
        # truncated w_out leaves only valid keys followed by the sentinel
        ks, cs, vs = (ka, ca, va) if wb == 0 else (kb, cb, vb)
        valid = o < cs[:, None]
        out = torch.where(valid, ks[:, :w_out], sent)
        vout = [_mask_rows(valid, v[:, :w_out]) for v in vs]
        return out, vout, torch.clamp(cs, max=w_out)
    exact = ka.is_floating_point()
    ra = torch.minimum(_rank(kb, ka, "left", backend, exact), cb[:, None])
    ia = torch.arange(wa, dtype=torch.int32, device=dev)
    # invalid (padded) a-entries park past every output slot, keeping pos_a
    # strictly increasing so the inverse search below stays well-defined
    pos_a = torch.where(ia < ca[:, None], ia + ra, w2 + ia)
    A = _rank(pos_a, o, "right", backend, exact)  # a-elements at output slots <= o
    prev = torch.clamp(A - 1, min=0)
    from_a = (A > 0) & (pos_a.gather(1, prev.long()) == o)
    take = torch.where(from_a, prev, torch.clamp(wa + o - A, max=w2 - 1)).long()
    valid = o < (ca + cb)[:, None]
    out = torch.where(valid, prim.gather(torch.cat([ka, kb], dim=1), 1, take), sent)
    vout = [
        _mask_rows(valid, take_rows(torch.cat([a_v, b_v], dim=1), take))
        for a_v, b_v in zip(va, vb)
    ]
    return out, vout, torch.clamp(ca + cb, max=w_out)


def merge_tree(
    runs: torch.Tensor,
    counts: torch.Tensor,
    values: Sequence[torch.Tensor] = (),
    backend: str = "xla",
    cap: Optional[int] = None,
    has_nan: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor]:
    """Merge every processor's (m, w) sorted padded runs into one run.

    runs (p, m, w) with m a power of two, counts (p, m), payloads
    (p, m, w, ...). Returns ((p, min(m·w, cap)) runs, payloads, (p,) counts).
    ``cap`` bounds the valid total, so every round is clipped to it and only
    pad slots are dropped. ``backend="pallas"``: key-only pairs take the
    merge-path kernel, key-value pairs the rank kernel. ``has_nan`` (float
    keys, key-only): a one-element device flag, True if the keys may hold a
    NaN, handed to every round's merge kernel (no round adds a NaN); None
    lets each round reduce its own.
    """
    sent = sentinel_for(runs.dtype)
    p, m, _ = runs.shape
    assert m & (m - 1) == 0, "run count must be a power of two"
    vals = list(values)
    while m > 1:
        w = runs.shape[2]
        half = p * (m // 2)
        a = runs[:, 0::2].reshape(half, w)
        b = runs[:, 1::2].reshape(half, w)
        ca = counts[:, 0::2].reshape(half)
        cb = counts[:, 1::2].reshape(half)
        w_out = 2 * w if cap is None else min(cap, 2 * w)
        if backend == "pallas" and not vals:
            merged = mp_ops.merge_partitioned(a.contiguous(), b.contiguous(), w_out, has_nan)
            merged_counts = torch.clamp(ca + cb, max=w_out)
        else:
            va = [v[:, 0::2].reshape((half, w) + v.shape[3:]) for v in vals]
            vb = [v[:, 1::2].reshape((half, w) + v.shape[3:]) for v in vals]
            merged, vals, merged_counts = _rank_merge_two(
                a, ca, b, cb, sent, va, vb, backend=backend, w_out=w_out
            )
            vals = [v.reshape((p, m // 2) + v.shape[1:]) for v in vals]
        m //= 2
        runs = merged.reshape(p, m, -1)
        counts = merged_counts.reshape(p, m)
    return runs[:, 0], [v[:, 0] for v in vals], counts[:, 0]
