"""SortedView — a standing sorted (key, payload) snapshot that folds Δs.

The view holds a sorted run of int32 keys plus any number of aligned 1-D
payloads, as tensors on its device, maintained incrementally. Two
mutation routes, both byte-identical to a cold ``bsp_sort_safe`` of the
concatenated history (every tier is stable and equal keys keep first-seen
order, so [sorted view ++ stably sorted Δ] merged view-first on ties IS
the stable sort of the concatenation):

* ``fold`` — the Δ batch is stably sorted through the fused h-relation at
  a Δ-sized ``(p, Δ/p)`` layout (exact pair capacity: it can never retry),
  then rank-merged into the view (:func:`fold.merge_sorted_runs`, the rank
  kernel under ``merge_backend="pallas"``), payloads riding the same
  permutation. Cost O(Δ log Δ) + O(n) against the cold ladder's
  O(n log n).
* ``resort`` — concatenate and run the segmented ladder; taken when Δ is a
  large share of the result (``fold_max_share``).

Deletions and updates ride as tombstones with the §5.1.1 tag trick:
duplicate tombstone values get distinct (value, occurrence) tags —
``occ = arange - searchsorted(t, t, 'left')`` — so the k-th tombstone of
value v hits the k-th live v of the view, found with two binary searches
and applied as one masked compaction (delete) or one scatter (update).
Tombstones for absent keys count as misses.

Every fold's merged run is checked for order; a Δ run out of order makes
the view fall back to a resort from the untouched pre-fold state
(``delta.fold_fallback_resorts``). ``chaos_handle`` (a
:class:`repro_torch.chaos.FaultPlan`) injects such a fault: a fold whose
sequence number the plan picks has its sorted Δ keys reversed before the
merge, as in the JAX package.

Counters per view label in the registry: ``delta.folds``,
``delta.resorts``, ``delta.tombstones``, ``delta.tombstone_misses``;
``fold`` and ``tombstone`` spans (cat="delta") when a tracer is attached.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..core import primitives as prim
from ..core.api import SortExecutor, TierStats
from ..core.segmented import pack_segments, segmented_sort_safe
from ..core.types import resolve_device
from .fold import merge_sorted_runs

__all__ = ["SortedView"]


def _out_of_order(keys: torch.Tensor) -> bool:
    return keys.numel() > 1 and bool((keys[1:] < keys[:-1]).any())


class SortedView:
    """A sorted (key, payload) snapshot maintained by Δ folds.

    ``p``/``min_n_per_proc`` fix the layout every device pass (Δ sort or
    resort) uses; ``executor``/``stats`` may be shared with other sorts so
    stage callables and retry counters pool. ``device`` is where the view
    lives and sorts (default: the card).
    """

    def __init__(
        self,
        *,
        p: int = 8,
        min_n_per_proc: int = 8,
        executor: Optional[SortExecutor] = None,
        stats: Optional[TierStats] = None,
        obs_handle=None,
        chaos_handle=None,
        label: Optional[str] = None,
        fold_max_share: float = 0.25,
        merge_backend: str = "xla",
        device=None,
    ) -> None:
        self.p = p
        self.min_n_per_proc = min_n_per_proc
        self.executor = executor
        self.stats = stats if stats is not None else TierStats()
        self.fold_max_share = fold_max_share
        self.merge_backend = merge_backend
        self.device = resolve_device(device)
        self.label = label if label is not None else obs.next_instance("view")
        self.keys = torch.zeros(0, dtype=torch.int32, device=self.device)
        self.payloads: List[torch.Tensor] = []
        self._n_payloads: Optional[int] = None
        self.last_tier: Optional[str] = None
        self.last_n_per_proc = min_n_per_proc
        self._obs_handle = obs_handle
        self._tracer = obs.resolve_tracer(obs_handle)
        # fold-corruption injection: the view only calls next_fold and
        # corrupt_fold, duck-typed like the tracer
        self._chaos_handle = chaos_handle
        reg = obs.metrics()
        self._folds = reg.counter("delta.folds", view=self.label)
        self._resorts = reg.counter("delta.resorts", view=self.label)
        self._fold_fallbacks = reg.counter("delta.fold_fallback_resorts", view=self.label)
        self._tombstones = reg.counter("delta.tombstones", view=self.label)
        self._tombstone_misses = reg.counter("delta.tombstone_misses", view=self.label)

    # ------------------------------------------------------------ basics
    @property
    def n(self) -> int:
        return int(self.keys.numel())

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            t = a.to(self.device)
        else:
            t = torch.from_numpy(np.array(a, copy=True)).to(self.device)
        return t if dtype is None else t.to(dtype)

    def _coerce(self, delta_keys, delta_payloads):
        arr = self._tensor(delta_keys, torch.int32).reshape(-1)
        pls = [self._tensor(v) for v in delta_payloads]
        if self._n_payloads is None:
            self._n_payloads = len(pls)
            if not self.payloads:
                self.payloads = [torch.zeros(0, dtype=v.dtype, device=self.device) for v in pls]
        elif len(pls) != self._n_payloads:
            raise ValueError(f"view carries {self._n_payloads} payload(s), fold brought {len(pls)}")
        return arr, pls

    def install(self, keys, payloads: Sequence = ()) -> None:
        """Adopt an already-sorted snapshot without a device sort (for
        example the keys and payloads of a sort just run, or a snapshot
        taken of the JAX package's view as numpy)."""
        arr, pls = self._coerce(keys, payloads)
        if _out_of_order(arr):
            raise ValueError("install requires sorted keys")
        self.keys = arr
        self.payloads = pls

    def clone(self) -> "SortedView":
        """Copy of the snapshot sharing executor/stats/label (same family)."""
        c = SortedView(
            p=self.p, min_n_per_proc=self.min_n_per_proc, executor=self.executor, stats=self.stats,
            obs_handle=self._obs_handle, chaos_handle=self._chaos_handle, label=self.label,
            fold_max_share=self.fold_max_share,
            merge_backend=self.merge_backend, device=self.device,
        )
        c.keys = self.keys.clone()
        c.payloads = [v.clone() for v in self.payloads]
        c._n_payloads = self._n_payloads
        c.last_tier = self.last_tier
        c.last_n_per_proc = self.last_n_per_proc
        return c

    # -------------------------------------------------------------- fold
    def _device_sort(self, arr: torch.Tensor):
        """Stably sort a batch through the fused h-relation (exact rung)."""
        packed = pack_segments([arr.cpu().numpy()], self.p, min_n_per_proc=self.min_n_per_proc)
        res = segmented_sort_safe(
            packed, stats=self.stats, executor=self.executor, pair_capacity="exact", obs=self._obs_handle,
            device=self.device,
        )
        return res.keys[0], res.order[0].long(), res

    def _resort(self, arr: torch.Tensor, pls: List[torch.Tensor]) -> None:
        cat_k = torch.cat([self.keys, arr])
        cat_v = [torch.cat([old, new]) for old, new in zip(self.payloads, pls)]
        if cat_k.numel():
            k, order, res = self._device_sort(cat_k)
            self.keys = k
            self.payloads = [prim.gather(cv, 0, order) for cv in cat_v]
            self.last_tier = res.tier
            self.last_n_per_proc = res.n_per_proc
        self._resorts.inc()

    def fold(self, delta_keys, delta_payloads: Sequence = (), *, route: Optional[str] = None) -> str:
        """Merge a Δ batch in; returns the route taken (``fold``/``resort``).

        The state is the same either way — ``route`` (and the
        ``fold_max_share`` decision it overrides) is a cost choice. The
        first fold into an empty view is a resort (there is no standing run
        to rank against yet).
        """
        arr, pls = self._coerce(delta_keys, delta_payloads)
        dn, n = int(arr.numel()), self.n
        if route is None:
            route = "fold" if n and dn <= self.fold_max_share * (n + dn) else "resort"
        if route not in ("fold", "resort"):
            raise ValueError(f"unknown fold route {route!r}")
        t0 = self._tracer.now() if self._tracer is not None else 0.0
        if route == "resort":
            self._resort(arr, pls)
        else:
            fell_back = False
            if dn:
                dk, dorder, res = self._device_sort(arr)
                dvs = [prim.gather(v, 0, dorder) for v in pls]
                ch = self._chaos_handle
                if ch is not None and ch.corrupt_fold(ch.next_fold()):
                    # injected corruption: the sorted Δ run reversed, as a bad
                    # fold input would look; the check below must catch it
                    dk = torch.flip(dk, [0])
                merged, vout = merge_sorted_runs(self.keys, dk, self.payloads, dvs, backend=self.merge_backend)
                if _out_of_order(merged):
                    # the merged run is not sorted: a fold input was out of
                    # order. The pre-fold state is untouched, so resort the
                    # concatenated history instead
                    fell_back = True
                    self._fold_fallbacks.inc()
                    if self._tracer is not None:
                        self._tracer.point("fold_corruption_fallback", cat="chaos", tid="main", delta_n=dn,
                                           view_n=n)
                    self._resort(arr, pls)
                    route = "resort"
                else:
                    self.keys = merged
                    self.payloads = vout
                    self.last_n_per_proc = res.n_per_proc
            if not fell_back:
                self.last_tier = "delta"
                self._folds.inc()
        if self._tracer is not None:
            self._tracer.add_span("fold", t0, cat="delta", tid="main", route=route, delta_n=dn, view_n=n,
                                  share=round(dn / max(n + dn, 1), 4))
        return route

    # -------------------------------------------------------- tombstones
    def _targets(self, t: torch.Tensor):
        """View indices hit by sorted tombstone values (§5.1.1 occurrence tags)."""
        base = torch.searchsorted(self.keys, t, side="left")
        hi = torch.searchsorted(self.keys, t, side="right")
        occ = torch.arange(t.numel(), device=t.device) - torch.searchsorted(t, t, side="left")
        tgt = base + occ
        return tgt, tgt < hi

    def delete(self, keys) -> int:
        """Tombstone-delete: the k-th tombstone of v removes the k-th live v.

        Returns the number of keys removed; tombstones with no remaining
        occurrence count as misses (``delta.tombstone_misses``).
        """
        t = torch.sort(self._tensor(keys, torch.int32).reshape(-1)).values
        if t.numel() == 0:
            return 0
        t0 = self._tracer.now() if self._tracer is not None else 0.0
        tgt, ok = self._targets(t)
        removed = tgt[ok]
        hits = int(removed.numel())
        if hits:
            mask = torch.ones(self.n, dtype=torch.bool, device=self.device)
            mask[removed] = False
            self.keys = self.keys[mask]
            self.payloads = [v[mask] for v in self.payloads]
        self._tombstones.inc(hits)
        self._tombstone_misses.inc(int(t.numel()) - hits)
        if self._tracer is not None:
            self._tracer.add_span("tombstone", t0, cat="delta", tid="main", op="delete", hits=hits,
                                  misses=int(t.numel()) - hits)
        return hits

    def update(self, keys, payloads: Sequence) -> int:
        """Tombstone-update: rewrite payloads in place, positions untouched.

        The same occurrence-tagged targeting as :meth:`delete`; an update
        never moves a key, so stable order is kept. Returns the hit count.
        """
        t_in = self._tensor(keys, torch.int32).reshape(-1)
        pls = [self._tensor(v) for v in payloads]
        if len(pls) != (self._n_payloads or 0):
            raise ValueError(f"view carries {self._n_payloads or 0} payload(s), update brought {len(pls)}")
        if t_in.numel() == 0:
            return 0
        t, perm = torch.sort(t_in, stable=True)
        tgt, ok = self._targets(t)
        hits = int(ok.sum())
        if hits:
            for v, nv in zip(self.payloads, pls):
                v[tgt[ok]] = nv[perm][ok]
        self._tombstones.inc(hits)
        self._tombstone_misses.inc(int(t.numel()) - hits)
        return hits

    def pop_min(self) -> Tuple[int, Tuple]:
        """Remove and return the front (min-key) entry and its payloads."""
        if self.n == 0:
            raise IndexError("pop_min from an empty SortedView")
        k = int(self.keys[0])
        vals = tuple(v[0].item() for v in self.payloads)
        self.keys = self.keys[1:]
        self.payloads = [v[1:] for v in self.payloads]
        self._tombstones.inc()
        return k, vals
