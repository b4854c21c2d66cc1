"""Batch former: pack ragged sort requests into pow2-bucketed batch shapes.

Host code, the JAX package's ``repro.service.batch`` copied. Every distinct
``(p, n_per_proc)`` packed shape is a distinct set of executor entries for
the segmented sort's whole capacity-tier ladder (a compile per shape in
the JAX package), and serving traffic has unbounded length variety — so
the former quantizes each batch to the next power-of-two per-proc run
length (``n_per_proc ∈ {min, 2·min, 4·min, …}``). Arbitrary request mixes
then share O(log n) entries, and two batches whose totals round to the
same bucket reuse ONE set via the :class:`repro_torch.core.SortExecutor`
registry (build counts asserted in tests/test_torch_service.py).

Batches are formed greedily in submit order (FIFO fairness — a request is
never reordered past another by the former; the *sort* handles ordering) and
closed when adding the next request would exceed ``max_batch_keys``. A
single request larger than the cap still gets its own (larger-bucket) batch:
the service must sort anything it admitted.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.segmented import _pow2_n_per_proc


@dataclasses.dataclass
class Batch:
    """One dispatch unit: requests packed together into a single fused sort."""

    rids: List[int]  # request ids, submit order
    arrays: List[np.ndarray]  # the requests' key arrays, aligned with rids
    n_per_proc: int  # pow2 bucket the batch packs under
    total_keys: int


class BatchFormer:
    def __init__(
        self, p: int, max_batch_keys: int = 1 << 16, min_n_per_proc: int = 8
    ) -> None:
        self.p = p
        self.max_batch_keys = max_batch_keys
        self.min_n_per_proc = min_n_per_proc

    def bucket(self, total_keys: int) -> int:
        """The pow2 n_per_proc bucket a batch of ``total_keys`` packs into."""
        return _pow2_n_per_proc(total_keys, self.p, self.min_n_per_proc)

    def form(self, requests: Sequence[Tuple[int, np.ndarray]]) -> List[Batch]:
        """Greedy FIFO batching of ``(rid, keys)`` pairs under the key cap."""
        batches: List[Batch] = []
        rids: List[int] = []
        arrays: List[np.ndarray] = []
        total = 0

        def close() -> None:
            nonlocal rids, arrays, total
            if rids:
                batches.append(
                    Batch(
                        rids=rids,
                        arrays=arrays,
                        n_per_proc=self.bucket(total),
                        total_keys=total,
                    )
                )
            rids, arrays, total = [], [], 0

        for rid, keys in requests:
            n = int(np.asarray(keys).shape[0])
            if total and total + n > self.max_batch_keys:
                close()
            rids.append(rid)
            arrays.append(keys)
            total += n
        close()
        return batches

    def form_ready(
        self,
        requests: Sequence[Tuple[int, np.ndarray]],
        *,
        min_keys: Optional[int] = None,
    ) -> Tuple[List[Batch], List[Tuple[int, np.ndarray]]]:
        """Admission-aware forming for open-loop traffic: dispatch batches
        that are full enough, hold the partial tail for more arrivals.

        ``form`` packs everything it is given — fine at a flush barrier,
        but an arrival loop that pumps on every poll would dispatch a
        stream of tiny underfilled batches and waste the fused sort's
        fan-in. ``form_ready`` returns ``(batches, held)``: every batch
        except an underfilled *tail* (total below ``min_keys``, default
        half the key cap) dispatches; the tail's ``(rid, keys)`` pairs are
        handed back, still in submit order, to rejoin the queue. Only the
        tail can be held — earlier batches were closed by the cap, and
        holding a middle batch would reorder admissions past FIFO. A
        deadline trigger (or plain ``form``) flushes the held tail
        eventually, so no request is starved.
        """
        if min_keys is None:
            min_keys = self.max_batch_keys // 2
        batches = self.form(requests)
        held: List[Tuple[int, np.ndarray]] = []
        if batches and batches[-1].total_keys < min_keys:
            tail = batches.pop()
            held = list(zip(tail.rids, tail.arrays))
        return batches, held
