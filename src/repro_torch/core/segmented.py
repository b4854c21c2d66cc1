"""Segmented BSP sort — many independent sorts fused into ONE tagged sort.

A batch of R requests ("segments") becomes one BSP sort by lifting every
key to the int64 composite

    comp = segment_id * 2^32 + (key + 2^31)        (order-preserving)

the pair (segment, key) compared lexicographically: the §5.1.1 duplicate
tag generalised to a segment tag. One balanced sort of the composites
returns every segment contiguous and sorted, and splitters drawn from the
shared oversample land inside each segment in proportion to its size. The
composite sort is :func:`api.bsp_sort_safe_launch` with the
within-segment index ``pos`` as payload, so the result carries each
segment's stable argsort too.

Two lane layouts (:func:`pack_segments`): ``contiguous`` deals the
submit-order concatenation row-major, an even share per lane with its own
tail pads (segment id R, after every real key); ``striped`` splits every
segment into p consecutive chunks, chunk k to lane k (remainders rotated),
so each lane holds ~1/p of every segment, and gives pads distinct
composites ``(R << 32) | (j·p + k)`` (lane k's j-th pad) so the pad tail
routes evenly. A single-segment batch needs no tag: it sorts the raw int32
keys (pads = int32 max, which may equal real keys, so the unpack filters
by ``pos``).

Packing is host code (numpy), the JAX package's own, copied. torch has
int64 throughout, so there is no 64-bit scope to enter; results come back
as tensors on the run's device. ``executor=`` shares the stage registry
(``api.SortExecutor``); a traced config (``obs=``) adds a ``segments``
point with the batch's shape to the sort's timeline lane.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs import resolve_tracer
from .api import InFlightSort, SortExecutor, TierStats, bsp_sort_safe_launch, gathered_output
from .types import SortConfig, resolve_device

#: bits of the composite holding the (biased) key; segment id sits above.
SEG_SHIFT = 32
_KEY_BIAS = np.int64(1) << 31  # maps int32 -> [0, 2^32): order-preserving
_KEY_MASK = (np.int64(1) << SEG_SHIFT) - 1


def pack_keys(seg_ids: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Lift (segment_id, int32 key) pairs to order-preserving int64 composites."""
    seg = np.asarray(seg_ids, np.int64)
    k = np.asarray(keys, np.int64)
    return (seg << SEG_SHIFT) | (k + _KEY_BIAS)


def unpack_keys(comp: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Invert :func:`pack_keys`: composites -> (segment ids, int32 keys)."""
    comp = np.asarray(comp, np.int64)
    seg = (comp >> SEG_SHIFT).astype(np.int32)
    keys = ((comp & _KEY_MASK) - _KEY_BIAS).astype(np.int32)
    return seg, keys


def _pow2_n_per_proc(total: int, p: int, min_n_per_proc: int) -> int:
    """Power-of-two per-processor run length covering ``total`` packed keys
    (one shape per octave of batch size)."""
    per = max(1, -(-total // p))
    return max(min_n_per_proc, 1 << (per - 1).bit_length())


@dataclasses.dataclass
class PackedSegments:
    """A batch of ragged requests packed onto the (p, n_per_proc) layout
    (host arrays; the launch moves them to the device)."""

    comp: np.ndarray  # (p, n_p) keys: int64 composites (R>1) / int32 (R=1)
    pos: np.ndarray  # (p, n_p) int32 within-segment index (pads: -1)
    sizes: Tuple[int, ...]  # true per-segment lengths, submit order
    p: int
    n_per_proc: int
    layout: str = "contiguous"  # lane layout this batch was packed with

    @property
    def n_keys(self) -> int:
        return int(sum(self.sizes))


def contiguous_lane_sizes(total: int, p: int) -> np.ndarray:
    """(p,) real-key counts of the contiguous even-share lane deal."""
    q, rem = divmod(int(total), p)
    out = np.full(p, q, np.int64)
    out[:rem] += 1
    return out


def striped_chunk_sizes(sizes: Sequence[int], p: int) -> np.ndarray:
    """(R, p) per-lane chunk lengths of the striped layout.

    Segment s gives ``floor(m_s/p)`` keys to every lane and a +1 to
    ``m_s mod p`` lanes; the +1 windows are laid head to tail around the
    lanes, so lane totals differ by at most one.
    """
    out = np.zeros((len(sizes), p), np.int64)
    start = 0
    for i, m in enumerate(sizes):
        q, r = divmod(int(m), p)
        out[i, :] = q
        if r:
            out[i, (start + np.arange(r)) % p] += 1
            start += r
    return out


def pack_segments(
    arrays: Sequence[np.ndarray],
    p: int,
    *,
    n_per_proc: Optional[int] = None,
    min_n_per_proc: int = 8,
    layout: str = "contiguous",
) -> PackedSegments:
    """Pack ragged int32 request arrays into one tagged (p, n_p) sort input.

    ``n_per_proc`` defaults to the power-of-two bucket covering the batch.
    Pads carry segment id ``len(arrays)``, above every real composite, so
    they sort to the global tail. ``layout`` is ``contiguous`` or
    ``striped`` (module doc); a single-segment batch is always contiguous
    and keeps its raw int32 keys.
    """
    if layout not in ("contiguous", "striped"):
        raise ValueError(f"unknown layout {layout!r}")
    arrays = [np.asarray(a, np.int32).reshape(-1) for a in arrays]
    sizes = tuple(int(a.shape[0]) for a in arrays)
    total = sum(sizes)
    n_p = n_per_proc or _pow2_n_per_proc(total, p, min_n_per_proc)
    if p * n_p < total:
        raise ValueError(f"batch of {total} keys exceeds p*n_per_proc={p * n_p}")
    keys = np.concatenate(arrays) if arrays else np.zeros((0,), np.int32)
    pos = np.concatenate([np.arange(s, dtype=np.int32) for s in sizes] or [np.zeros((0,), np.int32)])
    if len(arrays) <= 1:  # no tag needed: sort the raw int32 keys
        layout = "contiguous"
        comp = keys
        pad_comp = np.iinfo(np.int32).max
        comp_rows = np.full((p, n_p), pad_comp, np.int32)
    else:
        seg = np.repeat(np.arange(len(arrays), dtype=np.int64), sizes)
        comp = pack_keys(seg, keys)
        pad_comp = np.int64(len(arrays)) << SEG_SHIFT
        comp_rows = np.full((p, n_p), pad_comp, np.int64)
    pos_rows = np.full((p, n_p), -1, np.int32)

    if layout == "striped":
        chunks = striped_chunk_sizes(sizes, p)
        seg_starts = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        # lane k's slice of segment s is [offs[s, k], offs[s, k + 1]) of it
        offs = np.concatenate([np.zeros((len(sizes), 1), np.int64), np.cumsum(chunks, axis=1)], axis=1)
        for k in range(p):
            sel = np.concatenate(
                [np.arange(seg_starts[s] + offs[s, k], seg_starts[s] + offs[s, k + 1]) for s in range(len(sizes))]
                or [np.zeros((0,), np.int64)]
            )
            c = sel.shape[0]
            comp_rows[k, :c] = comp[sel]
            pos_rows[k, :c] = pos[sel]
            # distinct interleaved pads: lane k's j-th pad has value j·p + k
            comp_rows[k, c:] = pad_comp | (np.arange(n_p - c, dtype=np.int64) * p + k)
    else:
        off = 0
        for k, c in enumerate(contiguous_lane_sizes(total, p)):
            comp_rows[k, :c] = comp[off : off + c]
            pos_rows[k, :c] = pos[off : off + c]
            off += c
    return PackedSegments(comp=comp_rows, pos=pos_rows, sizes=sizes, p=p, n_per_proc=n_p, layout=layout)


@dataclasses.dataclass
class SegmentedResult:
    """Per-segment outputs of one fused sort, in submit order."""

    keys: List[torch.Tensor]  # segment r's keys, sorted ascending (int32)
    order: List[torch.Tensor]  # stable argsort: keys[r] == input_r[order[r]]
    stats: TierStats  # escalation counters of the fused sort
    tier: Optional[str]  # capacity tier that served the batch
    n_per_proc: int  # the power-of-two bucket of the batch


@dataclasses.dataclass
class InFlightSegmentedSort:
    """A launched fused batch: :meth:`wait` escalates through the ladder if
    the launched rung faulted, then unpacks per segment."""

    packed: PackedSegments
    flight: InFlightSort

    def done(self) -> bool:
        return self.flight.done()

    def wait(self) -> SegmentedResult:
        res, vbufs, stats = self.flight.wait()
        return _unpack_result(self.packed, res, vbufs, stats)


def segmented_sort_launch(
    packed: PackedSegments,
    cfg: Optional[SortConfig] = None,
    *,
    stats: Optional[TierStats] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
    executor: Optional[SortExecutor] = None,
    **overrides,
) -> InFlightSegmentedSort:
    """Launch one fused overflow-safe sort without awaiting it.

    Default config: SORT_IRAN_BSP starting at the exact pair capacity (the
    contiguous layout's value-clustered lanes break any smaller one); its
    receive side is still Claim 5.1's bound, and a batch over it escalates
    to the allgather rung instead of dropping keys. ``generator`` draws
    the randomized sample, as in :func:`api.bsp_sort_safe_launch`.
    ``route="radix"`` sorts the composites by counting, in one rung. A
    batch packed with ``layout="striped"`` can start below exact with the
    capacity planner's bound: ``pair_capacity="planned"`` with its
    ``pair_cap_override`` and ``omega`` (``repro_torch.planner``).
    """
    if cfg is None:
        cfg = SortConfig(
            p=packed.p,
            n_per_proc=packed.n_per_proc,
            **{"algorithm": "iran", "pair_capacity": "exact", **overrides},
        )
    if (cfg.p, cfg.n_per_proc) != (packed.p, packed.n_per_proc):
        raise ValueError("config does not match the packed layout")
    dev = resolve_device(device)
    x = torch.from_numpy(packed.comp).to(dev)
    pos = torch.from_numpy(packed.pos).to(dev)
    flight = bsp_sort_safe_launch(
        x, cfg, values=(pos,), stats=stats if stats is not None else TierStats(),
        generator=generator, device=dev, executor=executor,
    )
    if flight.trace_tid is not None:
        # the batch's segment shape, on the sort's timeline lane
        sizes = packed.sizes
        resolve_tracer(cfg.obs).point(
            "segments",
            tid=flight.trace_tid,
            n_segments=len(sizes),
            n_keys=packed.n_keys,
            layout=packed.layout,
            sizes=list(sizes) if len(sizes) <= 256 else None,
            size_max=max(sizes) if sizes else 0,
        )
    return InFlightSegmentedSort(packed=packed, flight=flight)


def segmented_sort_safe(
    packed: PackedSegments,
    cfg: Optional[SortConfig] = None,
    *,
    stats: Optional[TierStats] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
    executor: Optional[SortExecutor] = None,
    **overrides,
) -> SegmentedResult:
    """Sort every packed segment in one overflow-safe BSP sort (blocking)."""
    return segmented_sort_launch(
        packed, cfg, stats=stats, generator=generator, device=device, executor=executor, **overrides
    ).wait()


def _unpack_result(packed: PackedSegments, res, vbufs, stats) -> SegmentedResult:
    """Slice the fused sorted sequence back into segments."""
    n = packed.n_keys
    counts = res.count.tolist()
    pos = torch.cat([vbufs[0][k, :c] for k, c in enumerate(counts)])
    flat = gathered_output(res)
    if len(packed.sizes) == 1:
        # raw int32 keys: pads (int32 max) may equal real keys and mix with
        # them among the maxima, so keep the elements with a position
        keep = pos >= 0
        return SegmentedResult(keys=[flat[keep]], order=[pos[keep]], stats=stats,
                               tier=stats.last_tier, n_per_proc=packed.n_per_proc)
    flat, pos = flat[:n], pos[:n]  # pad composites (segment R) hold the tail
    keys = ((flat & int(_KEY_MASK)) - int(_KEY_BIAS)).to(torch.int32)
    sizes = list(packed.sizes)
    return SegmentedResult(keys=list(torch.split(keys, sizes)), order=list(torch.split(pos, sizes)),
                           stats=stats, tier=stats.last_tier, n_per_proc=packed.n_per_proc)


def sort_segments(
    arrays: Sequence[np.ndarray],
    p: int = 8,
    *,
    n_per_proc: Optional[int] = None,
    min_n_per_proc: int = 8,
    layout: str = "contiguous",
    stats: Optional[TierStats] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
    executor: Optional[SortExecutor] = None,
    **overrides,
) -> SegmentedResult:
    """Pack, sort and unpack a batch of ragged requests."""
    packed = pack_segments(arrays, p, n_per_proc=n_per_proc, min_n_per_proc=min_n_per_proc, layout=layout)
    return segmented_sort_safe(packed, stats=stats, generator=generator, device=device, executor=executor,
                               **overrides)
