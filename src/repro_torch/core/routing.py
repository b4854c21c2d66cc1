"""Ph5 key routing (Fig. 1 steps 10–11) — the single balanced h-relation.

Every processor's run is cut into p destination rows of static width and
delivered by one exchange over the leading processor dimension:

* ``a2a_dense`` — (p_src, p_dst, pair_cap) rows, one all_to_all (a
  transpose). ``pair_cap`` is the per-(src, dst) capacity of the tier, so
  an overflow is detected (any send count above it, or a receive total
  above ``n_max``) and surfaced as the retriable ``overflow`` flag.
* ``allgather`` — the ladder's terminal tier: every processor sees every
  run and slices its bucket (rows of width n_p); receive buffer n.
* ``ring`` — p−1 rotation supersteps of a visitor block (a run, its
  payloads and its boundary row): exact, the literal BSP superstep
  structure. Its receive buffer is the tier's ``n_max``; its overflow is
  a receive total above it.

Under ``exchange="fused"`` the key and payload rows are bitcast to bytes
and concatenated into one buffer, so a data superstep is one exchange
whatever the payload count (on the ring, the boundary row rides in the
same buffer); the bitcast is exact, so the result equals ``per_array``'s.
Received rows are ordered by (source proc, local idx), which keeps the
final merge stable.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import merge as merge_mod
from . import primitives as prim
from .types import SortConfig, sentinel_for


# ------------------------------------------------------ fused byte packing
def pack_bytes(arrs: Sequence[torch.Tensor], lead: int = 2) -> Tuple[torch.Tensor, tuple]:
    """Bitcast arrays sharing ``lead`` leading dims into ONE uint8 buffer.

    Each array contributes its trailing dims as a flat byte run along a new
    last axis. Returns ``(buffer, metas)``; :func:`unpack_bytes` inverts it.
    """
    parts, metas = [], []
    for a in arrs:
        flat = a.contiguous().reshape(a.shape[:lead] + (-1,))
        parts.append(flat.view(torch.uint8))
        metas.append((a.dtype, tuple(a.shape[lead:])))
    return torch.cat(parts, dim=-1), tuple(metas)


def unpack_bytes(buf: torch.Tensor, metas: tuple, lead: int = 2) -> List[torch.Tensor]:
    """Invert :func:`pack_bytes` after delivery (bit-exact)."""
    out, off = [], 0
    head = tuple(buf.shape[:lead])
    for dtype, trail in metas:
        nb = int(torch.Size(trail).numel()) * torch.empty((), dtype=dtype).element_size()
        part = buf[..., off : off + nb].contiguous()
        off += nb
        out.append(part.view(dtype).reshape(head + tuple(trail)))
    return out


def pack_bytes_flat(arrs: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, tuple]:
    """Pack every processor's arrays of any shapes into one flat byte row.

    Arrays share the leading processor dimension; each contributes the
    rest as a flat byte run, so the ring's visitor block (run, payloads and
    the (p+1,) boundary row) rotates in ONE exchange per superstep.
    """
    return pack_bytes(arrs, lead=1)


def unpack_bytes_flat(vec: torch.Tensor, metas: tuple) -> List[torch.Tensor]:
    """Invert :func:`pack_bytes_flat` (bit-exact)."""
    return unpack_bytes(vec, metas, lead=1)


# ---------------------------------------------- host-side accounting math
def packed_row_bytes(key_dtype: torch.dtype, value_dtypes: Sequence[torch.dtype] = ()) -> int:
    """Bytes one routed row carries in the fused exchange (key + payloads)."""
    return int(sum(torch.empty((), dtype=d).element_size() for d in (key_dtype, *value_dtypes)))


def route_supersteps(routing: str, p: int) -> int:
    """Data supersteps one route stage issues under ``routing``:
    ``a2a_dense`` the count exchange plus one fused data exchange,
    ``allgather`` one gather, ``ring`` p−1 rotations."""
    if routing == "a2a_dense":
        return 2
    if routing == "allgather":
        return 1
    if routing == "ring":
        return max(1, p - 1)
    raise ValueError(f"unknown routing {routing!r}")


# ---------------------------------------------------------------- routing
def send_counts(boundaries: torch.Tensor) -> torch.Tensor:
    """(p_src, p_dst) keys every processor sends to every destination."""
    return torch.diff(boundaries, dim=-1)


def recv_counts(counts: torch.Tensor) -> torch.Tensor:
    """(p_dst, p_src): r[me, j] = counts[j, me] — the count bookkeeping superstep."""
    return prim.all_to_all(counts)


#: payload fill of empty slots (keys take the dtype sentinel)
_PAYLOAD_PAD = 0


def _segment_rows(
    arrs: Sequence[torch.Tensor],
    boundaries: torch.Tensor,
    counts: torch.Tensor,
    width: int,
    key_sentinel,
) -> List[torch.Tensor]:
    """Cut every run into p destination rows of static width.

    rows[src, i, t] = arr[src, b[src, i] + t] for t < c[src, i], else pad.
    """
    p, n_p = arrs[0].shape[:2]
    t = torch.arange(width, device=boundaries.device)
    idx = torch.clamp(boundaries[:, :-1, None] + t, 0, n_p - 1).reshape(p, -1)
    valid = t < counts[:, :, None]
    rows = []
    for i, a in enumerate(arrs):
        g = prim.take_rows(a, idx).reshape((p, p, width) + a.shape[2:])
        fill = key_sentinel if i == 0 else _PAYLOAD_PAD
        mask = valid.reshape(valid.shape + (1,) * (g.ndim - 3))
        rows.append(torch.where(mask, g, torch.tensor(fill, dtype=a.dtype, device=a.device)))
    rows[0] = prim.canonical_nans(rows[0])  # the key rows' where computes on them
    return rows


def _all_to_all_rows(rows: List[torch.Tensor], cfg: SortConfig) -> List[torch.Tensor]:
    """Deliver (p_src, p_dst, w, ...) rows: ONE fused exchange, or one per array."""
    if cfg.exchange == "fused" and len(rows) > 1:
        buf, metas = pack_bytes(rows, lead=3)
        return unpack_bytes(prim.all_to_all(buf), metas, lead=3)
    return [prim.all_to_all(r) for r in rows]


def recv_rows(
    x_sorted: torch.Tensor,
    boundaries: torch.Tensor,
    cfg: SortConfig,
    values: Sequence[torch.Tensor] = (),
) -> Tuple[List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Deliver bucket ``me`` of every source to every processor ``me``.

    Returns ``(rows, rcounts, overflow)``: rows[a] is (p_me, p_src, width,
    ...), row j the sorted padded run received from source j; rcounts
    (p_me, p_src) int32 its valid lengths; overflow (p,) bool, replicated.
    Width = pair_cap (a2a_dense) or n_p (allgather).
    """
    p, n_p = x_sorted.shape
    sent = sentinel_for(x_sorted.dtype)
    counts = send_counts(boundaries)
    arrs = [x_sorted, *values]

    if cfg.routing == "a2a_dense":
        rcounts = recv_counts(counts)
        over = (counts > cfg.pair_cap).any(dim=1) | (rcounts.sum(dim=1) > cfg.n_max)
        rows = _segment_rows(arrs, boundaries, counts, cfg.pair_cap, sent)
        return _all_to_all_rows(rows, cfg), rcounts, over.any().expand(p)

    if cfg.routing == "allgather":
        # every processor sees all boundaries (the bookkeeping gather) and
        # all runs (the data gather), then slices bucket ``me`` of each
        starts = boundaries[:, :-1].transpose(0, 1)  # (p_me, p_src)
        rcounts = recv_counts(counts)
        t = torch.arange(n_p, device=x_sorted.device)
        idx = torch.clamp(starts[:, :, None] + t, 0, n_p - 1)  # (p_me, p_src, n_p)
        valid = t < rcounts[:, :, None]
        src = torch.arange(p, device=x_sorted.device)[None, :, None]
        rows = []
        for i, a in enumerate(arrs):
            g = prim.all_gather(a)[torch.arange(p, device=a.device)[:, None, None], src, idx.long()]
            fill = sent if i == 0 else _PAYLOAD_PAD
            mask = valid.reshape(valid.shape + (1,) * (g.ndim - 3))
            rows.append(torch.where(mask, g, torch.tensor(fill, dtype=a.dtype, device=a.device)))
        rows[0] = prim.canonical_nans(rows[0])
        over = rcounts.sum(dim=1) > cfg.n_max
        return rows, rcounts, over.any().expand(p)

    raise ValueError(f"recv_rows: unsupported routing {cfg.routing!r}")


def compact_rows(
    rows: Sequence[torch.Tensor],
    rcounts: torch.Tensor,
    cap: int,
    key_sentinel,
) -> List[torch.Tensor]:
    """Scatter (p, p_src, w, ...) rows into (p, cap, ...) buffers by source.

    Row j's first r_j entries land at offsets[j]...; the rest, and anything
    past ``cap``, are dropped. Pads end at the tail.
    """
    p, n_src, w = rows[0].shape[:3]
    offsets = prim.exclusive_cumsum(rcounts, dim=1)
    t = torch.arange(w, device=rcounts.device)
    valid = t < rcounts[:, :, None]
    idx = torch.clamp(torch.where(valid, offsets[:, :, None] + t, cap), max=cap)
    idx = idx.reshape(p, n_src * w).long()
    out = []
    for i, r in enumerate(rows):
        trail = r.shape[3:]
        fill = key_sentinel if i == 0 else _PAYLOAD_PAD
        buf = torch.full((p, cap + 1) + trail, fill, dtype=r.dtype, device=r.device)
        index = idx.reshape((p, n_src * w) + (1,) * len(trail)).expand((p, n_src * w) + trail)
        prim.scatter_(buf, 1, index, r.reshape((p, n_src * w) + trail))
        out.append(buf[:, :cap])
    return out


def route(
    x_sorted: torch.Tensor,
    boundaries: torch.Tensor,
    cfg: SortConfig,
    values: Sequence[torch.Tensor] = (),
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Route bucket i of every processor to processor i, compacted by source.

    Returns ``(buf, value_bufs, count, overflow)``: (p, n_max) receive
    buffers ordered by (src, idx), (p,) valid lengths (int32; int64 for
    int64 keys), (p,) flags.
    """
    sent = sentinel_for(x_sorted.dtype)
    cap = cfg.n_max
    if cfg.routing == "ring":
        return _route_ring(x_sorted, boundaries, cfg, values, sent)
    rows, rcounts, overflow = recv_rows(x_sorted, boundaries, cfg, values)
    out = compact_rows(rows, rcounts, cap, sent)
    total = torch.clamp(_received_total(rcounts, x_sorted), max=cap)
    return out[0], out[1:], total, overflow


def _received_total(rcounts: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """(p,) keys received, int64 for int64 keys: the JAX package's sum of
    the receive counts widens to int64 under the 64-bit scope its int64
    keys need. The merge tree's own counts stay int32 there too."""
    return rcounts.sum(dim=1, dtype=torch.int64 if keys.dtype == torch.int64 else torch.int32)


def _fit(arr: torch.Tensor, cap: int, fill) -> torch.Tensor:
    """Slice or pad-extend (p, L, ...) merged runs to the (p, cap, ...) shape."""
    if arr.shape[1] >= cap:
        return arr[:, :cap]
    pad = torch.full(
        (arr.shape[0], cap - arr.shape[1]) + arr.shape[2:], fill, dtype=arr.dtype, device=arr.device
    )
    return torch.cat([arr, pad], dim=1)


def route_and_merge(
    x_sorted: torch.Tensor,
    boundaries: torch.Tensor,
    cfg: SortConfig,
    values: Sequence[torch.Tensor] = (),
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Ph5 + Ph6: route, then stable merge (``tree`` or ``sort``).

    Every received row is a sorted run (bucket i of a sorted run), which is
    what makes the tree tail valid; it takes the received rows (keys and
    payloads) straight into :func:`merge.merge_tree`. The ring delivers a
    compacted buffer, not rows, so it takes the sort tail under either.
    """
    if cfg.merge == "tree" and cfg.routing != "ring":
        rows, rcounts, overflow = recv_rows(x_sorted, boundaries, cfg, values)
        cap = cfg.n_max
        has_nan = None
        if cfg.merge_backend == "pallas" and not values and x_sorted.is_floating_point():
            # one device flag for the whole tree, from the keys as they enter
            # it: K3 takes its merge route when they hold no NaN
            has_nan = torch.isnan(x_sorted).any()
        merged, mvals, count = merge_mod.merge_tree(
            rows[0], rcounts, values=rows[1:], backend=cfg.merge_backend, cap=cap, has_nan=has_nan
        )
        merged = _fit(merged, cap, sentinel_for(x_sorted.dtype))
        mvals = [_fit(v, cap, _PAYLOAD_PAD) for v in mvals]
        return merged, mvals, torch.clamp(count, max=cap), overflow

    buf, vbufs, count, overflow = route(x_sorted, boundaries, cfg, values)
    merged, mvals = merge_mod.merge_by_sort(buf, vbufs)
    return merged, mvals, count, overflow


def _route_ring(
    x_sorted: torch.Tensor,
    boundaries: torch.Tensor,
    cfg: SortConfig,
    values: Sequence[torch.Tensor],
    sent,
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """p−1 rotation supersteps; the visitor block is one run + its boundaries.

    Superstep r (r = 0 places every processor's own bucket) places, at
    processor ``me``, bucket ``me`` of the run that started at processor
    ``me - r``, at that source's offset in the receive buffer; then every
    visitor block moves one processor on. Under ``exchange="fused"`` the
    block (keys, payloads and the boundary row) moves as one byte row.
    """
    p, cap = cfg.p, cfg.n_max
    n_p = x_sorted.shape[1]
    dev = x_sorted.device
    me = torch.arange(p, device=dev)
    arrs = [x_sorted, *values]

    rcounts = recv_counts(send_counts(boundaries))  # (p_me, p_src)
    offsets = prim.exclusive_cumsum(rcounts, dim=1)
    total = _received_total(rcounts, x_sorted)
    overflow = (total > cap).any().expand(p)

    bufs = [
        torch.full((p, cap + 1) + a.shape[2:], sent if i == 0 else _PAYLOAD_PAD, dtype=a.dtype, device=dev)
        for i, a in enumerate(arrs)
    ]  # column ``cap`` takes what the buffer drops
    t = torch.arange(n_p, device=dev)
    vis_arrs, vis_b = list(arrs), boundaries
    for r in range(p):
        src = (me - r) % p
        start = vis_b[me, me]
        cnt = vis_b[me, me + 1] - start
        idx = torch.clamp(start[:, None] + t, 0, n_p - 1)
        valid = t < cnt[:, None]
        dst = torch.where(valid, offsets[me, src][:, None] + t, cap).clamp(max=cap)
        for buf, a in zip(bufs, vis_arrs):
            trail = a.shape[2:]
            index = dst.reshape(dst.shape + (1,) * len(trail)).expand((p, n_p) + trail)
            prim.scatter_(buf, 1, index, prim.take_rows(a, idx))
        if r != p - 1:
            if cfg.exchange == "fused":
                vec, metas = pack_bytes_flat(vis_arrs + [vis_b])
                *vis_arrs, vis_b = unpack_bytes_flat(prim.ppermute_shift(vec, 1), metas)
            else:
                vis_arrs = prim.ppermute_shift(vis_arrs, 1)
                vis_b = prim.ppermute_shift(vis_b, 1)
    return bufs[0][:, :cap], [b[:, :cap] for b in bufs[1:]], torch.clamp(total, max=cap), overflow
