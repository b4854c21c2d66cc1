"""Attention: chunked (flash-style) prefill path + KV-cache decode.

The port of the JAX package's ``repro.models.attention``, in plain torch:

* ``flash_attention`` — online softmax over KV chunks for each Q chunk,
  with the reference's chunk sizes (``_divisor_chunk``), its finite running
  max floor (``M_FLOOR``) and arithmetic ``NEG_INF`` masking, causal and
  sliding-window masks, GQA head grouping, and ``p`` cast to the input
  dtype before the PV product. A KV chunk that the masks hide from every
  query of the Q chunk is skipped: its ``p`` would be exactly 0 and its
  correction exactly 1, so the result is the same.
* ``decode_attention`` — one-token attention against a (S_max,) KV cache.
  ``pos`` is a scalar (every row at one position) or one position per
  batch row (the serving engine's independent lanes).
* ``cache_update`` — writes the new token's K/V at ``pos`` in place.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

NEG_INF = -1e30
#: finite floor for the running max — keeps exp() arithmetic NaN-free on
#: fully-masked blocks without predicate guards.
M_FLOOR = -1e9


def _divisor_chunk(n: int, want: int) -> int:
    """Largest chunk ≤ want that divides n (whisper's 1500 frames etc.)."""
    c = min(want, n)
    while n % c:
        c -= 1
    return c


def _gqa_expand(q: torch.Tensor, kv_heads: int) -> torch.Tensor:
    """Group query heads over KV heads: (B,S,H,hd) -> (B,S,KV,rep,hd)."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, kv_heads, h // kv_heads, hd)


def _scale(hd: int) -> float:
    """1 / sqrt(hd) computed in float32, as the reference does."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def reference_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """O(S²) oracle; also the reference's path for a one-token prompt."""
    b, sq, h, hd = q.shape
    _, sk, kvh, _ = k.shape
    qg = _gqa_expand(q, kvh)
    scores = torch.einsum("bsgrh,btgh->bgrst", qg, k).float()
    scores = scores / np.float32(np.sqrt(np.float32(hd)))
    qi = torch.arange(sq, device=q.device)[:, None] + q_offset
    kj = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window:
        mask &= qi - kj < window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrst,btgh->bsgrh", probs, v)
    return out.reshape(b, sq, h, hd)


def flash_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, KV, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    b, s, h, hd = q.shape
    _, sk, kvh, _ = k.shape
    q_chunk = _divisor_chunk(s, q_chunk)
    kv_chunk = _divisor_chunk(sk, kv_chunk)
    nq, nk = s // q_chunk, sk // kv_chunk
    rep = h // kvh
    scale = _scale(hd)
    dev = q.device

    qg = q.reshape(b, nq, q_chunk, kvh, rep, hd)
    kg = k.reshape(b, nk, kv_chunk, kvh, hd)
    vg = v.reshape(b, nk, kv_chunk, kvh, hd)
    ar_q = torch.arange(q_chunk, device=dev)[:, None]
    ar_k = torch.arange(kv_chunk, device=dev)[None, :]

    outs = []
    for qi in range(nq):
        qc = qg[:, qi]  # (B, q_chunk, KV, rep, hd)
        m = torch.full((b, kvh, rep, q_chunk), M_FLOOR, dtype=torch.float32, device=dev)
        l = torch.zeros((b, kvh, rep, q_chunk), dtype=torch.float32, device=dev)
        o = torch.zeros((b, kvh, rep, q_chunk, hd), dtype=torch.float32, device=dev)
        q_lo, q_hi = qi * q_chunk, qi * q_chunk + q_chunk - 1
        for kj in range(nk):
            k_lo, k_hi = kj * kv_chunk, kj * kv_chunk + kv_chunk - 1
            if (causal and k_lo > q_hi) or (window and q_lo - k_hi >= window):
                continue  # every (q, k) pair masked: p == 0, corr == 1
            kc, vc = kg[:, kj], vg[:, kj]
            sc = torch.einsum("bqgrh,bkgh->bgrqk", qc, kc).float() * scale
            qpos, kpos = q_lo + ar_q, k_lo + ar_k
            penalty = torch.zeros((q_chunk, kv_chunk), dtype=torch.float32, device=dev)
            if causal:
                penalty = penalty + torch.where(kpos <= qpos, 0.0, NEG_INF)
            if window:
                penalty = penalty + torch.where(qpos - kpos < window, 0.0, NEG_INF)
            sc = sc + penalty
            # m floored at M_FLOOR: sc - m_new ≤ -1e29 on masked lanes, so
            # exp underflows to exactly 0.0 with no NaN guard
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + torch.einsum("bgrqk,bkgh->bgrqh", p.to(qc.dtype), vc).float()
            m = m_new
        o = o / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(b, q_chunk, h, hd).to(q.dtype))
    return torch.cat(outs, dim=1)


def _lane_pos(pos: torch.Tensor, b: int) -> torch.Tensor:
    """``pos`` as one position per batch row: (B,)."""
    pos = torch.as_tensor(pos)
    return pos.expand(b) if pos.dim() == 0 else pos


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, hd) — the new token's queries
    k_cache: torch.Tensor,  # (B, S_max, KV, hd)
    v_cache: torch.Tensor,
    pos: torch.Tensor,  # () or (B,) — last valid cache position (inclusive)
    *,
    window: int = 0,
) -> torch.Tensor:
    b, _, h, hd = q.shape
    _, sk, kvh, _ = k_cache.shape
    qg = _gqa_expand(q, kvh)[:, 0]  # (B, KV, rep, hd)
    scores = torch.einsum("bgrh,btgh->bgrt", qg, k_cache).float()
    scores = scores / np.float32(np.sqrt(np.float32(hd)))
    t = torch.arange(sk, device=q.device)[None, :]
    lane = _lane_pos(pos, b)[:, None]
    valid = t <= lane
    if window:
        valid &= lane - t < window
    scores = torch.where(valid[:, None, None, :], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bgrt,btgh->bgrh", probs, v_cache)
    return out.reshape(b, 1, h, hd)


def decode_attention_sharded(
    q: torch.Tensor,  # (B, 1, H, hd): every head
    k_cache: torch.Tensor,  # (B, S_loc, KV, hd): this shard's slice of the sequence
    v_cache: torch.Tensor,
    pos: torch.Tensor,  # () or (B,): last valid position, global
    offset: int,  # the global position of the slice's first row
    group,  # the process group of the ranks that hold the other slices
    *,
    window: int = 0,
) -> torch.Tensor:
    """``decode_attention`` over a cache whose sequence is split over a
    group (the reference's ``cache_specs``, which XLA lowers to
    flash-decode): each shard takes its partial max, sum and weighted V
    over its slice in float32, and two all-reduces (max, then one sum of
    the rescaled sum and V) combine them. A slice with no valid position
    has max ``NEG_INF``, and its correction against the global max is
    exactly 0."""
    import torch.distributed as dist

    b, _, h, hd = q.shape
    _, sk, kvh, _ = k_cache.shape
    qg = _gqa_expand(q, kvh)[:, 0]  # (B, KV, rep, hd)
    scores = torch.einsum("bgrh,btgh->bgrt", qg, k_cache).float()
    scores = scores / np.float32(np.sqrt(np.float32(hd)))
    t = offset + torch.arange(sk, device=q.device)[None, :]
    lane = _lane_pos(pos, b)[:, None]
    valid = t <= lane
    if window:
        valid &= lane - t < window
    scores = torch.where(valid[:, None, None, :], scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(-1)
    m_all = m.clone()
    dist.all_reduce(m_all, op=dist.ReduceOp.MAX, group=group)
    p = torch.exp(scores - m_all[..., None])
    o = torch.einsum("bgrt,btgh->bgrh", p, v_cache.float())
    packed = torch.cat([p.sum(-1)[..., None], o], dim=-1)
    dist.all_reduce(packed, group=group)
    out = packed[..., 1:] / packed[..., :1]
    return out.to(q.dtype).reshape(b, 1, h, hd)


def cache_update(
    k_cache: torch.Tensor, v_cache: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor, pos
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write the new token's K/V (B, 1, KV, hd) at ``pos`` (per row), in place.

    A position past the cache's end (or before its start) writes nothing,
    as the reference's one-hot masked add does (a retired serving lane keeps decoding into
    scratch). The values written and kept equal the reference's; a -0.0
    kept in the cache stays -0.0 here where the reference's ``x * 1 + 0``
    makes it +0.0.
    """
    b, sk = k_cache.shape[:2]
    lane = _lane_pos(pos, b).to(k_cache.device)
    rows = torch.arange(b, device=k_cache.device)
    at = lane.clamp(0, sk - 1)
    # a shard of a sequence-sharded cache sees the positions of the shards
    # before its own as negative: it writes nothing for them either
    past = ((lane >= sk) | (lane < 0))[:, None, None]
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache[rows, at] = torch.where(past, cache[rows, at], new[:, 0])
    return k_cache, v_cache


__all__ = [
    "M_FLOOR",
    "NEG_INF",
    "cache_update",
    "decode_attention",
    "decode_attention_sharded",
    "flash_attention",
    "reference_attention",
]

