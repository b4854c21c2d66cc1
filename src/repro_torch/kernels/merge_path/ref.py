"""Plain PyTorch version of the merge-path merge (K3)."""
from __future__ import annotations

import torch

from ...core.primitives import gather, searchsorted
from ...core.types import sentinel_for
from ..bitonic.ref import stage


def diagonals(a: torch.Tensor, b: torch.Tensor, tile: int, spans: int) -> torch.Tensor:
    """(rows, spans) a-elements before output column ``d = span * tile``.

    The JAX package's split: with the a-first rank positions
    ``pos_a(i) = i + #{b_j < a_i}``, ``ia(d) = #{pos_a < d}``, both by
    ``jnp.searchsorted``. Float keys replay its probes (``exact_probes``),
    so unsorted runs split as they do there.
    """
    rows, W = a.shape
    exact = a.is_floating_point()
    pos_a = torch.arange(W, device=a.device, dtype=torch.int32) + searchsorted(b, a, "left", exact)
    d = (torch.arange(spans, device=a.device, dtype=torch.int32) * tile).expand(rows, spans)
    return searchsorted(pos_a, d.contiguous(), "left", exact)


def merge_rows(aw: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's merge: bitonic merge network over ``concat(a, reverse(b))``."""
    x = torch.cat([aw, bw.flip(-1)], dim=-1)
    w2 = x.shape[-1]
    j = w2 // 2
    while j >= 1:
        x = stage(x, 2 * w2, j)  # k > width: every region ascending
        j //= 2
    return x


def merge_windows(a: torch.Tensor, b: torch.Tensor, tile: int, out_width: int) -> torch.Tensor:
    """The JAX package's ``merge_partitioned``, first ``out_width`` columns.

    For output span [d, d+tile), sentinel-filled windows of ``tile`` keys
    per side start at the span's diagonal; their network merge's first
    ``tile`` keys are the span. a, b (rows, W) sorted.
    """
    rows, W = a.shape
    sent = sentinel_for(a.dtype)
    nt = -(-out_width // tile)
    ia = diagonals(a, b, tile, nt).long()
    ib = torch.arange(nt, device=a.device) * tile - ia
    t = torch.arange(tile, device=a.device)
    ga = ia[:, :, None] + t
    gb = ib[:, :, None] + t
    aw = torch.where(ga < W, gather(a, 1, ga.clamp(0, W - 1).reshape(rows, -1)).view_as(ga), sent)
    bw = torch.where(gb < W, gather(b, 1, gb.clamp(0, W - 1).reshape(rows, -1)).view_as(gb), sent)
    spans = merge_rows(aw.reshape(rows * nt, tile), bw.reshape(rows * nt, tile))[:, :tile]
    return spans.reshape(rows, nt * tile)[:, :out_width]
