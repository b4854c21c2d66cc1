"""Plain PyTorch version of the merge-path merge (K3): the window sort."""
from __future__ import annotations

import torch

from ...core.types import sentinel_for


def merge_windows(a: torch.Tensor, b: torch.Tensor, tile: int, out_width: int) -> torch.Tensor:
    """The JAX package's ``merge_partitioned`` with a sort per window.

    For output span [d, d+tile) the a-first rank positions
    ``pos_a(i) = i + #{b_j < a_i}`` give the diagonal ``ia(d) = #{pos_a < d}``;
    sentinel-filled windows of ``tile`` keys per side are sorted together
    and their first ``tile`` keys are the span. a, b (rows, W) sorted.
    """
    rows, W = a.shape
    sent = sentinel_for(a.dtype)
    nt = -(-out_width // tile)
    pos_a = torch.arange(W, device=a.device) + torch.searchsorted(b, a)
    d = (torch.arange(nt, device=a.device) * tile).expand(rows, nt).contiguous()
    ia = torch.searchsorted(pos_a, d)
    ib = d - ia
    t = torch.arange(tile, device=a.device)
    ga = ia[:, :, None] + t
    gb = ib[:, :, None] + t
    aw = torch.where(ga < W, a.gather(1, ga.clamp(0, W - 1).reshape(rows, -1)).view_as(ga), sent)
    bw = torch.where(gb < W, b.gather(1, gb.clamp(0, W - 1).reshape(rows, -1)).view_as(gb), sent)
    spans = torch.sort(torch.cat([aw, bw], dim=-1), dim=-1).values[..., :tile]
    return spans.reshape(rows, nt * tile)[:, :out_width]
