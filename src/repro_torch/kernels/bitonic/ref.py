"""Plain PyTorch version of the bitonic tile sort (K1)."""
from __future__ import annotations

import torch


def sort_tiles(x: torch.Tensor) -> torch.Tensor:
    """Ascending sort of every row of a (rows, width) tile."""
    return torch.sort(x, dim=-1).values
