"""Token sampling for serving.

The port of the JAX package's ``repro.serve.sampling``. Randomness comes
from an explicit ``torch.Generator``; ``jax.random``'s draws cannot be
reproduced in torch, so sampling is held to its properties (greedy is the
argmax, a top-k draw stays in the top k), not to the reference's tokens.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.layers import top_k_stable


def top_k_logits(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest per row, descending, the lower
    index first among equal values (``lax.top_k``'s order)."""
    return top_k_stable(logits, k)


def _categorical(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row from softmax(logits), by the Gumbel-max trick as
    ``jax.random.categorical`` draws (-log of an Exp(1) draw is Gumbel)."""
    e = torch.empty_like(logits).exponential_(generator=generator)
    return torch.argmax(logits - torch.log(e), dim=-1)


def sample(
    logits: torch.Tensor,  # (B, V) fp32/bf16
    generator: Optional[torch.Generator] = None,
    *,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
) -> torch.Tensor:
    lf = logits.float()
    if temperature <= 0.0:
        return torch.argmax(lf, dim=-1).to(torch.int32)
    lf = lf / temperature
    if top_k:
        vals, idx = top_k_logits(lf, top_k)
        if top_p:
            # nucleus within the top-k candidates (sorted descending already)
            probs = torch.softmax(vals, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            vals = torch.where(cum - probs < top_p, vals, torch.full_like(vals, -torch.inf))
        choice = _categorical(vals, generator)
        return torch.gather(idx, 1, choice[:, None])[:, 0].to(torch.int32)
    return _categorical(lf, generator).to(torch.int32)
