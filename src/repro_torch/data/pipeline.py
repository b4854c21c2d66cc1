"""Data pipeline: stateless-seeded synthetic LM batches + BSP-sort bucketing.

The port of the JAX package's ``repro.data.pipeline``:

* ``synthetic_batch(cfg, shape, step)`` — deterministic (step → batch) on
  one device: a ``torch.Generator`` seeded with the step draws it, so a
  restart from a checkpoint replays the exact stream. (``jax.random``'s
  draws cannot be reproduced in torch; the contract is the determinism.)
* ``length_bucketed_order`` — global length-bucketing of a corpus of
  variable-length documents through the port's sort service: keys =
  document lengths, payload = doc ids, one segment of a fused segmented
  sort; the stable argsort is the bucketing order.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..core.api import TierStats
from ..core.types import resolve_device
from ..models.layers import dtype_of
from ..planner import CapacityPlanner
from ..service import ServiceConfig, SortService

#: shared across the per-call throwaway services below, so the planner's
#: per-bucket tier learning accumulates across calls instead of being
#: discarded with each one-shot service.
_DEFAULT_PLANNER = CapacityPlanner()


def synthetic_batch(
    cfg: ArchConfig, shape: ShapeConfig, step: int, *, batch_override: Optional[int] = None, device=None
) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    b = batch_override or shape.global_batch
    s = shape.seq_len
    gen = torch.Generator(device=dev).manual_seed(step)
    tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, dtype=torch.int32, device=dev)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.zeros((b, cfg.vision_tokens, cfg.d_model), dtype=dtype_of(cfg), device=dev)
    if cfg.family == "audio":
        batch["frames"] = torch.randn((b, cfg.enc_positions, cfg.d_model), generator=gen, device=dev).to(dtype_of(cfg))
    return batch


def length_bucketed_order(
    doc_lengths: np.ndarray,
    p: int,
    *,
    algorithm: str = "iran",
    seed: int = 0,
    stats: Optional[TierStats] = None,
    service: Optional[SortService] = None,
    device=None,
) -> np.ndarray:
    """Return doc ids in globally length-sorted order using the BSP sort.

    ``doc_lengths``: (n,) int32. The corpus goes through the sort service
    (on ``device``, default the card) as one segment of a fused segmented
    sort; equal lengths keep corpus order. Pass a ``TierStats`` to
    accumulate retry counters, or a ``SortService`` to fuse with its queued
    requests — its own config then governs algorithm/seed, its stats take
    the retries and its device the work (``p`` must agree with its own).
    """
    if service is None:
        service = SortService(
            ServiceConfig(p=p, algorithm=algorithm, seed=seed),
            stats=stats,
            planner=_DEFAULT_PLANNER,
            device=device,
        )
    elif service.cfg.p != p:
        raise ValueError(f"service sorts with p={service.cfg.p}, caller asked for p={p}")
    return service.sort_one(np.asarray(doc_lengths, np.int32)).order


def batches_for_run(cfg: ArchConfig, shape: ShapeConfig, start_step: int, n_steps: int, device=None):
    for step in range(start_step, start_step + n_steps):
        yield step, synthetic_batch(cfg, shape, step, device=device)
