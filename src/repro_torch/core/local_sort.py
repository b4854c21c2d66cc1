"""Ph2 — stable local sort of every processor's run, by the configured method.

``lax``     — a stable sort (the JAX package's ``lax.sort``
              role); payloads follow by a gather with the stable argsort.
``bitonic`` — the hand-written bitonic tile-sort kernel (K1) for key-only
              sorts of the dtypes it takes (int32, uint32, float32,
              bfloat16); key-value and other dtypes take ``lax``, as in
              the JAX package.
``radix``   — not ported yet (ROADMAP, queue 1).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..kernels.bitonic import ops as bitonic_ops
from .primitives import stable_sort, take_rows


def local_sort(
    x: torch.Tensor, method: str = "lax", values: Sequence[torch.Tensor] = ()
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Stable sort of (p, n_p) runs along dim 1, carrying payloads (p, n_p, ...)."""
    if method == "radix":
        raise NotImplementedError(
            "local_sort='radix' is not ported yet (see ROADMAP.md, queue 1)"
        )
    if method == "bitonic" and not values and bitonic_ops.supports(x):
        return bitonic_ops.sort(x), []
    if not values:
        return stable_sort(x)[0], []
    xs, perm = stable_sort(x)
    return xs, [take_rows(v, perm) for v in values]
