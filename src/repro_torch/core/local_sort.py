"""Ph2 — stable local sort of every processor's run, by the configured method.

``lax``     — a stable sort (the JAX package's ``lax.sort``
              role); payloads follow by a gather with the stable argsort.
``bitonic`` — the hand-written bitonic tile-sort kernel (K1) for key-only
              sorts of the dtypes it takes (int32, uint32, float32,
              bfloat16); key-value and other dtypes take ``lax``, as in
              the JAX package.
``radix``   — the linear-work LSD counting sort (``core/radix.py``) for
              integer keys, payloads gathered by its order (the
              [·SR] variants); float keys take ``lax``, as in the JAX
              package. uint32 keys arrive biased to int32, which keeps
              their order.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..kernels.bitonic import ops as bitonic_ops
from .primitives import stable_sort, take_rows
from .radix import radix_argsort


def local_sort(
    x: torch.Tensor, method: str = "lax", values: Sequence[torch.Tensor] = ()
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Stable sort of (p, n_p) runs along dim 1, carrying payloads (p, n_p, ...)."""
    if method == "radix" and not x.is_floating_point():
        order = radix_argsort(x)
        return x.gather(1, order.long()), [take_rows(v, order) for v in values]
    if method == "bitonic" and not values and bitonic_ops.supports(x):
        return bitonic_ops.sort(x), []
    if not values:
        return stable_sort(x)[0], []
    xs, perm = stable_sort(x)
    return xs, [take_rows(v, perm) for v in values]
