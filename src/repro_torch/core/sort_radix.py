"""Radix h-relation — count-then-distribute routing for integer keys.

Exact bucket boundaries come from one counting pass over the locally
sorted runs, so the splitter superstep (Ph3) disappears and the
per-destination counts are known before any data moves; the launch driver
reads them and sizes the single rung of the ladder to the true maxima
(``api._radix_exact_ladder``), so a ``route="radix"`` sort never retries.

Destination function (the JAX package's): keys go through
:func:`radix._to_unsigned_order_preserving`, then are bucketed over the
observed global range::

    lo, hi = min over processors of u[0], max of u[-1]
    width  = (hi - lo) // p + 1
    dest   = (u - lo) // width

in the unsigned arithmetic of the keys' width (wrapping), and the (p+1,)
boundaries of every run are ``searchsorted(dest, arange(p + 1))``. ``dest``
is monotone in key order for integer keys, so the boundaries feed the
shared Ph5/Ph6 tail (``routing.route_and_merge``) as Ph4's do.

torch has no unsigned 64-bit arithmetic, so the image of 64-bit keys never
becomes a tensor: ``lo`` and ``hi`` are read to the host, the bucket starts
``lo + i * width`` are exact Python integers, and each run is searched for
them mapped back to the signed keys (a start past the unsigned range takes
the whole run). Narrower keys compute ``dest`` itself in int64, exactly;
float keys (the value cast, saturating, NaN to 0) need it, since a NaN
makes ``dest`` fall, and their search replays ``jnp.searchsorted``'s probes.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import primitives as prim
from . import routing
from .local_sort import local_sort
from .radix import _to_unsigned_order_preserving, unsigned_value
from .types import PreparedSort, SortConfig


def _boundaries_64(xs: torch.Tensor, p: int, procs) -> torch.Tensor:
    """Counted boundaries of sorted 64-bit integer runs, from the bucket
    starts as Python integers (one host read of the two extremes)."""
    top = 2**63
    lo, hi = (int(v) + top for v in torch.stack([procs.min(xs[:, 0]), procs.max(xs[:, -1])]).tolist())
    width = (hi - lo) // p + 1
    starts = [lo + i * width for i in range(p + 1)]
    inside = [s < 2**64 for s in starts]
    keys = torch.tensor([s - top if ok else 0 for s, ok in zip(starts, inside)],
                        dtype=xs.dtype, device=xs.device)
    ranks = prim.searchsorted(xs, keys.expand(xs.shape[0], p + 1).contiguous(), "left")
    full = torch.tensor(inside, device=xs.device)
    return torch.where(full, ranks, xs.shape[1]).to(torch.int32)


def radix_boundaries(xs: torch.Tensor, p: int, procs=None) -> torch.Tensor:
    """Counted (rows, p+1) bucket boundaries of the locally sorted runs ``xs``.

    b[:, 0] = 0, b[:, p] = n_p; destination i receives ``xs[k, b[k, i]:b[k, i+1]]``.
    Two scalar reductions over the processors (the JAX package's ``pmin``
    and ``pmax``) plus one vectorised binary search — no sample, no
    splitter sort.
    """
    procs = prim.procs_or_local(procs, p)
    if not xs.is_floating_point() and xs.element_size() == 8:
        return _boundaries_64(xs, p, procs)
    u = unsigned_value(_to_unsigned_order_preserving(xs))
    modulus = 2 ** (xs.element_size() * 8)
    lo = procs.min(u[:, 0])  # each run is sorted: its first and last are its extremes
    hi = procs.max(u[:, -1])
    width = (hi - lo) % modulus // p + 1
    dest = (u - lo) % modulus // width
    dest = torch.where(dest >= 2**31, dest - 2**32, dest).to(torch.int32)  # astype(int32)
    edges = torch.arange(p + 1, dtype=torch.int32, device=xs.device).expand(xs.shape[0], p + 1)
    return prim.searchsorted(dest, edges.contiguous(), "left", exact_probes=xs.is_floating_point())


def host_send_counts(bounds: torch.Tensor) -> np.ndarray:
    """(p, p) per-(src, dst) send counts from the counted boundaries, on the
    host: the radix launch path's one host read."""
    return np.diff(bounds.cpu().numpy(), axis=1)


def prepare_radix_spmd(
    x: torch.Tensor, cfg: SortConfig, values: Sequence[torch.Tensor] = (), procs=None
) -> PreparedSort:
    """Tier-invariant stage: Ph2 stable local sort + the counting pass.

    The boundaries do not depend on the capacity tier, so they ride in
    ``splits`` and the launch driver reads the exact counts before it
    dispatches the route stage.
    """
    xs, vals = local_sort(x, cfg.local_sort, values)
    return PreparedSort(xs=xs, vals=tuple(vals), splits=(radix_boundaries(xs, cfg.p, procs),))


def route_radix_spmd(
    prep: PreparedSort, cfg: SortConfig, positions: Optional[torch.Tensor] = None, procs=None
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor, torch.Tensor]:
    """Ph5 fused h-relation + Ph6 merge tail on the counted boundaries
    (nothing random: ``positions`` is unused)."""
    return routing.route_and_merge(prep.xs, prep.splits[0], cfg, list(prep.vals), procs)


def sort_radix_spmd(
    x: torch.Tensor, cfg: SortConfig, values: Sequence[torch.Tensor] = (), procs=None
) -> Tuple[torch.Tensor, List[torch.Tensor], torch.Tensor, torch.Tensor]:
    return route_radix_spmd(prepare_radix_spmd(x, cfg, values, procs), cfg, procs=procs)
