"""Carry a configuration and a prepared sort across from the JAX package.

The JAX package's ``SortConfig`` and ``PreparedSort`` arrive as plain data
(a dict of fields, numpy arrays), so this module imports nothing of it. A
test can then run the reference's prepare stage, carry its state across,
and hold the port's route stage (Ph4–Ph6) alone against the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from .types import PreparedSort, SortConfig, resolve_device

#: the JAX package's host-side handles, which the port has no use for
_HOST_HANDLES = ("obs", "chaos")


def config_from_reference(fields: Mapping) -> SortConfig:
    """A port ``SortConfig`` from the reference config's fields as a dict."""
    names = {f.name for f in dataclasses.fields(SortConfig)}
    kwargs = {}
    for key, value in fields.items():
        if key in _HOST_HANDLES:
            if value is not None:
                raise ValueError(f"the port has no {key!r} handle; pass {key}=None")
            continue
        if key not in names:
            raise ValueError(f"unknown SortConfig field {key!r}")
        kwargs[key] = value
    return SortConfig(**kwargs)


def _tensor(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def prepared_from_reference(xs, vals: Sequence, splits, device=None) -> PreparedSort:
    """A port ``PreparedSort`` from the reference's arrays (global layout).

    xs (p, n_per_proc); vals a sequence of (p, n_per_proc, ...) payloads;
    splits the det (keys, procs, idxs) splitters, each (p, p-1), or the
    radix route's counted ``(bounds,)``, (p, p+1).
    """
    dev = resolve_device(device)
    return PreparedSort(
        xs=_tensor(xs, dev),
        vals=tuple(_tensor(v, dev) for v in vals),
        splits=None if splits is None else tuple(_tensor(s, dev) for s in splits),
    )
