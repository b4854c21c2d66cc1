"""Prefill and decode step factories: the serving-side equivalents of
``train.make_train_step``, used by the dry-run.

The port of the JAX package's ``repro.launch.steps``. The reference wraps
each step in ``jax.jit`` with explicit shardings; the port runs eagerly.
Without a mesh a factory returns a plain function that calls the model.
With a ``DeviceMesh`` the model is placed on it now (its parameters by
the sanitized ``param_specs``, ``models.place_model``), and each call
places what it is given, every rank passing the same global tensors: the
batch and the token by their sanitized ``batch_specs`` (each rank takes
its rows) and a full cache by the sanitized ``cache_specs`` (a cache that
prefill returned is placed already). Decode updates the cache's local
blocks in place, the reference's donation; the logits come back as one
full tensor on every rank, the reference's ``out_shardings=(None, ...)``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models import Model, make_mesh_info, place_model
from ..models import sharding as shd


def _placed(model: Model, mesh):
    if mesh is None:
        return None
    if not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, not {type(mesh).__name__}")
    place_model(model, mesh)
    return make_mesh_info(mesh, model.cfg)


def make_prefill_step(model: Model, mesh, cache_len: int, batch_shapes=None):
    """``batch -> (cache, last logits)``: ``model.prefill`` at ``cache_len``.
    ``batch_shapes`` names the batch's keys, as the reference's sanitized
    shardings do; each rank cuts its rows of any batch it is given."""
    del batch_shapes
    mi = _placed(model, mesh)

    def fn(batch):
        return model.prefill(batch, mi, cache_len=cache_len)

    return fn


def place_cache(model: Model, mesh, cache):
    """A full cache (every rank the same tensors) placed by its sanitized
    ``cache_specs``; ``DTensor`` leaves and ``pos`` are kept."""
    from torch.distributed.tensor import DTensor

    specs = shd.sanitize_specs(mesh, shd.cache_specs(model.cfg, mesh, cache), cache)

    def put(spec, t):
        if isinstance(t, DTensor) or t.dim() == 0:
            return t
        return shd.place(t, mesh, spec)

    return shd.tree_map(put, specs, cache)


def make_decode_step(model: Model, mesh, batch: Optional[int], cache_len: int):
    """``(cache, token) -> (logits, cache)``: ``model.decode_step``, the
    cache updated in place (the reference donates it). ``batch`` and
    ``cache_len`` size the reference's cache shardings; the port reads
    them from the cache it is given."""
    del batch, cache_len
    mi = _placed(model, mesh)

    def fn(cache, token):
        if mesh is not None:
            cache = place_cache(model, mesh, cache)
        return model.decode_step(cache, torch.as_tensor(token), mi)

    return fn
