"""Prefill and decode step factories: the serving-side equivalents of
``train.make_train_step``, used by the dry-run.

The port of the JAX package's ``repro.launch.steps`` for one device. The
reference wraps each step in ``jax.jit`` with explicit shardings; the port
runs eagerly, so without a mesh a factory returns a plain function that
calls the model. A mesh (the reference's sharded steps) waits for the
DeviceMesh/DTensor half of the mesh port.
"""
from __future__ import annotations

from typing import Optional

from ..models import Model


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the port's serving steps have no mesh path yet: the sharded steps wait for the "
            "DeviceMesh/DTensor half of the mesh port (ROADMAP.md, queue 1 item 6)"
        )


def make_prefill_step(model: Model, mesh, cache_len: int, batch_shapes=None):
    """``batch -> (cache, last logits)``: ``model.prefill`` at ``cache_len``.
    ``batch_shapes`` only sanitizes the reference's shardings; without a
    mesh it changes nothing."""
    _no_mesh(mesh)

    def fn(batch):
        return model.prefill(batch, cache_len=cache_len)

    return fn


def make_decode_step(model: Model, mesh, batch: Optional[int], cache_len: int):
    """``(cache, token) -> (logits, cache)``: ``model.decode_step``, the
    cache updated in place (the reference donates it). ``batch`` and
    ``cache_len`` size the reference's cache shardings; without a mesh
    they change nothing."""
    _no_mesh(mesh)

    def fn(cache, token):
        return model.decode_step(cache, token)

    return fn
