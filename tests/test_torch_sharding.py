"""``models/sharding.py`` against the JAX package's ``repro.models.sharding``.

For every registered arch at full width, on the (data 16, model 16),
(pod 2, data 16, model 16) and (data 2, model 4) meshes, under the arch's
own policy and under ``dp``, ``1d`` and ``2d`` overrides: the parameter
specs (the port's ``Model(cfg, device="meta")`` names and shapes against
the reference's ``param_shapes()`` tree, each port leaf holding its
stacked leaf's spec without the stacked dimensions), raw and sanitized;
the batch specs of the train, prefill and decode kinds, sanitized by the
inputs of every shape (``long_500k``'s batch of 1 among them); the cache specs,
sanitized by the decode cache's shapes; and ``dp_axes``. The reference's
functions get a stub mesh with ``.shape`` and ``.axis_names``, the port's
one with ``.shape`` and ``.mesh_dim_names``, so no device is needed.
Tolerance: exact.
"""
from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace

import pytest

from test_torch_harness import ref_lm

MESHES = {"16x16": (("data", "model"), (16, 16)), "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x4": (("data", "model"), (2, 4))}
POLICIES = ("own", "dp", "1d", "2d")


def _archs():
    from repro_torch.configs import all_archs

    return list(all_archs())


def _meshes(name):
    axes, shape = MESHES[name]
    ref = SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
    return ref, SimpleNamespace(mesh_dim_names=axes, shape=shape)


def _norm(spec) -> tuple:
    """A spec's entries, a one-name tuple read as the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else (tuple(e) if isinstance(e, tuple) else e)
                 for e in spec)


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch: str):
    r = ref_lm()
    model = r.models.Model(r.configs.get_arch(arch))
    return model.param_shapes()


def _ref_leaf(tree, port_name: str):
    node = tree
    for seg in port_name.split("."):
        if not seg.isdigit():
            node = node[seg]
    return node


def _cfgs(arch: str, policy: str):
    from repro_torch.configs import get_arch

    r = ref_lm()
    rcfg, cfg = r.configs.get_arch(arch), get_arch(arch)
    if policy != "own":
        rcfg, cfg = (dataclasses.replace(c, param_sharding=policy) for c in (rcfg, cfg))
    return rcfg, cfg


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", _archs())
def test_specs_equal_the_reference(arch, mesh_name, policy):
    import jax

    from repro_torch.configs import SHAPES
    from repro_torch.models import Model
    from repro_torch.models import sharding as shd

    r = ref_lm()
    rshd = __import__("repro.models.sharding", fromlist=["x"])
    rmesh, mesh = _meshes(mesh_name)
    rcfg, cfg = _cfgs(arch, policy)
    msize = rmesh.shape["model"]

    # parameters: raw and sanitized, leaf by leaf
    rshapes = _ref_shapes(arch)
    rspecs = rshd.param_specs(rcfg, rshapes, msize)
    rsane = rshd.sanitize_specs(rmesh, rspecs, rshapes)
    shapes = Model.param_shapes(cfg)
    specs = shd.param_specs(cfg, shapes, msize)
    sane = shd.sanitize_specs(mesh, specs, shapes)
    n_leaves = len(jax.tree.leaves(rshapes))
    assert n_leaves and shapes
    for name, t in shapes.items():
        depth = sum(seg.isdigit() for seg in name.split("."))
        want_shape = _ref_leaf(rshapes, name).shape
        assert tuple(t.shape) == tuple(want_shape[depth:]), name
        for got, want in ((specs[name], _ref_leaf(rspecs, name)), (sane[name], _ref_leaf(rsane, name))):
            want = _norm(want) + (None,) * (len(want_shape) - len(want))
            assert all(e is None for e in want[:depth]), (name, want)
            assert _norm(got) == want[depth:], (name, got, want)

    # dp axes, batches (sanitized by the shapes' inputs) and caches
    assert shd.dp_axes(mesh, cfg) == tuple(rshd.dp_axes(rmesh, rcfg))
    assert shd.dp_axes(mesh) == tuple(rshd.dp_axes(rmesh))
    rmodel = r.models.Model(rcfg)
    model = Model(cfg, device="meta")
    for shape in SHAPES.values():
        kind = shape.kind
        rb, b = rshd.batch_specs(rcfg, rmesh, kind), shd.batch_specs(cfg, mesh, kind)
        assert {k: _norm(v) for k, v in b.items()} == {k: _norm(v) for k, v in rb.items()}, kind
        rin, pin = rmodel.input_specs(shape), model.input_specs(shape)
        keys = [k for k in pin if k in b]
        rs = rshd.sanitize_specs(rmesh, {k: rb[k] for k in keys}, {k: rin[k] for k in keys})
        ps = shd.sanitize_specs(mesh, {k: b[k] for k in keys}, {k: pin[k] for k in keys})
        assert {k: _norm(v) for k, v in ps.items()} == {k: _norm(v) for k, v in rs.items()}, kind
    rc, pc = rmodel.cache_shapes(128, 32768), model.cache_shapes(128, 32768)
    for sanitize in (False, True):
        rcs = rshd.cache_specs(rcfg, rmesh, rc)
        pcs = shd.cache_specs(cfg, mesh, pc)
        if sanitize:
            rcs, pcs = rshd.sanitize_specs(rmesh, rcs, rc), shd.sanitize_specs(mesh, pcs, pc)
        assert _flat(pcs, shd.Spec) == _flat(rcs, type(rcs["pos"])), sanitize


def _flat(tree, leaf_type, path=()) -> dict:
    """``{path: normalized spec}`` of a tree of dicts and tuples."""
    if isinstance(tree, leaf_type):
        return {path: _norm(tree)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, leaf_type, path + (k,)))
    return out


def test_place_keeps_only_this_ranks_block():
    """A placed block owns storage of its own size: a block of leading rows
    taken as a view of the full tensor kept the whole of it alive on every
    rank (jamba's float32 cut at d_model 8192 ran out of memory on four
    ranks sharing a card that way). Rank 0 of a fake world of 4."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import fake_world
    from repro_torch.models import sharding as shd

    t = torch.arange(64 * 8, dtype=torch.float32).reshape(64, 8)
    with fake_world(4):
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
        for spec, want in ((shd.Spec("model", None), t[:32]), (shd.Spec(None, "model"), t[:, :4]),
                           (shd.Spec(("data", "model"), None), t[:16]), (shd.Spec(None, None), t)):
            local = shd.place(t, mesh, spec).to_local()
            assert torch.equal(local, want), spec
            assert local.untyped_storage().nbytes() == local.numel() * local.element_size(), spec
