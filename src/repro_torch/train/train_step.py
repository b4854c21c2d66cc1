"""Training step: loss → gradients → (optional accumulation) → AdamW.

The port of the JAX package's ``repro.train.train_step``. The reference
differentiates ``Model.train_loss`` with ``jax.value_and_grad``; the port
runs it forward under autograd and takes ``torch.autograd.grad`` of the
loss with respect to the model's parameters. With ``cfg.microbatches > 1``
the batch splits along its first dimension and the gradients sum in
``grad_accum_dtype``, one microbatch after another (the reference's
``lax.scan``); the sum is divided by the count in float32, the loss
averaged, and the aux terms are the last microbatch's.

``params`` is the model's own parameter dict (``init_all`` returns it):
the step updates those tensors and the optimizer state in place and
returns them, so a caller's loop reads as the reference's
``params, opt, metrics = step(params, opt, batch)``.

On a ``DeviceMesh`` (the reference's sharded step, every rank calling the
step with the same global batch): the parameters are placed by the
sanitized ``param_specs`` (``models.place_model``); each rank computes
the loss of its block of the batch, the whole batch's loss on every rank
(the transformer and hybrid families through their mesh steps; the ssm
and audio families, which the reference trains under ``dp`` only, on
local tensors, their losses averaged over every rank). The gradients are reduced into the optimizer state's
placement (``sspecs``: the parameters' own under ``1d``/``2d``; 2-D
sharded under ``dp``, ZeRO-1), AdamW runs on the shards, and the updated
shards are gathered back into the parameters' own placement.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Mapping, Tuple

import torch

from ..core.types import to_device
from ..models import Model, make_mesh_info, place_model
from ..models import sharding as shd
from ..models.lm import model_axis_size
from ..optim import OptConfig, apply_updates, init_state

#: the families with mesh train steps of their own
_MESH_TRAINED = ("dense", "moe", "vlm", "hybrid")


def _check_mesh(mesh) -> None:
    if mesh is not None and not hasattr(mesh, "mesh_dim_names"):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh, not {type(mesh).__name__}")


def make_loss_fn(model: Model, mesh=None):
    """``batch -> (loss, aux)``: the whole batch's loss on every rank of a
    mesh (each rank given the same global batch)."""
    _check_mesh(mesh)
    if mesh is None:
        return model.train_loss
    mi = make_mesh_info(mesh, model.cfg)
    if model.cfg.family in _MESH_TRAINED:
        return functools.partial(model.train_loss, mesh_info=mi)
    if model.cfg.param_sharding != "dp":
        raise NotImplementedError(f"the {model.cfg.family} family (xlstm, whisper) trains on a mesh under the dp "
                                  f"policy only, as the reference trains it, not under {model.cfg.param_sharding}")
    ms = _DataParallel(model, mi)
    return ms.loss


class _DataParallel:
    """A family without mesh steps of its own under the ``dp`` policy: each
    rank runs the one-device loss on its rows of the batch (split over the
    sanitized prefix of the data axes that divides it), and the mean over
    those ranks (equal rows each) is the whole batch's, its backward 1/n of
    the gradient to every rank; ranks along the other data axes hold the
    same rows, and each passes back its share of their gradient."""

    def __init__(self, model: Model, mi) -> None:
        from ..core.primitives import GroupProcs

        self.model, self.mi = model, mi
        self.procs = {a: GroupProcs.from_mesh(mi.mesh, a) for a in mi.data_axes}

    def loss(self, batch: Mapping):
        mesh, axes = self.mi.mesh, tuple(self.mi.data_axes)
        b = next(iter(batch.values())).shape[0]
        entry = shd.sanitize_specs(mesh, shd.Spec(axes), torch.empty((b,), device="meta"))[0]
        split = shd.axes_of(entry)
        rows = shd.local_block(mesh, shd.Spec(entry), (b,))[0]
        loss, aux = self.model.train_loss({k: v[rows] for k, v in batch.items()})
        for a in split:
            loss = shd.psum(loss, self.procs[a])
        loss = loss / shd.axis_size(mesh, split or None)
        r = math.prod(self.procs[a].p for a in axes if a not in split)
        return (shd.scale_grad(loss, 1.0 / r) if r > 1 else loss), aux


def _check_params(model: Model, params: Mapping[str, torch.Tensor]) -> None:
    own = dict(model.named_parameters())
    if own.keys() != params.keys() or any(params[k] is not p for k, p in own.items()):
        raise ValueError("params must be the model's own parameters (as init_all returns them)")


def train_step(
    model: Model, opt_cfg: OptConfig, params: Dict[str, torch.Tensor], opt_state: Dict, batch: Mapping,
    mesh=None,
) -> Tuple[Dict[str, torch.Tensor], Dict, Dict]:
    """One step: returns ``(params, opt_state, metrics)``; metrics are 0-d
    tensors on the device (``loss``, ``grad_norm``, ``lr``, ``aux_<name>``)."""
    _check_params(model, params)
    if mesh is not None:
        return _MeshUpdate(model, opt_cfg, mesh)(params, opt_state, batch)
    loss_fn = make_loss_fn(model, mesh)
    names, leaves = list(params), list(params.values())

    def grads_of(b):
        loss, aux = loss_fn(b)
        g = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return loss.detach(), aux, g

    loss, aux, grads = _accumulate(model, opt_cfg, batch, grads_of)
    opt_state, metrics = apply_updates(opt_cfg, params, dict(zip(names, grads)), opt_state)
    return params, opt_state, _metrics(metrics, loss, aux)


def _accumulate(model: Model, opt_cfg: OptConfig, batch: Mapping, grads_of):
    """``grads_of`` over the microbatches: ``(loss, aux, grads)``, the
    gradients summed in ``grad_accum_dtype`` and divided by the count."""
    mb = max(model.cfg.microbatches, 1)
    if mb == 1:
        return grads_of(batch)
    adt = getattr(torch, opt_cfg.grad_accum_dtype)
    batch = {k: to_device(v, model.device) for k, v in batch.items()}
    micro = {k: v.reshape((mb, v.shape[0] // mb) + tuple(v.shape[1:])) for k, v in batch.items()}
    acc = None
    loss_sum = 0.0
    for i in range(mb):
        loss, aux, g = grads_of({k: v[i] for k, v in micro.items()})
        if acc is None:
            acc = [torch.zeros(gg.shape, dtype=adt, device=gg.device) for gg in g]
        acc = [a + gg.to(adt) for a, gg in zip(acc, g)]
        loss_sum = loss_sum + loss
    count = torch.full((), mb, dtype=torch.float32, device=model.device)
    return loss_sum / count, aux, [(a / count).float() for a in acc]


def _metrics(metrics: Dict, loss, aux) -> Dict:
    metrics["loss"] = loss
    for k, v in (aux or {}).items():
        metrics[f"aux_{k}"] = v.detach()
    return metrics


def state_specs(model: Model, mesh) -> Dict[str, shd.Spec]:
    """The optimizer state's sanitized specs: the parameters' own, 2-D
    sharded under the ``dp`` policy (ZeRO-1, the reference's ``sspecs``)."""
    cfg = model.cfg
    scfg = dataclasses.replace(cfg, param_sharding="2d") if cfg.param_sharding == "dp" else cfg
    shapes = dict(model.named_parameters())
    return shd.sanitize_specs(mesh, shd.param_specs(scfg, shapes, model_axis_size(mesh)), shapes)


def _replicas(mesh, spec: shd.Spec) -> int:
    """How many ranks of ``mesh`` hold the same block of a tensor placed by
    ``spec``."""
    used = {a for e in spec for a in shd.axes_of(e)}
    return shd.axis_size(mesh, tuple(a for a in shd.axis_names(mesh) if a not in used) or None)


class _MeshUpdate:
    """One mesh step (see the module docstring)."""

    def __init__(self, model: Model, opt_cfg: OptConfig, mesh) -> None:
        place_model(model, mesh)
        self.model, self.opt_cfg, self.mesh = model, opt_cfg, mesh
        self.sspecs = state_specs(model, mesh)
        self.splace = {k: shd.to_placements(mesh, s) for k, s in self.sspecs.items()}
        self.replicas = {k: _replicas(mesh, s) for k, s in self.sspecs.items()}
        self.procs = [shd.axis_procs(mesh, a) for a in shd.axis_names(mesh)]
        self.loss_fn = make_loss_fn(model, mesh)

    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``t`` in the state's placement: a view of the
        local tensor of a parameter placed so, else a view of a full one."""
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            if list(t.placements) != self.splace[name]:
                raise ValueError(f"{name}: placed {t.placements}, the state {self.splace[name]}")
            return t.to_local()
        return t[shd.local_block(self.mesh, self.sspecs[name], t.shape)]

    def grad_shard(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """A gradient (a ``DTensor`` of partial sums and shards, or this
        rank's plain contribution: a partial sum over every axis) reduced
        into the state's placement, axis by axis: its shard."""
        from torch.distributed.tensor import DTensor, Partial, Shard

        src = list(g.placements) if isinstance(g, DTensor) else [Partial()] * self.mesh.ndim
        local = g.to_local() if isinstance(g, DTensor) else g
        for procs, s, t in zip(self.procs, src, self.splace[name]):
            if s == t:
                continue
            if s.is_partial() and t.is_replicate():
                local = procs.all_reduce(local)
            elif s.is_partial() and isinstance(t, Shard):
                local = shd.reduce_scatter(local, procs, t.dim)
            elif s.is_replicate() and isinstance(t, Shard):
                local = shd.chunk(local, procs, t.dim)
            else:
                raise ValueError(f"{name}: no reduction from {s} to {t}")
        return local

    def state(self, opt_state: Dict) -> Dict:
        """``opt_state`` with ``m`` and ``v`` as ``DTensor``s in the state's
        placement (full tensors, as ``init_state`` or a restore without
        placements gives them, are cut to this rank's block)."""
        from torch.distributed.tensor import DTensor

        def placed(k, t):
            return t if isinstance(t, DTensor) else shd.place(t, self.mesh, self.sspecs[k])

        return {"m": {k: placed(k, t) for k, t in opt_state["m"].items()},
                "v": {k: placed(k, t) for k, t in opt_state["v"].items()}, "step": opt_state["step"]}

    def __call__(self, params: Dict, opt_state: Dict, batch: Mapping):
        from torch.distributed.tensor import DTensor

        state = self.state(opt_state)
        names, leaves = list(params), list(params.values())

        def grads_of(b):
            loss, aux = self.loss_fn(b)
            g = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            return loss.detach(), aux, [self.grad_shard(k, gg) for k, gg in zip(names, g)]

        loss, aux, grads = _accumulate(self.model, self.opt_cfg, batch, grads_of)
        with torch.no_grad():
            shards = {k: self.shard(k, p.detach()) for k, p in params.items()}
            local = {"m": {k: t.to_local() for k, t in state["m"].items()},
                     "v": {k: t.to_local() for k, t in state["v"].items()}, "step": state["step"]}
            new, metrics = apply_updates(self.opt_cfg, shards, dict(zip(names, grads)), local,
                                         replicas=self.replicas, groups=[p.group for p in self.procs])
            for k, p in params.items():  # the dp policy's replicas: gather the updated blocks
                if not isinstance(p, DTensor):
                    full = DTensor.from_local(shards[k], self.mesh, self.splace[k], run_check=False,
                                              shape=p.shape, stride=p.stride())
                    p.copy_(shd.full(full))
        out = {"m": state["m"], "v": state["v"], "step": new["step"]}
        return params, out, _metrics(metrics, loss, aux)


def make_train_step(model: Model, opt_cfg: OptConfig, mesh=None):
    """The step as a callable ``(params, opt_state, batch) -> (params,
    opt_state, metrics)``. There is no compile step: the port runs eagerly.
    With a mesh the model is placed on it now (``models.place_model``):
    take ``params`` from ``init_all(model, opt_cfg, mesh)``."""
    _check_mesh(mesh)
    if mesh is None:
        return functools.partial(train_step, model, opt_cfg)
    update = _MeshUpdate(model, opt_cfg, mesh)

    def step(params, opt_state, batch):
        _check_params(model, params)
        return update(params, opt_state, batch)

    return step


def init_all(model: Model, opt_cfg: OptConfig, mesh=None):
    """Make ``model`` trainable (its parameters now require grad) and return
    ``(params, opt_state)``: the model's parameters by state-dict name and a
    fresh AdamW state beside them. The weights are the model's own, drawn
    from its seed or given at construction (the reference draws them here
    from its ``rng``); they are copied first, since a step updates them in
    place and a model built from another's tensors would share them. With
    a mesh the model is placed on it first and ``m``, ``v`` are zeros in
    the state's placement."""
    _check_mesh(mesh)
    if mesh is not None:
        place_model(model, mesh)
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.clone()
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    if mesh is None:
        return params, init_state(opt_cfg, params)
    specs = state_specs(model, mesh)
    dt = getattr(torch, opt_cfg.state_dtype)

    def zeros(k, p):
        return shd.place(torch.zeros(p.shape, dtype=dt, device=model.device), mesh, specs[k])

    return params, {"m": {k: zeros(k, p) for k, p in params.items()},
                    "v": {k: zeros(k, p) for k, p in params.items()},
                    "step": torch.zeros((), dtype=torch.int32, device=model.device)}
