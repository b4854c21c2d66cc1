"""Training step: loss → gradients → (optional accumulation) → AdamW.

The port of the JAX package's ``repro.train.train_step`` on one device.
The reference differentiates ``Model.train_loss`` with
``jax.value_and_grad``; the port runs it forward under autograd and takes
``torch.autograd.grad`` of the loss with respect to the model's
parameters. With ``cfg.microbatches > 1`` the batch splits along its first
dimension and the gradients sum in ``grad_accum_dtype``, one microbatch
after another (the reference's ``lax.scan``); the sum is divided by the
count in float32, the loss averaged, and the aux terms are the last
microbatch's.

``params`` is the model's own parameter dict (``init_all`` returns it):
the step updates those tensors and the optimizer state in place and
returns them, so a caller's loop reads as the reference's
``params, opt, metrics = step(params, opt, batch)``. A mesh (the
reference's sharded step) waits for the port's ``torch.distributed``
runner.
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping, Tuple

import torch

from ..core.types import to_device
from ..models import Model
from ..optim import OptConfig, apply_updates, init_state


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the port's train step has no mesh path yet: the sharded step waits for the "
            "DeviceMesh/DTensor half of the mesh port (ROADMAP.md, queue 1 item 6)"
        )


def make_loss_fn(model: Model, mesh=None):
    _no_mesh(mesh)

    def loss_fn(batch):
        return model.train_loss(batch)

    return loss_fn


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
    loss_fn = make_loss_fn(model, mesh)
    names, leaves = list(params), list(params.values())
    mb = max(model.cfg.microbatches, 1)

    def grads_of(b):
        loss, aux = loss_fn(b)
        g = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        return loss.detach(), aux, g

    if mb == 1:
        loss, aux, grads = grads_of(batch)
    else:
        adt = getattr(torch, opt_cfg.grad_accum_dtype)
        batch = {k: to_device(v, model.device) for k, v in batch.items()}
        micro = {k: v.reshape((mb, v.shape[0] // mb) + tuple(v.shape[1:])) for k, v in batch.items()}
        acc = [torch.zeros(p.shape, dtype=adt, device=p.device) for p in leaves]
        loss_sum = 0.0
        for i in range(mb):
            loss, aux, g = grads_of({k: v[i] for k, v in micro.items()})
            acc = [a + gg.to(adt) for a, gg in zip(acc, g)]
            loss_sum = loss_sum + loss
        count = torch.full((), mb, dtype=torch.float32, device=model.device)
        grads = [(a / count).float() for a in acc]
        loss = loss_sum / count
    opt_state, metrics = apply_updates(opt_cfg, params, dict(zip(names, grads)), opt_state)
    metrics["loss"] = loss
    for k, v in (aux or {}).items():
        metrics[f"aux_{k}"] = v.detach()
    return params, opt_state, metrics


def make_train_step(model: Model, opt_cfg: OptConfig, mesh=None):
    """The step as a callable ``(params, opt_state, batch) -> (params,
    opt_state, metrics)``. There is no compile step: the port runs eagerly."""
    _no_mesh(mesh)
    return functools.partial(train_step, model, opt_cfg)


def init_all(model: Model, opt_cfg: OptConfig):
    """Make ``model`` trainable (its parameters now require grad) and return
    ``(params, opt_state)``: the model's parameters by state-dict name and a
    fresh AdamW state beside them. The weights are the model's own, drawn
    from its seed or given at construction (the reference draws them here
    from its ``rng``); they are copied first, since a step updates them in
    place and a model built from another's tensors would share them."""
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.clone()
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    return params, init_state(opt_cfg, params)
