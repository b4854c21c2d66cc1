"""AdamW with global-norm clipping, cosine schedule and a configurable
state dtype.

The port of the JAX package's ``repro.optim.adamw`` on one device, as plain
functions on dicts of tensors keyed by the model's state-dict names
(``embed``, ``layers.<i>.<leaf>``, ``final_norm``, ``lm_head``; the
recurrent families' in ``models.lm``). The state is ``{"m", "v",
"step"}``: ``m`` and ``v`` in ``state_dtype`` (bfloat16 for the 398B
jamba config, with float32 step math), ``step`` an int32 scalar on the
parameters' device.

``apply_updates`` writes the new parameters and moments in place under
``torch.no_grad()``, the port's form of the reference's donated buffers.
The schedule, the clip scale and the bias corrections stay 0-d float32
tensors on the device, computed as the reference computes them from its
int32 step: no host read a step, and no float64 Python arithmetic that
would move a float32 update by an ulp.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    state_dtype: str = "float32"  # "bfloat16" for the 398B config
    grad_accum_dtype: str = "float32"


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float32 scalar on ``like``'s device. Dividing by it is a
    true division on every device; CUDA divides by a Python scalar as a
    product with its reciprocal, an ulp off the reference's quotient. A
    fill, not a copy from the host: a blocking copy would wait for the
    backward pass queued before it."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac``; ``step`` an
    integer tensor, the result float32 on its device."""
    s = step.float()
    warm = torch.clamp(s / _f32(max(cfg.warmup_steps, 1), s), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps) / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), s), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_state(cfg: OptConfig, params: Mapping[str, torch.Tensor]) -> Dict:
    dt = getattr(torch, cfg.state_dtype)
    dev = next(iter(params.values())).device
    return {
        "m": {k: torch.zeros(p.shape, dtype=dt, device=p.device) for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _tree_order(names) -> list:
    """``names`` in the reference's tree order, as ``jax.tree.flatten``
    orders a nested dict: its keys sorted at every level, a stacked leaf's
    slices (``layers.<i>.<leaf>``, ``blocks.<b>.mamba.<slot>.<leaf>``)
    together in index order."""

    def key(name: str):
        segs = name.split(".")
        return (tuple(s for s in segs if not s.isdigit()), tuple(int(s) for s in segs if s.isdigit()))

    return sorted(names, key=key)


def global_norm(tree: Mapping[str, torch.Tensor], replicas: Optional[Mapping[str, int]] = None,
                groups: Sequence = ()) -> torch.Tensor:
    """sqrt of the float32 sum of squares, summed leaf by leaf in the
    reference's tree order. The reference reduces each stacked (L, ...) leaf
    at once where the port adds its L layers' sums, so the last bits may
    differ.

    On a mesh ``tree`` holds this rank's shards: ``replicas[k]`` is the
    number of ranks that hold the same shard of leaf k (its sum is divided
    by it, exactly: the counts are powers of two here) and the sum is
    all-reduced over each process group of ``groups`` (the mesh's axes)."""
    if replicas is None:
        sq = sum(torch.sum(torch.square(tree[k].float())) for k in _tree_order(tree))
        return torch.sqrt(sq)
    import torch.distributed as dist

    sq = sum(torch.sum(torch.square(tree[k].float())) / replicas[k] for k in _tree_order(tree))
    for g in groups:
        dist.all_reduce(sq, group=g)
    return torch.sqrt(sq)


@torch.no_grad()
def apply_updates(
    cfg: OptConfig, params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor], state: Dict,
    replicas: Optional[Mapping[str, int]] = None, groups: Sequence = (),
) -> Tuple[Dict, Dict]:
    """One AdamW step, in place on ``params`` and the state's moments.
    Returns ``(state, metrics)`` with ``grad_norm`` and ``lr``. On a mesh
    (ZeRO-1) every tensor is this rank's shard, and ``replicas`` and
    ``groups`` make the clip norm the whole tree's (:func:`global_norm`)."""
    step = state["step"] + 1
    gnorm = global_norm(grads, replicas, groups)
    scale = torch.clamp(_f32(cfg.clip_norm, gnorm) / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.betas
    sf = step.float()
    bc1 = 1 - torch.pow(_f32(b1, sf), sf)
    bc2 = 1 - torch.pow(_f32(b2, sf), sf)
    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        gf = grads[k].float() * scale
        mf = b1 * m.float() + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * gf * gf
        mhat = mf / bc1
        vhat = vf / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(mf)
        v.copy_(vf)
    return {"m": state["m"], "v": state["v"], "step": step}, {"grad_norm": gnorm, "lr": lr}
