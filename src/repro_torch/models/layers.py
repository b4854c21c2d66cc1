"""Shared transformer building blocks (pure functions over parameter tensors).

The port of the JAX package's ``repro.models.layers``. Where the reference
stacks every per-layer leaf along a leading ``L`` dimension for one
``lax.scan``, the port keeps one set of tensors per layer (an
``nn.ParameterDict`` per block, see ``models/lm.py``) and loops. Compute
dtype is the config's (bfloat16 by default) with float32 in norms, softmax
and loss; every cast sits where the reference has it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig


def dtype_of(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ------------------------------------------------------------------- init
class MetaGenerator:
    """The generator of an init on the ``meta`` device, which has no
    ``torch.Generator``: a device and no state. The init functions draw
    from it as from a generator and get tensors with shapes and dtypes
    only (``Model.param_shapes``)."""

    device = torch.device("meta")


def _dense(gen: torch.Generator, shape, scale_dim: int, dtype: torch.dtype) -> torch.Tensor:
    draw = None if isinstance(gen, MetaGenerator) else gen
    x = torch.randn(shape, generator=draw, dtype=torch.float32, device=gen.device)
    return (x / math.sqrt(scale_dim)).to(dtype)


def init_attn(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = dtype_of(cfg)
    return {
        "wq": _dense(gen, (D, H * hd), D, dt),
        "wk": _dense(gen, (D, KV * hd), D, dt),
        "wv": _dense(gen, (D, KV * hd), D, dt),
        "wo": _dense(gen, (H * hd, D), H * hd, dt),
    }


def init_mlp(gen: torch.Generator, cfg: ArchConfig, d_ff: Optional[int] = None) -> Dict[str, torch.Tensor]:
    D = cfg.d_model
    Fd = d_ff if d_ff is not None else cfg.d_ff
    dt = dtype_of(cfg)
    return {
        "w_gate": _dense(gen, (D, Fd), D, dt),
        "w_up": _dense(gen, (D, Fd), D, dt),
        "w_down": _dense(gen, (Fd, D), Fd, dt),
    }


# ---------------------------------------------------------------- normals
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def swiglu(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p["w_down"]


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, the lower index
    first among equal values: ``lax.top_k``'s order, which ``torch.topk``
    does not promise on CUDA."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# -------------------------------------------------------------------- rope
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = positions.float()[..., None] * freqs  # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10_000.0 ** (dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :d]


# -------------------------------------------------------------------- loss
def next_token_loss(
    logits: torch.Tensor, labels: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Mean cross-entropy; logits (B, S, V), labels (B, S)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
