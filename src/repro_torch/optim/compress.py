"""Gradient compression for the cross-pod (DCN) axis.

The port of the JAX package's ``repro.optim.compress``: int8 block-quantized
gradients with error feedback. The residual of each quantization is fed
back into the next step's gradient, so no gradient mass is lost; the
quantizer therefore rounds to nearest, and gives the reference's bytes
(codes and float32 scales). Stochastic rounding takes a
``torch.Generator`` where the reference takes a ``jax.random`` key: its
draws differ, its contract (unbiased, within one code) is the same.
Trees are dicts of tensors keyed by the model's state-dict names.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

BLOCK = 256


def quantize_int8(
    x: torch.Tensor, generator: Optional[torch.Generator] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization: ``(codes (nblocks, BLOCK)
    int8, scales (nblocks,) float32)``.

    Rounds to nearest (half to even) by default; pass ``generator`` for
    stochastic rounding (unbiased per step, double the MSE — only worth it
    without error feedback downstream).
    """
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    # a true division on every device (see ``adamw._f32``)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / torch.full((), 127.0, device=blocks.device)
    scale = torch.clamp(scale, min=1e-12)
    y = blocks / scale
    if generator is not None:
        y = y + torch.rand(y.shape, generator=generator, device=y.device) - 0.5
    q = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def compress_tree(
    grads: Mapping[str, torch.Tensor], errors: Optional[Mapping[str, torch.Tensor]],
    generator: Optional[torch.Generator] = None,
):
    """Apply error feedback then quantize every leaf.

    Returns ``({name: (codes, scales)}, {name: new error})``. The error
    buffer carries each step's exact residual, so nearest rounding is used
    (``generator`` is accepted for the reference's signature but unused).
    """
    del generator
    qs, new_errs = {}, {}
    for k, g in grads.items():
        corrected = g.float() + (errors[k] if errors is not None else 0.0)
        q, s = quantize_int8(corrected)
        qs[k] = (q, s)
        new_errs[k] = corrected - dequantize_int8(q, s, g.shape)
    return qs, new_errs


def decompress_tree(qtree: Mapping[str, Tuple[torch.Tensor, torch.Tensor]],
                    like: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: dequantize_int8(q, s, like[k].shape).to(like[k].dtype) for k, (q, s) in qtree.items()}


def init_errors(grads_shape: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device) for k, g in grads_shape.items()}
