"""Decoder-only transformer LM (families: dense, moe, vlm).

The port of the JAX package's ``repro.models.transformer`` on one device:
pre-norm GQA attention with RoPE, SwiGLU or MoE MLP, optional sliding
window (mixtral). The VLM family receives stub patch embeddings that
overwrite the first ``vision_tokens`` positions.

``params`` is a :class:`repro_torch.models.Model` (or anything with its
``embed``, ``layers``, ``final_norm`` and ``lm_head``): ``layers[i]`` maps
the reference's leaf names (``wq``, ``w_gate``, ``router``, ...) to layer
i's tensors. The reference scans over stacked layers; the port loops.

Three entry points per the shape kinds: ``forward_train`` (full logits →
loss; with ``cfg.remat`` each block is rematerialized in the backward
pass, the reference's ``jax.checkpoint``), ``prefill`` (build KV cache,
last-position logits), ``decode_step`` (one token through the cache).
A cache is ``{"k", "v": (L, B, S_max, KV, hd), "pos"}``; ``pos`` is a
scalar (every row at one position, the reference's ``decode_step``) or one
position per row: B independent lanes, as the reference's engine decodes
its slots under ``jax.vmap`` (each lane's MoE then has its own capacity).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import attention as attn
from . import moe as moe_mod
from .layers import _dense, dtype_of, init_attn, init_mlp, next_token_loss, rmsnorm, rope


def stacks(cfg: ArchConfig) -> Dict[str, int]:
    """The model's stacked containers and their lengths."""
    return {"layers": cfg.n_layers}


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random parameters on the generator's device, by state-dict name
    (``embed``, ``layers.<i>.<leaf>``, ``final_norm``, ``lm_head``)."""
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab
    dt, dev = dtype_of(cfg), gen.device
    out = {"embed": _dense(gen, (V, D), D, dt)}
    for i in range(L):
        layer = {"attn_norm": torch.ones((D,), dtype=dt, device=dev),
                 "mlp_norm": torch.ones((D,), dtype=dt, device=dev), **init_attn(gen, cfg)}
        layer.update(moe_mod.init_moe(gen, cfg) if cfg.moe_experts else init_mlp(gen, cfg))
        out.update({f"layers.{i}.{leaf}": t for leaf, t in layer.items()})
    out["final_norm"] = torch.ones((D,), dtype=dt, device=dev)
    out["lm_head"] = _dense(gen, (D, V), D, dt)
    return out


def _attention_block(cfg, lp, h, positions, *, window):
    b, s, D = h.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (h @ lp["wq"]).reshape(b, s, H, hd)
    k = (h @ lp["wk"]).reshape(b, s, KV, hd)
    v = (h @ lp["wv"]).reshape(b, s, KV, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if s > 1:
        o = attn.flash_attention(q, k, v, causal=True, window=window)
    else:
        o = attn.reference_attention(q, k, v, causal=True, window=window)
    o = o.reshape(b, s, H * hd) @ lp["wo"]
    return o, (k, v)


def _mlp_block(cfg, lp, h, mesh_info=None, lanes: int = 1):
    """SwiGLU, or the MoE layer (``lanes``: see ``moe._grouped_gemm_moe``).
    ``mesh_info`` must be ``None`` or a mesh-less ``MoEMeshInfo``."""
    if not cfg.moe_experts:
        g = h @ lp["w_gate"]
        u = h @ lp["w_up"]
        hh = torch.nn.functional.silu(g.float()).to(h.dtype) * u
        return hh @ lp["w_down"], {}
    moe_params = {k: lp[k] for k in ("router", "w_gate", "w_up", "w_down")}
    return moe_mod.moe_tp(moe_params, h, cfg, lanes=lanes)


def _block_train(cfg, mesh_info, x, lp, positions):
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    o, _ = _attention_block(cfg, lp, h, positions, window=cfg.sliding_window)
    x = x + o
    h2 = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
    y, aux = _mlp_block(cfg, lp, h2, mesh_info)
    return x + y, aux


def _embed(cfg, params, tokens, extras):
    # an embedding lookup, not an index: its backward sums each row's
    # gradients in a fixed order on every device (the index's adds them by
    # atomics on the CPU's threads), so a train step is deterministic
    x = torch.nn.functional.embedding(tokens.long(), params.embed)  # (B, S, D)
    if cfg.family == "vlm" and extras.get("patch_embeds") is not None:
        pe = extras["patch_embeds"].to(x.dtype)  # (B, vt, D)
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    return x


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def forward_train(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    mesh_info=None,
    extras: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Dict]:
    extras = extras or {}
    b, s = tokens.shape
    x = _embed(cfg, params, tokens, extras)
    positions = _positions(b, s, x.device)
    # rematerialized: a block keeps only its input for the backward pass and
    # runs again there; the recompute makes the forward's routing decisions
    # (the dispatch sort is stable, the ops deterministic)
    remat = cfg.remat and torch.is_grad_enabled()
    auxs = []
    for lp in params.layers:
        if remat:
            x, aux = checkpoint(_block_train, cfg, mesh_info, x, lp, positions,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = _block_train(cfg, mesh_info, x, lp, positions)
        auxs.append(aux)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = x @ params.lm_head
    mask = None
    if cfg.family == "vlm":
        mask = (torch.arange(s, device=x.device) >= cfg.vision_tokens)[None, :] * torch.ones((b, 1), device=x.device)
    loss = next_token_loss(logits[:, :-1], labels[:, 1:], None if mask is None else mask[:, 1:])
    aux = {}
    if auxs and auxs[0]:
        aux = {k: (torch.stack([a[k] for a in auxs]).sum() if k != "overflow"
                   else torch.stack([a[k] for a in auxs]).any()) for k in auxs[0]}
    if cfg.moe_experts:
        loss = loss + 0.01 * aux.get("lb_loss", 0.0) + 1e-3 * aux.get("z_loss", 0.0)
    return loss, aux


# ------------------------------------------------------------------ serve
def prefill(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,
    mesh_info=None,
    extras: Optional[Dict] = None,
    cache_len: Optional[int] = None,
) -> Tuple[Dict, torch.Tensor]:
    """Run the prompt, build the KV cache. Returns (cache, last logits)."""
    extras = extras or {}
    b, s = tokens.shape
    cache_len = cache_len or s
    x = _embed(cfg, params, tokens, extras)
    positions = _positions(b, s, x.device)
    shape = (cfg.n_layers, b, cache_len, cfg.n_kv_heads, cfg.hd)
    kcache = torch.zeros(shape, dtype=x.dtype, device=x.device)
    vcache = torch.zeros(shape, dtype=x.dtype, device=x.device)
    for i, lp in enumerate(params.layers):
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        o, (k, v) = _attention_block(cfg, lp, h, positions, window=cfg.sliding_window)
        x = x + o
        h2 = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        y, _ = _mlp_block(cfg, lp, h2, mesh_info)
        x = x + y
        kcache[i, :, :s] = k
        vcache[i, :, :s] = v
    x = rmsnorm(x[:, -1:], params.final_norm, cfg.norm_eps)
    logits = (x @ params.lm_head)[:, 0]
    pos = torch.full((), s - 1, dtype=torch.int32, device=x.device)
    return {"k": kcache, "v": vcache, "pos": pos}, logits


def decode_step(
    cfg: ArchConfig,
    params,
    cache: Dict,
    token: torch.Tensor,  # (B,) previous token
    mesh_info=None,
) -> Tuple[torch.Tensor, Dict]:
    """One autoregressive step; ``cache['pos']`` is the last filled position
    (a scalar, or one per lane). The cache's K/V are updated in place."""
    b = token.shape[0]
    pos = cache["pos"] + 1  # position of the new token
    lanes = b if pos.dim() == 1 else 1
    x = params.embed[token.long()][:, None, :]  # (B,1,D)
    positions = pos.expand(b)[:, None] if pos.dim() == 0 else pos[:, None]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    for i, lp in enumerate(params.layers):
        kc, vc = cache["k"][i], cache["v"][i]
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q = (h @ lp["wq"]).reshape(b, 1, H, hd)
        k = (h @ lp["wk"]).reshape(b, 1, KV, hd)
        v = (h @ lp["wv"]).reshape(b, 1, KV, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        attn.cache_update(kc, vc, k, v, pos)
        o = attn.decode_attention(q, kc, vc, pos, window=cfg.sliding_window)
        x = x + o.reshape(b, 1, H * hd) @ lp["wo"]
        h2 = rmsnorm(x, lp["mlp_norm"], cfg.norm_eps)
        y, _ = _mlp_block(cfg, lp, h2, mesh_info, lanes=lanes)
        x = x + y
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = (x @ params.lm_head)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos}


def cache_shapes(cfg: ArchConfig, batch: int, cache_len: int) -> Dict[str, torch.Tensor]:
    """The cache's tensors on the ``meta`` device (shapes and dtypes, no memory)."""
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.hd)
    dt = dtype_of(cfg)
    return {
        "k": torch.empty(shape, dtype=dt, device="meta"),
        "v": torch.empty(shape, dtype=dt, device="meta"),
        "pos": torch.empty((), dtype=torch.int32, device="meta"),
    }
