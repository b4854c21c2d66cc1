"""Jamba-style hybrid: Mamba + attention 1:7 interleave, MoE every 2nd layer.

The port of the JAX package's ``repro.models.hybrid`` on one device. Layer
i is attention iff ``i % attn_period == attn_period // 2`` (one per
period), else Mamba; the MLP of slot i is MoE when ``cfg.is_moe_layer(i)``
(i counted within the period), else a dense SwiGLU. The stack is
``n_layers // attn_period`` *super-blocks*, each with (period - 1) Mamba
sub-layers and one attention sub-layer with their MLPs. The reference
scans over super-blocks; the port loops.

``params`` is a :class:`repro_torch.models.Model`: ``params.blocks[b]``
holds super-block b's ``attn`` (``wq``, ``wk``, ``wv``, ``wo``), its
``mamba``, ``dense`` and ``moe`` sub-layers by slot (``mamba[j]`` is the
j-th Mamba sub-layer's dict) and its norms ``attn_norm[i]`` and
``mlp_norm[i]`` by period slot. A config whose ``n_layers`` is below its
``attn_period`` has no super-block: the model is embed → final norm → LM
head, as in the reference (the reduced jamba).

The MoE sub-layers dispatch through ``moe.moe_tp``: the stable sort on
expert id. A decode cache is ``{"k", "v": (blocks, B, S_max, KV, hd),
"mamba": (h (blocks, period-1, B, di, N) float32, conv (blocks, period-1,
B, dk-1, di)), "pos"}``, updated in place; ``pos`` is a scalar or one
position per lane, as in ``models.transformer``.

On a mesh (train, prefill and decode, under every policy) a super-block
runs as the reference's mesh hooks do, made explicit
(``models.transformer._MeshStep``): under ``1d`` and ``2d`` the
Megatron-SP residual (replicated over the model axis where the sequence
does not divide it), the attention's heads split over the model axis
with the cache's sequence split and flash-decode, the MoE slots through
the transformer's four-way choice with the whole batch's aux terms, the
dense MLP column- then row-parallel, and each Mamba slot on this rank's
channels (``ssm.mamba_block(mesh=)``: the sequence gathered first, its
state's channels split as the cache's specs place them). Under ``dp`` the
same steps run the one-device sub-layers on each rank's rows; its decode
step gathers a Mamba state's channels for the step and keeps its own
block of the new one.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import attention as attn
from . import moe as moe_mod
from . import sharding as shd
from . import ssm
from . import transformer as tfm
from .layers import _dense, dtype_of, init_attn, init_mlp, next_token_loss, rmsnorm, rope


def _layout(cfg: ArchConfig) -> Tuple[int, int]:
    period = cfg.attn_period
    return period, cfg.n_layers // period


def stacks(cfg: ArchConfig) -> Dict[str, int]:
    """The model's stacked containers and their lengths."""
    return {"blocks": _layout(cfg)[1]}


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random parameters on the generator's device, by state-dict name
    (``blocks.<b>.attn.<leaf>``, ``blocks.<b>.{mamba,dense,moe}.<slot>.<leaf>``,
    ``blocks.<b>.{attn_norm,mlp_norm}.<i>``, and the top-level leaves)."""
    period, blocks = _layout(cfg)
    D, V = cfg.d_model, cfg.vocab
    dt, dev = dtype_of(cfg), gen.device
    n_moe = sum(1 for i in range(period) if cfg.is_moe_layer(i))
    out = {"embed": _dense(gen, (V, D), D, dt)}
    for b in range(blocks):
        parts = {"attn": init_attn(gen, cfg)}
        for kind, init, count in (("mamba", ssm.init_mamba, period - 1), ("dense", init_mlp, period - n_moe),
                                  ("moe", moe_mod.init_moe, n_moe)):
            for j in range(count):
                parts[f"{kind}.{j}"] = init(gen, cfg)
        for sub, leaves in parts.items():
            out.update({f"blocks.{b}.{sub}.{leaf}": t for leaf, t in leaves.items()})
        for norm in ("attn_norm", "mlp_norm"):
            out.update({f"blocks.{b}.{norm}.{i}": torch.ones((D,), dtype=dt, device=dev) for i in range(period)})
    out["final_norm"] = torch.ones((D,), dtype=dt, device=dev)
    out["lm_head"] = _dense(gen, (D, V), D, dt)
    return out


def _attention(cfg, ap, h, positions, kv=None, pos=None):
    """The attention sub-layer: causal flash attention over the sequence,
    or (``kv`` = this block's caches) one decode step at ``pos``, whose
    K/V are written into the caches in place. Returns (out, (k, v))."""
    b, s, _ = h.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (h @ ap["wq"]).reshape(b, s, H, hd)
    k = (h @ ap["wk"]).reshape(b, s, KV, hd)
    v = (h @ ap["wv"]).reshape(b, s, KV, hd)
    q, k = rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta)
    if kv is None:
        o = attn.flash_attention(q, k, v, causal=True)
    else:
        k, v = attn.cache_update(kv[0], kv[1], k, v, pos)
        o = attn.decode_attention(q, k, v, pos)
    return o.reshape(b, s, H * hd) @ ap["wo"], (k, v)


def _dense_mlp(dp, h):
    g = h @ dp["w_gate"]
    u = h @ dp["w_up"]
    return (F.silu(g.float()).to(h.dtype) * u) @ dp["w_down"]


def _super_block(cfg, mesh_info, x, bp, positions, states=None, pos=None, lanes: int = 1):
    """One super-block (period sub-layers). ``states``: this block's decode
    caches ``{"k", "v", "mamba": [(h, conv) per Mamba slot]}``. Returns
    ``(x, new states, aux)``; the new states hold the attention's K/V (the
    updated caches in decode) and each Mamba slot's (h, conv)."""
    period, _ = _layout(cfg)
    attn_slot = period // 2
    i_mamba = i_dense = i_moe = 0
    new_states = {"mamba": [], "k": None, "v": None}
    aux_acc = None
    for i in range(period):
        h = rmsnorm(x, bp["attn_norm"][i], cfg.norm_eps)
        if i == attn_slot:
            kv = None if states is None else (states["k"], states["v"])
            o, (new_states["k"], new_states["v"]) = _attention(cfg, bp["attn"], h, positions, kv, pos)
        else:
            st = None if states is None else states["mamba"][i_mamba]
            o, new_st = ssm.mamba_block(bp["mamba"][i_mamba], h, cfg, st)
            new_states["mamba"].append(new_st)
            i_mamba += 1
        x = x + o
        h2 = rmsnorm(x, bp["mlp_norm"][i], cfg.norm_eps)
        if cfg.is_moe_layer(i):
            mp = bp["moe"][i_moe]
            y, aux = moe_mod.moe_tp({k: mp[k] for k in ("router", "w_gate", "w_up", "w_down")}, h2, cfg,
                                    lanes=lanes)
            aux_acc = _add_aux(aux_acc, aux)
            i_moe += 1
        else:
            y = _dense_mlp(bp["dense"][i_dense], h2)
            i_dense += 1
        x = x + y
    if aux_acc is None:
        aux_acc = _no_aux(x.device)
    return x, new_states, aux_acc


def _add_aux(acc, aux):
    if acc is None:
        return aux
    return {k: (a | aux[k]) if a.dtype == torch.bool else a + aux[k] for k, a in acc.items()}


#: a Mamba leaf's channel dimension, split over the model axis as stored
_MAMBA_SPLIT = {"in_proj": 1, "conv_w": 1, "conv_b": 0, "w_xdbc": 0, "w_dt": 1, "b_dt": 0, "A_log": 0, "D": 0,
                "out_proj": 0}


def _super_block_mesh(cfg, ms, x, bp, positions, states=None, pos=None, offset=0, seq_split=False):
    """:func:`_super_block` on a mesh; ``states``: this block's local cache
    blocks, ``offset`` and ``seq_split`` the K/V cache's sequence layout
    (``transformer.seq_offset``). The new states hold the attention's
    (k, v, head-split) in train and prefill, and each Mamba slot's local
    (h, conv)."""
    period, _ = _layout(cfg)
    i_mamba = i_dense = i_moe = 0
    new_states = {"mamba": [], "kv": None}
    aux_acc = None
    for i in range(period):
        h = rmsnorm(x, ms.fetch(bp["attn_norm"][i], None, ms.tok), cfg.norm_eps)
        if i == period // 2:
            if states is None:
                o, new_states["kv"] = tfm._mesh_attention(cfg, ms, bp["attn"], h, positions)
            else:
                o = tfm._mesh_decode_attention(cfg, ms, bp["attn"], h, states["k"], states["v"], pos, positions,
                                               offset, seq_split)
        else:
            mb, st = bp["mamba"][i_mamba], None if states is None else states["mamba"][i_mamba]
            if ms.whole(mb["out_proj"]):  # d_inner not split over the model axis: every channel on every rank
                mp = {k: ms.fetch(mb[k], None, ms.bax) for k in _MAMBA_SPLIT}
                o, new_st = ssm.mamba_block(mp, ms.gather_seq(h, summed=False), cfg, st)
                o = ms.own_seq(o)
            else:
                mp = {k: ms.fetch(mb[k], d, ms.bax) for k, d in _MAMBA_SPLIT.items()}
                o, new_st = ssm.mamba_block(mp, ms.gather_seq(h), cfg, st, mesh=ms)
                o = ms.reduce_seq(o)
            new_states["mamba"].append(new_st)
            i_mamba += 1
        x = x + o
        h2 = rmsnorm(x, ms.fetch(bp["mlp_norm"][i], None, ms.tok), cfg.norm_eps)
        if cfg.is_moe_layer(i):
            y, aux = tfm._mesh_mlp(cfg, ms, bp["moe"][i_moe], h2, moe=True)
            aux_acc = _add_aux(aux_acc, aux)
            i_moe += 1
        else:
            y, _ = tfm._mesh_mlp(cfg, ms, bp["dense"][i_dense], h2, moe=False)
            i_dense += 1
        x = x + y
    return x, new_states, (_no_aux(x.device) if aux_acc is None else aux_acc)


def _super_block_train_mesh(cfg, ms, x, bp, positions):
    x, _, aux = _super_block_mesh(cfg, ms, x, bp, positions)
    return x, aux


def _sum_aux(auxs, device) -> Dict[str, torch.Tensor]:
    """Per-block terms summed over the blocks, as the reference's scan
    stacks them."""
    if not auxs:
        return _no_aux(device)
    return {k: (torch.stack([a[k] for a in auxs]).any() if k == "overflow"
                else torch.stack([a[k] for a in auxs]).sum()) for k in auxs[0]}


def _forward_train_mesh(cfg, params, tokens, labels, mesh_info):
    """``forward_train`` on a mesh: the same loss as on one device
    (``transformer._mesh_loss``), each super-block rematerialized under
    ``cfg.remat``."""
    ms = tfm._MeshStep(cfg, mesh_info, *tokens.shape)
    x = tfm._mesh_embed(cfg, ms, params, tokens, {})
    positions = torch.arange(tokens.shape[1], device=x.device).expand(x.shape[0], tokens.shape[1])
    remat = cfg.remat and torch.is_grad_enabled()
    auxs = []
    for bp in params.blocks:
        if remat:
            x, aux = checkpoint(_super_block_train_mesh, cfg, ms, x, bp, positions,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = _super_block_train_mesh(cfg, ms, x, bp, positions)
        auxs.append(aux)
    aux = _sum_aux(auxs, x.device)
    loss = tfm._mesh_loss(cfg, ms, params, x, labels) + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
    return tfm._dp_share(ms, loss), aux


def _prefill_mesh(cfg, params, tokens, mesh_info, cache_len):
    """``prefill`` on a mesh: the cache comes back as ``DTensor``s placed by
    the sanitized ``cache_specs`` (K and V sequence-split, the Mamba
    states channel-split), the last logits as one full (B, V) tensor on
    every rank."""
    b, s = tokens.shape
    ms = tfm._MeshStep(cfg, mesh_info, b, s)
    x = tfm._mesh_embed(cfg, ms, params, tokens, {})
    positions = torch.arange(s, device=x.device).expand(x.shape[0], s)
    shapes = cache_shapes(cfg, b, cache_len or s)
    specs, cache = tfm._mesh_cache(cfg, ms, shapes, x.device)
    lo, hi = tfm._seq_block(ms, specs["k"], shapes["k"].shape)
    hi = min(hi, s)  # this rank's filled cache rows
    hs, convs = cache["mamba"]
    for i, bp in enumerate(params.blocks):
        x, st, _ = _super_block_mesh(cfg, ms, x, bp, positions)
        k, v = tfm._every_head(ms, st["kv"])
        if hi > lo:
            cache["k"][i, :, : hi - lo] = k[:, lo:hi]
            cache["v"][i, :, : hi - lo] = v[:, lo:hi]
        for j, (h, conv) in enumerate(st["mamba"]):
            hs[i, j] = h
            convs[i, j] = conv
    cache["pos"] = torch.full((), s - 1, dtype=torch.int32, device=x.device)
    return tfm._placed_cache(ms, specs, cache, shapes), tfm._last_logits(cfg, ms, params, x)


def _decode_step_mesh(cfg, params, cache, token, mesh_info):
    """``decode_step`` on a mesh: the residual replicated over the model
    axis (one token), the attention slot as the transformer's mesh decode,
    the Mamba slots on this rank's channels of their carried states (under
    ``dp``, whose weights are whole, on every channel: the states gathered
    for the step, this rank's block of the new ones kept); the cache's
    local blocks updated in place."""
    ms, pos = tfm._decode_mesh_step(cfg, mesh_info, cache, token)
    kl, vl = cache["k"].to_local(), cache["v"].to_local()
    placed = [shd.spec_of(ms.mesh, t.placements, t.dim()) for t in cache["mamba"]]
    used = [sp if ms.tp else shd.without(sp, ms.model) for sp in placed]
    hs, convs = (shd.relay(t.to_local(), ms.mesh, sp, u, ms.model) for t, sp, u in zip(cache["mamba"], placed, used))
    offset, seq_split = tfm._cache_offset(ms, cache["k"])
    x = F.embedding(token[ms.block_rows].long(), ms.fetch(params.embed))[:, None, :]
    positions = pos.expand(x.shape[0])[:, None]
    for i, bp in enumerate(params.blocks):
        states = {"k": kl[i], "v": vl[i], "mamba": [(hs[i, j], convs[i, j]) for j in range(hs.shape[1])]}
        x, st, _ = _super_block_mesh(cfg, ms, x, bp, positions, states, pos, offset, seq_split)
        for j, (h, conv) in enumerate(st["mamba"]):
            hs[i, j] = h
            convs[i, j] = conv
    for t, new, sp, u in zip(cache["mamba"], (hs, convs), placed, used):
        if sp != u:
            t.to_local().copy_(shd.relay(new, ms.mesh, u, sp, ms.model))
    logits = tfm._last_logits(cfg, ms, params, x)
    return logits, {"k": cache["k"], "v": cache["v"], "mamba": cache["mamba"], "pos": pos}


def _no_aux(device) -> Dict[str, torch.Tensor]:
    return {"lb_loss": torch.zeros((), device=device), "z_loss": torch.zeros((), device=device),
            "overflow": torch.zeros((), dtype=torch.bool, device=device)}


def _embed(params, tokens):
    # an embedding lookup: its backward is deterministic (models.transformer)
    return F.embedding(tokens.long(), params.embed)


def forward_train(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    mesh_info=None,
    extras: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Dict]:
    if tfm._on_mesh(mesh_info):
        return _forward_train_mesh(cfg, params, tokens, labels, mesh_info)
    b, s = tokens.shape
    x = _embed(params, tokens)
    positions = torch.arange(s, device=x.device).expand(b, s)
    # under cfg.remat each super-block keeps only its input for the backward
    # pass, as the reference's jax.checkpoint of the scanned block
    remat = cfg.remat and torch.is_grad_enabled()
    auxs = []
    for bp in params.blocks:
        if remat:
            x, _, aux = checkpoint(_super_block, cfg, mesh_info, x, bp, positions,
                                   use_reentrant=False, preserve_rng_state=False)
        else:
            x, _, aux = _super_block(cfg, mesh_info, x, bp, positions)
        auxs.append(aux)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = x @ params.lm_head
    loss = next_token_loss(logits[:, :-1], labels[:, 1:])
    aux = _sum_aux(auxs, x.device)
    loss = loss + 0.01 * aux["lb_loss"] + 1e-3 * aux["z_loss"]
    return loss, aux


# ------------------------------------------------------------------ serve
def _empty_cache(cfg: ArchConfig, b: int, cache_len: int, device) -> Dict:
    return {k: (tuple(torch.zeros(t.shape, dtype=t.dtype, device=device) for t in v) if isinstance(v, tuple)
                else torch.zeros(v.shape, dtype=v.dtype, device=device))
            for k, v in cache_shapes(cfg, b, cache_len).items()}


def prefill(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,
    mesh_info=None,
    extras: Optional[Dict] = None,
    cache_len: Optional[int] = None,
) -> Tuple[Dict, torch.Tensor]:
    """Run the prompt, build the cache. Returns (cache, last logits)."""
    if tfm._on_mesh(mesh_info):
        return _prefill_mesh(cfg, params, tokens, mesh_info, cache_len)
    b, s = tokens.shape
    cache_len = cache_len or s
    x = _embed(params, tokens)
    positions = torch.arange(s, device=x.device).expand(b, s)
    cache = _empty_cache(cfg, b, cache_len, x.device)
    hs, convs = cache["mamba"]
    for i, bp in enumerate(params.blocks):
        x, st, _ = _super_block(cfg, mesh_info, x, bp, positions)
        cache["k"][i, :, :s] = st["k"]
        cache["v"][i, :, :s] = st["v"]
        for j, (h, conv) in enumerate(st["mamba"]):
            hs[i, j] = h
            convs[i, j] = conv
    x = rmsnorm(x[:, -1:], params.final_norm, cfg.norm_eps)
    logits = (x @ params.lm_head)[:, 0]
    cache["pos"] = torch.full((), s - 1, dtype=torch.int32, device=x.device)
    return cache, logits


def decode_step(
    cfg: ArchConfig,
    params,
    cache: Dict,
    token: torch.Tensor,  # (B,) previous token
    mesh_info=None,
) -> Tuple[torch.Tensor, Dict]:
    """One autoregressive step; ``cache['pos']`` is the last filled position
    (a scalar, or one per lane: each lane's MoE then keeps its own
    capacity, as the reference's engine decodes lanes under ``jax.vmap``).
    The cache's tensors are updated in place."""
    if tfm._on_mesh(mesh_info):
        return _decode_step_mesh(cfg, params, cache, token, mesh_info)
    b = token.shape[0]
    pos = cache["pos"] + 1
    lanes = b if pos.dim() == 1 else 1
    x = params.embed[token.long()][:, None, :]
    positions = pos.expand(b)[:, None] if pos.dim() == 0 else pos[:, None]
    hs, convs = cache["mamba"]
    for i, bp in enumerate(params.blocks):
        states = {"k": cache["k"][i], "v": cache["v"][i],
                  "mamba": [(hs[i, j], convs[i, j]) for j in range(hs.shape[1])]}
        x, st, _ = _super_block(cfg, mesh_info, x, bp, positions, states=states, pos=pos, lanes=lanes)
        for j, (h, conv) in enumerate(st["mamba"]):
            hs[i, j] = h
            convs[i, j] = conv
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = (x @ params.lm_head)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "mamba": cache["mamba"], "pos": pos}


def cache_shapes(cfg: ArchConfig, batch: int, cache_len: int) -> Dict:
    """The cache's tensors on the ``meta`` device (shapes and dtypes, no memory)."""
    period, blocks = _layout(cfg)
    KV, hd = cfg.n_kv_heads, cfg.hd
    dt = dtype_of(cfg)
    hsh, csh = ssm.mamba_state_shape(cfg, batch)
    kv = (blocks, batch, cache_len, KV, hd)
    return {
        "k": torch.empty(kv, dtype=dt, device="meta"),
        "v": torch.empty(kv, dtype=dt, device="meta"),
        "mamba": (torch.empty((blocks, period - 1) + hsh, dtype=torch.float32, device="meta"),
                  torch.empty((blocks, period - 1) + csh, dtype=dt, device="meta")),
        "pos": torch.empty((), dtype=torch.int32, device="meta"),
    }
