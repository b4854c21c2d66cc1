"""Decoder-only transformer LM (families: dense, moe, vlm).

The port of the JAX package's ``repro.models.transformer``: pre-norm GQA
attention with RoPE, SwiGLU or MoE MLP, optional sliding window
(mixtral). The VLM family receives stub patch embeddings that
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

Each entry point takes ``mesh_info`` as the reference's do
(``models.make_mesh_info``): with a mesh, every rank runs the step on its
block of the global inputs (see :class:`_MeshStep`), with the one-device
step's result: the same loss, the logits as one full tensor on every
rank, a cache placed by the sanitized ``cache_specs``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import attention as attn
from . import moe as moe_mod
from . import sharding as shd
from .layers import _dense, dtype_of, init_attn, init_mlp, next_token_loss, rmsnorm, rope, swiglu


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
    """SwiGLU, or the MoE layer (``lanes``: see ``moe._grouped_gemm_moe``),
    on one device (the mesh's four-way choice is :func:`_mesh_mlp`)."""
    if not cfg.moe_experts:
        return swiglu(h, lp), {}
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
    if _on_mesh(mesh_info):
        return _forward_train_mesh(cfg, params, tokens, labels, mesh_info, extras)
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
    if _on_mesh(mesh_info):
        return _prefill_mesh(cfg, params, tokens, mesh_info, extras, cache_len)
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
    if _on_mesh(mesh_info):
        return _decode_step_mesh(cfg, params, cache, token, mesh_info)
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


# ------------------------------------------------------------ the mesh steps
def _on_mesh(mesh_info) -> bool:
    return mesh_info is not None and mesh_info.mesh is not None


class _MeshStep:
    """One step's layout on the mesh (the reference's GSPMD annotations,
    made explicit).

    Weights are ``DTensor`` parameters placed by ``sharding.param_specs``
    (plain tensors, each rank a full replica, under the ``dp`` policy);
    :meth:`fetch` gives a layer its local block, gathering the FSDP
    shards, and names how the local gradient relates to the stored one:
    ``Shard`` where the weight is used split over the model axis,
    ``Partial`` (a sum over ranks) over the axes whose ranks hold other
    tokens, ``Replicate`` where every rank computed the same gradient.

    Activations are local tensors of the global (B, S, ...) batch: B over
    the data axes (:attr:`bax`, the sanitized prefix that divides it), S
    over the model axis between blocks when ``cfg.seq_shard_activations``
    holds and S divides (:attr:`sp`, Megatron-SP). Inside a block the
    sequence is gathered once before the column-parallel products and the
    row-parallel output is reduce-scattered back (:meth:`gather_seq`,
    :meth:`reduce_seq`), each collective with its transpose as its
    backward (``sharding``'s explicit collectives: ``DTensor``'s own
    all-gather crashes under gloo on CUDA tensors). Under the ``dp``
    policy the model axis is one more data axis, and a block is the
    one-device block on local tokens.

    Where the heads do not divide the model axis (whisper's 6 and xlstm's
    4 at model 16: the sanitized specs still split the products' columns,
    so a head straddles two ranks), :attr:`head_parallel` is false: q, k
    and v are gathered to every head, attention or the recurrence runs on
    every model rank, and the row-parallel output takes this rank's
    column block of it (:meth:`own_cols`).
    """

    def __init__(self, cfg: ArchConfig, mesh_info, b: int, s: int):
        from ..core.primitives import GroupProcs

        self.cfg, self.mi, self.b, self.s = cfg, mesh_info, b, s
        self.mesh = mesh_info.mesh
        self.names = tuple(self.mesh.mesh_dim_names)
        self.model = mesh_info.model_axis
        self.tp = self.model not in mesh_info.data_axes
        self.m = mesh_info.model_size if self.tp else 1
        self.rank_m = mesh_info.index(self.model) if self.tp else 0
        entry = shd.sanitize_specs(self.mesh, shd.Spec(tuple(mesh_info.data_axes)),
                                   torch.empty((b,), device="meta"))[0]
        self.bax = shd.axes_of(entry)  # the axes the batch splits over
        self.sp = self.tp and cfg.seq_shard_activations and s > 1 and s % self.m == 0
        self.tok = self.bax + ((self.model,) if self.sp else ())  # axes of distinct tokens
        widths = {"d_model": cfg.d_model, "d_ff": cfg.d_ff, "the heads' width": cfg.n_heads * cfg.hd}
        uneven = {k: w for k, w in widths.items() if self.tp and w % self.m}
        if uneven:
            raise NotImplementedError(f"{cfg.name}: {uneven} must divide the model axis ({self.m}) for tensor "
                                      "parallelism")
        self.head_parallel = not self.tp or cfg.n_heads % self.m == 0
        self.procs = {a: GroupProcs.from_mesh(self.mesh, a) for a in self.names}
        self.block_rows = shd.local_block(self.mesh, shd.Spec(entry), (b,))[0]

    # ----------------------------------------------------------- layouts
    def shard_residual(self, x: torch.Tensor) -> torch.Tensor:
        """The reference's ``_shard_residual``: the embedded (B_loc, S, D)
        block (every model rank alike) to the residual layout, S over the
        model axis under SP; its gradient gathered on the way back."""
        return shd.split(x, self.procs[self.model], 1) if self.sp else x

    def gather_seq(self, h: torch.Tensor) -> torch.Tensor:
        """The residual-layout ``h`` as the full sequence on every model
        rank (the reference's ``_head_shard`` point: the column-parallel
        products then give head-split q, k, v), its gradient summed over
        the model axis on the way back (reduce-scattered under SP,
        all-reduced otherwise)."""
        if not self.tp:
            return h
        mp = self.procs[self.model]
        return shd.gather(h, mp, 1) if self.sp else shd.sum_grad(h, mp)

    def reduce_seq(self, y: torch.Tensor) -> torch.Tensor:
        """A row-parallel product's partial sums (full sequence) summed over
        the model axis into the residual layout (reduce-scattered under
        SP, all-reduced otherwise); the gradient passes back unsummed."""
        if not self.tp:
            return y
        mp = self.procs[self.model]
        return shd.scatter_sum(y, mp, 1) if self.sp else shd.psum(y, mp)

    def gather_heads(self, t: torch.Tensor) -> torch.Tensor:
        """(B_loc, S, h_loc, hd) head-split over the model axis -> every
        head (serving: no gradient)."""
        return shd.all_gather(t, self.procs[self.model], 2)

    def gather_cols(self, t: torch.Tensor) -> torch.Tensor:
        """A column-parallel product's (..., n / m) block -> all n columns
        on every model rank; each rank's use of them is partial, so the
        gradient is reduce-scattered back."""
        return shd.gather(t, self.procs[self.model], t.dim() - 1) if self.tp else t

    def chunk_cols(self, t: torch.Tensor) -> torch.Tensor:
        """A (..., n) activation every model rank holds -> this rank's
        column block, the rows of a row-parallel weight it holds."""
        return shd.chunk(t, self.procs[self.model], t.dim() - 1) if self.tp else t

    def own_cols(self, t: torch.Tensor) -> torch.Tensor:
        """Every head's (..., n) attention output -> this rank's column
        block (identity where the heads are split already)."""
        return t if self.head_parallel else self.chunk_cols(t)

    def regroup(self, t: torch.Tensor, gates: int) -> torch.Tensor:
        """A product of ``gates`` concatenated column blocks, its weight
        stored split over the model axis, -> this rank's channels of each
        gate (``sharding.regroup``)."""
        return shd.regroup(t, self.procs[self.model], gates) if self.tp else t

    def psum_split(self, t: torch.Tensor) -> torch.Tensor:
        """Partial sums over the model axis whose sum each rank then uses on
        its own channels only: the sum, and the sum of the gradients on
        the way back."""
        mp = self.procs[self.model]
        return shd.sum_grad(shd.psum(t, mp), mp) if self.tp else t

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """A (B_loc, ...) block -> the full (B, ...) tensor on every rank."""
        for a in reversed(self.bax):
            t = shd.all_gather(t, self.procs[a], 0)
        return t

    def fetch(self, w, model_dim: Optional[int] = None, partial: tuple = ()) -> torch.Tensor:
        """This rank's block of parameter ``w`` for its products: dimension
        ``model_dim`` split over the model axis as stored (or every
        dimension whole), the FSDP shards gathered. Its gradient is a
        partial sum over the axes in ``partial`` (``Partial``), the same
        on every rank of the others (``Replicate``), this rank's block
        where stored split (``Shard``, the gathers' backward
        reduce-scattering the partial sums)."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

        if not isinstance(w, DTensor):
            return w
        gather_axes, grad = {}, []
        for a, p in zip(self.names, w.placements):
            keep = a == self.model and model_dim is not None and self.tp
            if isinstance(p, Shard):
                if keep and p.dim != model_dim:
                    raise ValueError(f"a weight split on {p.dim} over {a} used split on {model_dim}")
                if not keep:
                    gather_axes[a] = (self.procs[a], a in partial)
                grad.append(p)
            elif keep:
                raise ValueError(f"a weight stored whole over {a} used split on {model_dim}")
            else:
                grad.append(Partial() if a in partial else Replicate())
        return shd.local_of(w, gather_axes, grad)

    def aux_over(self, axes: tuple, redundant: int = 1):
        return moe_mod.AuxOver(tuple(self.procs[a] for a in axes), redundant)

    def psum(self, t: torch.Tensor, axes: tuple) -> torch.Tensor:
        for a in axes:
            t = shd.psum(t, self.procs[a])
        return t


def _kv_for_heads(cfg, ms: _MeshStep, t: torch.Tensor) -> torch.Tensor:
    """Every KV head (B, S, KV, hd) -> the heads this rank's query heads
    read: query head g reads KV head g // (H / KV), so a local query head
    meets its own KV head, not the first local one."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    hq, rep = H // ms.m, H // KV
    heads = [(ms.rank_m * hq + j) // rep for j in range(hq)]
    lo, n = heads[0], heads[-1] - heads[0] + 1
    if hq % n == 0 and heads == [lo + j // (hq // n) for j in range(hq)]:
        return t[:, :, lo : lo + n]  # each local KV head serves hq / n query heads
    return t[:, :, torch.tensor(heads, device=t.device)]  # one KV row per query head


def _mesh_qkv(cfg, ms: _MeshStep, lp, hf: torch.Tensor, kf: Optional[torch.Tensor] = None, prefix: str = ""):
    """Column-parallel q of the full-sequence ``hf``, and k, v of ``kf``
    (the encoder's output of a cross-attention; ``hf`` itself by
    default), by the weights ``prefix + "wq"`` etc. With the heads split
    over the model axis: this rank's query heads; its KV heads when they
    split too, else every KV head (the weights replicated or gathered,
    their gradient a partial sum over the model axis: each rank's query
    heads add to it). Where a head straddles two ranks: q, k and v
    gathered to every head. Returns (q, k, v, k and v head-split)."""
    kf = hf if kf is None else kf
    b, s, _ = hf.shape
    t = kf.shape[1]
    H, KV, hd, m = cfg.n_heads, cfg.n_kv_heads, cfg.hd, ms.m

    def col(x, name):  # this rank's column block of x @ w
        return x @ ms.fetch(lp[prefix + name], 1, ms.bax)

    if ms.head_parallel:
        q = col(hf, "wq").reshape(b, s, H // m, hd)
        if KV % m == 0:
            return q, col(kf, "wk").reshape(b, t, KV // m, hd), col(kf, "wv").reshape(b, t, KV // m, hd), True
    else:
        q = ms.gather_cols(col(hf, "wq")).reshape(b, s, H, hd)
        if (KV * hd) % m == 0:
            k = ms.gather_cols(col(kf, "wk")).reshape(b, t, KV, hd)
            return q, k, ms.gather_cols(col(kf, "wv")).reshape(b, t, KV, hd), False
    part = ms.bax + (ms.model,)
    k = (kf @ ms.fetch(lp[prefix + "wk"], None, part)).reshape(b, t, KV, hd)
    v = (kf @ ms.fetch(lp[prefix + "wv"], None, part)).reshape(b, t, KV, hd)
    return q, k, v, False


def _mesh_attention(cfg, ms: _MeshStep, lp, h, positions, *, window=0, causal=True, kf=None, prefix=""):
    """The attention block on the mesh (train and prefill): the sequence
    gathered once (the reference's ``_head_shard`` point: the products
    give head-split q, k, v directly), attention over this rank's heads
    (every head where they do not split), the row-parallel output
    reduce-scattered. ``positions`` None: no RoPE (whisper's sinusoids);
    ``kf``: the keys' input of a cross-attention. Returns (out, (k, v,
    head-split)) with k, v roped, for the cache."""
    hf = ms.gather_seq(h)
    b, s, _ = hf.shape
    q, k, v, split = _mesh_qkv(cfg, ms, lp, hf, kf, prefix)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    ka, va = (k, v) if split or not ms.head_parallel else (_kv_for_heads(cfg, ms, k), _kv_for_heads(cfg, ms, v))
    if s > 1:
        o = attn.flash_attention(q, ka, va, causal=causal, window=window)
    else:
        o = attn.reference_attention(q, ka, va, causal=causal, window=window)
    o = ms.own_cols(o.reshape(b, s, -1)) @ ms.fetch(lp[prefix + "wo"], 0, ms.bax)
    return ms.reduce_seq(o), (k, v, split)


def _every_head(ms: _MeshStep, kv) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_mesh_attention``'s (k, v, head-split) as every KV head (serving:
    no gradient), for the cache."""
    k, v, split = kv
    return (ms.gather_heads(k), ms.gather_heads(v)) if split else (k, v)


def _mesh_decode_qkv(cfg, ms: _MeshStep, lp, h, positions):
    """A decode step's q, k, v (B_loc, 1, ...) of every head on every model
    rank (roped where ``positions`` is given)."""
    q, k, v, split = _mesh_qkv(cfg, ms, lp, ms.gather_seq(h))
    q = ms.gather_heads(q) if ms.head_parallel else q
    if split:
        k, v = ms.gather_heads(k), ms.gather_heads(v)
    if positions is not None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _decode_attend(ms: _MeshStep, q, kc, vc, pos, offset, seq_split: bool, window=0):
    """One query against this rank's cache block: flash-decode over the
    model axis where the cache's sequence splits over it, else plain
    decode attention (every position on every rank)."""
    if seq_split:
        return attn.decode_attention_sharded(q, kc, vc, pos, offset, ms.mesh.get_group(ms.model), window=window)
    return attn.decode_attention(q, kc, vc, pos, window=window)


def _decode_out(cfg, ms: _MeshStep, o, wo) -> torch.Tensor:
    """Every head's (B_loc, 1, H, hd) decode output through the
    row-parallel ``wo``: this rank's column block, summed over the model
    axis."""
    c = cfg.n_heads * cfg.hd // ms.m
    o = o.reshape(o.shape[0], 1, -1)[..., ms.rank_m * c: (ms.rank_m + 1) * c]
    return ms.reduce_seq(o @ ms.fetch(wo, 0))


def _mesh_decode_attention(cfg, ms: _MeshStep, lp, h, kc, vc, pos, positions, offset, seq_split, *, window=0):
    """The decode step's self-attention: the new K/V written into this
    rank's cache block where it owns ``pos`` (in place), flash-decode
    over the sequence-split cache."""
    q, k, v = _mesh_decode_qkv(cfg, ms, lp, h, positions)
    attn.cache_update(kc, vc, k, v, pos - offset)
    return _decode_out(cfg, ms, _decode_attend(ms, q, kc, vc, pos, offset, seq_split, window), lp["wo"])


def _mesh_mlp(cfg, ms: _MeshStep, lp, h, moe: Optional[bool] = None):
    """The reference's four-way ``_mlp_block`` on the mesh: ``moe_tp`` on
    local tokens under the ``dp`` policy; ``moe_ep`` (S > 1) or
    ``moe_ep_decode`` when the experts cover the model axis; else the
    experts' FFN width split over it (``moe_tp_sharded``, its sum
    reduce-scattered into the residual layout). Every MoE path's aux terms
    are the whole batch's, as on one device. A dense MLP (``moe`` false:
    a hybrid's dense slots) is column- then row-parallel."""
    moe = bool(cfg.moe_experts) if moe is None else moe
    if not ms.tp:
        if not moe:
            return swiglu(h, {k: ms.fetch(lp[k]) for k in ("w_gate", "w_up", "w_down")}), {}
        moe_params = {k: ms.fetch(lp[k]) for k in ("router", "w_gate", "w_up", "w_down")}
        y, aux = moe_mod.moe_tp(moe_params, h, cfg, aux_over=ms.aux_over(ms.tok), rule=_batch_rule(cfg, ms))
        return y, {**aux, "overflow": _any(ms, aux["overflow"])}
    if not moe:
        hf = ms.gather_seq(h)
        g = hf @ ms.fetch(lp["w_gate"], 1, ms.bax)
        u = hf @ ms.fetch(lp["w_up"], 1, ms.bax)
        hh = torch.nn.functional.silu(g.float()).to(h.dtype) * u
        return ms.reduce_seq(hh @ ms.fetch(lp["w_down"], 0, ms.bax)), {}
    E = cfg.moe_experts
    if E >= ms.m:
        if E % ms.m:
            raise ValueError(f"the EP path needs the {E} experts divisible by the model axis ({ms.m})")
        if ms.s > 1 and not ms.sp and torch.is_grad_enabled():
            raise NotImplementedError("an EP train step needs the sequence split over the model axis")
        params = {"router": ms.fetch(lp["router"], None, ms.tok),
                  **{k: ms.fetch(lp[k], 0, ms.bax) for k in ("w_gate", "w_up", "w_down")}}
        if ms.s > 1:
            # the one-device rule: a batch of at most 512 records keeps every
            # record; a larger one keeps ceil(n·cf/E) records an expert in the
            # batch's order. The exchange is sized to the kept records'
            # largest (src, dst) count (a capacity guess that overflowed
            # would part the mesh from one device)
            n = ms.b * ms.s * cfg.moe_top_k
            rule = None
            if n > 512:
                rule = moe_mod.OneDeviceCap(int(-(-n * 1.25 // E)), tuple(ms.procs[a] for a in ms.bax),
                                            ms.procs[ms.model] if ms.sp else None)
            return moe_mod.moe_ep(params, h, cfg, ms.mi, capacity_factor=None, aux_over=ms.aux_over(ms.tok),
                                  rule=rule)
        return moe_mod.moe_ep_decode(params, h, cfg, ms.mi, aux_over=ms.aux_over(ms.bax, ms.m))
    # experts replicated, their FFN width split: the router runs on the same
    # tokens on every model rank, so its statistics pass 1/m of their
    # gradient back on each (the gathered input's backward sums them)
    params = {"router": ms.fetch(lp["router"], None, ms.bax + (ms.model,)),
              "w_gate": ms.fetch(lp["w_gate"], 2, ms.bax), "w_up": ms.fetch(lp["w_up"], 2, ms.bax),
              "w_down": ms.fetch(lp["w_down"], 1, ms.bax)}
    return moe_mod.moe_tp_sharded(params, ms.gather_seq(h), cfg, ms.mi, aux_over=ms.aux_over(ms.bax, ms.m),
                                  rule=_batch_rule(cfg, ms), reduce=ms.reduce_seq)


def _batch_rule(cfg, ms: _MeshStep):
    """The one-device capacity rule over the whole batch for a MoE path
    whose ranks hold whole rows (the ``dp`` policy, the FFN-split experts);
    none for a batch of at most 512 records, which keeps them all."""
    n = ms.b * ms.s * cfg.moe_top_k
    if n <= 512:
        return None
    return moe_mod.OneDeviceCap(int(-(-n * 1.25 // cfg.moe_experts)), tuple(ms.procs[a] for a in ms.bax))


def _any(ms: _MeshStep, flag: torch.Tensor) -> torch.Tensor:
    for a in ms.names:
        flag = ms.procs[a].any(flag)
    return flag


def _mesh_block(cfg, ms: _MeshStep, x, lp, positions):
    h = rmsnorm(x, ms.fetch(lp["attn_norm"], None, ms.tok), cfg.norm_eps)
    if ms.tp:
        o, kv = _mesh_attention(cfg, ms, lp, h, positions, window=cfg.sliding_window)
    else:
        p = {k: ms.fetch(lp[k]) for k in ("wq", "wk", "wv", "wo")}
        o, (k, v) = _attention_block(cfg, p, h, positions, window=cfg.sliding_window)
        kv = (k, v, False)
    x = x + o
    h2 = rmsnorm(x, ms.fetch(lp["mlp_norm"], None, ms.tok), cfg.norm_eps)
    y, aux = _mesh_mlp(cfg, ms, lp, h2)
    return x + y, aux, kv


def _mesh_block_train(cfg, ms, x, lp, positions):
    x, aux, _ = _mesh_block(cfg, ms, x, lp, positions)
    return x, aux


def _mesh_embed(cfg, ms: _MeshStep, params, tokens, extras):
    """This rank's rows of the embedded batch, in the residual layout."""
    rows = ms.block_rows
    x = _embed_rows(cfg, ms.fetch(params.embed, None, ms.bax), tokens[rows],
                    {k: v[rows] for k, v in extras.items()})
    return ms.shard_residual(x)


def _embed_rows(cfg, table, tokens, extras):
    x = torch.nn.functional.embedding(tokens.long(), table)
    if cfg.family == "vlm" and extras.get("patch_embeds") is not None:
        pe = extras["patch_embeds"].to(x.dtype)
        x = torch.cat([pe, x[:, pe.shape[1]:]], dim=1)
    return x


def _seq_offset(ms: _MeshStep, s_loc: int) -> int:
    return ms.rank_m * s_loc if ms.sp else 0


def _mesh_train_step(cfg, mesh_info, tokens) -> _MeshStep:
    b, s = tokens.shape
    ms = _MeshStep(cfg, mesh_info, b, s)
    if ms.tp and not ms.sp:
        raise NotImplementedError(f"a tensor-parallel train step needs the sequence ({s}) split over the "
                                  f"model axis ({ms.m}) and cfg.seq_shard_activations")
    return ms


def _forward_train_mesh(cfg, params, tokens, labels, mesh_info, extras):
    """``forward_train`` on a mesh: the same loss as on one device (see
    :func:`_mesh_loss`)."""
    ms = _mesh_train_step(cfg, mesh_info, tokens)
    x = _mesh_embed(cfg, ms, params, tokens, extras)
    positions = _positions(x.shape[0], tokens.shape[1], x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    auxs = []
    for lp in params.layers:
        if remat:
            x, aux = checkpoint(_mesh_block_train, cfg, ms, x, lp, positions,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = _mesh_block_train(cfg, ms, x, lp, positions)
        auxs.append(aux)
    aux = {}
    if auxs and auxs[0]:
        aux = {k: (torch.stack([a[k] for a in auxs]).sum() if k != "overflow"
                   else torch.stack([a[k] for a in auxs]).any()) for k in auxs[0]}
    loss = _mesh_loss(cfg, ms, params, x, labels)
    if cfg.moe_experts:
        loss = loss + 0.01 * aux.get("lb_loss", 0.0) + 1e-3 * aux.get("z_loss", 0.0)
    return _dp_share(ms, loss), aux


def _mesh_loss(cfg, ms: _MeshStep, params, x, labels) -> torch.Tensor:
    """The next-token loss of the residual ``x`` on a mesh, the same as on
    one device: each rank sums the losses of its own positions (the
    labels of its rows are whole on every model rank), and one ``psum``
    of (sum, count) over the axes of distinct tokens gives every rank the
    mean."""
    s = labels.shape[1]
    x = rmsnorm(x, ms.fetch(params.final_norm, None, ms.tok), cfg.norm_eps)
    logits = (x @ ms.fetch(params.lm_head, None, ms.tok)).float()
    s_loc = x.shape[1]
    pos = _seq_offset(ms, s_loc) + torch.arange(s_loc, device=x.device)
    gold_at = torch.clamp(pos + 1, max=s - 1)
    lab = labels[ms.block_rows][:, gold_at].long()
    nll = torch.logsumexp(logits, dim=-1) - torch.gather(logits, -1, lab[..., None])[..., 0]
    valid = pos < s - 1
    if cfg.family == "vlm":
        valid = valid & (pos + 1 >= cfg.vision_tokens)
    w = valid.to(nll.dtype).expand_as(nll)
    packed = ms.psum(torch.stack([torch.sum(nll * w), torch.sum(w)]), ms.tok)
    return packed[0] / torch.clamp(packed[1], min=1.0)


def _dp_share(ms: _MeshStep, loss: torch.Tensor) -> torch.Tensor:
    """The whole loss, its gradient this rank's share under the ``dp``
    policy: the plain gradients are summed over every rank, and ranks
    along a data axis the batch does not split over hold the same rows."""
    if ms.tp:
        return loss
    r = math.prod(ms.mi.size(a) for a in ms.mi.data_axes if a not in ms.bax)
    return shd.scale_grad(loss, 1.0 / r) if r > 1 else loss


def _mesh_cache(cfg, ms: _MeshStep, shapes, device):
    """A cache of ``shapes`` (``cache_shapes``' full ``meta`` tensors) on
    the mesh: its sanitized ``cache_specs`` and this rank's zero blocks on
    ``device``."""
    specs = shd.sanitize_specs(ms.mesh, shd.cache_specs(cfg, ms.mesh, shapes), shapes)

    def zeros(spec, t):
        block = shd.local_block(ms.mesh, spec, t.shape)
        return torch.zeros(tuple(b.stop - b.start for b in block), dtype=t.dtype, device=device)

    return specs, shd.tree_map(zeros, specs, shapes)


def _placed_cache(ms: _MeshStep, specs, local, shapes):
    """This rank's cache blocks as ``DTensor``s placed by ``specs``; a 0-d
    leaf (``pos``) stays a plain tensor."""
    from torch.distributed.tensor import DTensor

    def put(spec, t, full):
        if not full.dim():
            return t
        return DTensor.from_local(t, ms.mesh, shd.to_placements(ms.mesh, spec), run_check=False,
                                  shape=full.shape, stride=full.stride())

    return shd.tree_map(put, specs, local, shapes)


def _seq_block(ms: _MeshStep, spec, shape) -> Tuple[int, int]:
    """This rank's positions [lo, hi) of a cache leaf's sequence
    (dimension 2)."""
    block = shd.local_block(ms.mesh, spec, shape)[2]
    return block.start, block.stop


def _last_position(ms: _MeshStep, x: torch.Tensor) -> torch.Tensor:
    """The residual's last position (B_loc, 1, D) on every model rank: under
    SP it lives on the last model rank, which adds it into zeros."""
    last = x[:, -1:]
    if not ms.sp:
        return last
    keep = torch.full((), float(ms.rank_m == ms.m - 1), dtype=x.dtype, device=x.device)
    return ms.psum(last * keep, (ms.model,))


def _last_logits(cfg, ms: _MeshStep, params, x) -> torch.Tensor:
    """The residual's last position through the final norm and the LM
    head: one full (B, V) tensor on every rank."""
    x = rmsnorm(_last_position(ms, x), ms.fetch(params.final_norm), cfg.norm_eps)
    return ms.gather_rows((x @ ms.fetch(params.lm_head))[:, 0])


def _serving_step(cfg, mesh_info, b: int, s: int) -> _MeshStep:
    ms = _MeshStep(cfg, mesh_info, b, s)
    if not ms.tp:
        raise NotImplementedError("the mesh's serving steps shard the weights over the model axis: serve "
                                  "with the 1d or 2d policy (the dry-run serves a dp arch under 1d)")
    return ms


def _prefill_mesh(cfg, params, tokens, mesh_info, extras, cache_len):
    """``prefill`` on a mesh: the cache comes back as ``DTensor``s placed by
    the sanitized ``cache_specs`` (sequence over the model axis), the last
    logits as one full (B, V) tensor on every rank."""
    b, s = tokens.shape
    cache_len = cache_len or s
    ms = _serving_step(cfg, mesh_info, b, s)
    x = _mesh_embed(cfg, ms, params, tokens, extras)
    positions = _positions(x.shape[0], s, x.device)
    shapes = cache_shapes(cfg, b, cache_len)
    specs, cache = _mesh_cache(cfg, ms, shapes, x.device)
    lo, hi = _seq_block(ms, specs["k"], shapes["k"].shape)
    hi = min(hi, s)  # this rank's filled cache rows
    for i, lp in enumerate(params.layers):
        x, _, kv = _mesh_block(cfg, ms, x, lp, positions)
        k, v = _every_head(ms, kv)
        if hi > lo:
            cache["k"][i, :, : hi - lo] = k[:, lo:hi]
            cache["v"][i, :, : hi - lo] = v[:, lo:hi]
    logits = _last_logits(cfg, ms, params, x)
    cache["pos"] = torch.full((), s - 1, dtype=torch.int32, device=x.device)
    return _placed_cache(ms, specs, cache, shapes), logits


def _cache_offset(ms: _MeshStep, kv) -> Tuple[int, bool]:
    """(the global position of this rank's first cache row, whether the
    cache's sequence splits over the model axis) of a ``DTensor`` K/V
    cache (L, B, S, KV, hd)."""
    from torch.distributed.tensor import Shard

    split = ms.tp and any(isinstance(p, Shard) and p.dim == 2 for p in kv.placements)
    return (ms.rank_m * kv.to_local().shape[2] if split else 0), split


def _decode_mesh_step(cfg, mesh_info, cache, token) -> Tuple[_MeshStep, torch.Tensor]:
    """A mesh decode step's layout and its position: one position for
    every row."""
    ms = _serving_step(cfg, mesh_info, token.shape[0], 1)
    pos = cache["pos"] + 1
    if pos.dim():
        raise ValueError("the mesh's decode step takes one position for every row (a scalar pos)")
    return ms, pos


def _decode_step_mesh(cfg, params, cache, token, mesh_info):
    """``decode_step`` on a mesh: the residual is replicated over the model
    axis (one token), q and the new K/V are gathered to every head, the
    new K/V written on the shard that owns ``pos``, and attention runs as
    flash-decode over the sequence-split cache. The cache's local blocks
    are updated in place; the logits come back as one full (B, V)."""
    ms, pos = _decode_mesh_step(cfg, mesh_info, cache, token)
    kl, vl = cache["k"].to_local(), cache["v"].to_local()
    offset, seq_split = _cache_offset(ms, cache["k"])
    x = torch.nn.functional.embedding(token[ms.block_rows].long(), ms.fetch(params.embed))[:, None, :]
    positions = pos.expand(x.shape[0])[:, None]
    for i, lp in enumerate(params.layers):
        h = rmsnorm(x, ms.fetch(lp["attn_norm"]), cfg.norm_eps)
        x = x + _mesh_decode_attention(cfg, ms, lp, h, kl[i], vl[i], pos, positions, offset, seq_split,
                                       window=cfg.sliding_window)
        h2 = rmsnorm(x, ms.fetch(lp["mlp_norm"]), cfg.norm_eps)
        y, _ = _mesh_mlp(cfg, ms, lp, h2)
        x = x + y
    x = rmsnorm(x, ms.fetch(params.final_norm), cfg.norm_eps)
    logits = ms.gather_rows((x @ ms.fetch(params.lm_head))[:, 0])
    return logits, {"k": cache["k"], "v": cache["v"], "pos": pos}
