"""Whisper-style encoder-decoder backbone (family ``audio``).

The port of the JAX package's ``repro.models.encdec`` on one device. The
audio frontend is a stub: the model takes precomputed ``(B, T, d_model)``
frame embeddings (``extras["frames"]``). The encoder is bidirectional
self-attention over the frames; each decoder block adds causal
self-attention (KV-cached at decode) and cross-attention on the encoder's
output, whose K/V are computed once per block at prefill and kept in the
cache. Positions are sinusoidal (no RoPE) in both stacks.

``params`` is a :class:`repro_torch.models.Model`: ``params.enc[i]`` holds
encoder layer i's ``attn_norm``, ``mlp_norm``, ``wq``, ``wk``, ``wv``,
``wo``, ``w_gate``, ``w_up``, ``w_down``; ``params.dec[i]`` adds
``cross_norm`` and the cross-attention's ``xwq``, ``xwk``, ``xwv``,
``xwo``; beside them ``embed``, ``enc_final_norm``, ``final_norm`` and
``lm_head``. The reference scans over stacked layers; the port loops.

A decode cache is ``{"k", "v": (L, B, S_max, KV, hd), "xk", "xv": (L, B,
T, KV, hd), "pos"}``; ``k`` and ``v`` are updated in place, ``pos`` is a
scalar or one position per lane, as in ``models.transformer``.

On a mesh (serving under ``1d`` or ``2d``; the reference trains this
family under ``dp`` only) the steps are tensor-parallel as the
transformer's (``models.transformer._MeshStep``; whisper's 6 heads do not
divide a model axis of 4 or 16, so its q, k and v are gathered to every
head there): the encoder runs over the frames (sequence-split between
blocks where they divide the model axis), its output is gathered to every
frame for the cross K/V, and the cache comes back placed by the sanitized
``cache_specs``: K and V with the sequence over the model axis, ``xk`` and
``xv`` with the frames over it where they divide it (replicated where
not). Decode runs flash-decode over the sequence-split cache and over
frame-split cross K/V at the last frame.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from . import attention as attn
from . import transformer as tfm
from .layers import (_dense, dtype_of, init_attn, init_mlp, next_token_loss, rmsnorm, sinusoidal_positions,
                     swiglu)


def stacks(cfg: ArchConfig) -> Dict[str, int]:
    """The model's stacked containers and their lengths."""
    return {"enc": cfg.enc_layers, "dec": cfg.n_layers}


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random parameters on the generator's device, by state-dict name
    (``embed``, ``enc.<i>.<leaf>``, ``dec.<i>.<leaf>``, ``enc_final_norm``,
    ``final_norm``, ``lm_head``)."""
    D, V = cfg.d_model, cfg.vocab
    dt, dev = dtype_of(cfg), gen.device

    def ones():
        return torch.ones((D,), dtype=dt, device=dev)

    out = {"embed": _dense(gen, (V, D), D, dt)}
    for i in range(cfg.enc_layers):
        layer = {"attn_norm": ones(), "mlp_norm": ones(), **init_attn(gen, cfg), **init_mlp(gen, cfg)}
        out.update({f"enc.{i}.{leaf}": t for leaf, t in layer.items()})
    for i in range(cfg.n_layers):
        layer = {"attn_norm": ones(), "cross_norm": ones(), "mlp_norm": ones(), **init_attn(gen, cfg),
                 **{f"x{k}": t for k, t in init_attn(gen, cfg).items()}, **init_mlp(gen, cfg)}
        out.update({f"dec.{i}.{leaf}": t for leaf, t in layer.items()})
    out["enc_final_norm"] = ones()
    out["final_norm"] = ones()
    out["lm_head"] = _dense(gen, (D, V), D, dt)
    return out


def _frames(extras: Optional[Dict]) -> torch.Tensor:
    frames = (extras or {}).get("frames")
    if frames is None:
        raise KeyError("the audio family needs the encoder's input: extras['frames'], (B, T, d_model) frame "
                       "embeddings")
    return frames


def _attend(cfg, h, wq, wk, wv, wo, kv=None, causal=True):
    """Attention of ``h`` on itself, or on given K/V (the cross-attention).
    No RoPE: positions enter as sinusoids added to the inputs."""
    b, s, D = h.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (h @ wq).reshape(b, s, H, hd)
    if kv is None:
        k = (h @ wk).reshape(b, s, KV, hd)
        v = (h @ wv).reshape(b, s, KV, hd)
    else:
        k, v = kv
    o = attn.flash_attention(q, k, v, causal=causal)
    return o.reshape(b, s, H * hd) @ wo, (k, v)


def _mlp(cfg, x, lp):
    return x + swiglu(rmsnorm(x, lp["mlp_norm"], cfg.norm_eps), lp)


def encode(cfg: ArchConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T, D) precomputed stub embeddings -> the encoder's output."""
    dt = dtype_of(cfg)
    x = frames.to(dt) + sinusoidal_positions(frames.shape[1], cfg.d_model, frames.device).to(dt)
    for lp in params.enc:
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        o, _ = _attend(cfg, h, lp["wq"], lp["wk"], lp["wv"], lp["wo"], causal=False)
        x = _mlp(cfg, x + o, lp)
    return rmsnorm(x, params.enc_final_norm, cfg.norm_eps)


def _cross_kv(cfg, enc_out, lp):
    b, t, _ = enc_out.shape
    KV, hd = cfg.n_kv_heads, cfg.hd
    return (enc_out @ lp["xwk"]).reshape(b, t, KV, hd), (enc_out @ lp["xwv"]).reshape(b, t, KV, hd)


def _dec_block(cfg, x, lp, enc_kv):
    h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
    o, self_kv = _attend(cfg, h, lp["wq"], lp["wk"], lp["wv"], lp["wo"])
    x = x + o
    hx = rmsnorm(x, lp["cross_norm"], cfg.norm_eps)
    o2, _ = _attend(cfg, hx, lp["xwq"], lp["xwk"], lp["xwv"], lp["xwo"], kv=enc_kv, causal=False)
    return _mlp(cfg, x + o2, lp), self_kv


def _dec_train(cfg, x, lp, enc_out):
    return _dec_block(cfg, x, lp, _cross_kv(cfg, enc_out, lp))[0]


def _decoder_input(cfg, params, tokens):
    # an embedding lookup, not an index: a deterministic backward (see
    # transformer._embed)
    s = tokens.shape[1]
    x = F.embedding(tokens.long(), params.embed)
    return x + sinusoidal_positions(s, cfg.d_model, x.device).to(dtype_of(cfg))


def forward_train(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,
    labels: torch.Tensor,
    mesh_info=None,
    extras: Optional[Dict] = None,
) -> Tuple[torch.Tensor, Dict]:
    enc_out = encode(cfg, params, _frames(extras))
    x = _decoder_input(cfg, params, tokens)
    # under cfg.remat each decoder block (its cross K/V included) keeps only
    # its input for the backward pass, as the reference's jax.checkpoint of
    # the scanned body; the encoder is not rematerialized
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params.dec:
        if remat:
            x = checkpoint(_dec_train, cfg, x, lp, enc_out, use_reentrant=False, preserve_rng_state=False)
        else:
            x = _dec_train(cfg, x, lp, enc_out)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = x @ params.lm_head
    return next_token_loss(logits[:, :-1], labels[:, 1:]), {}


# ------------------------------------------------------------------ serve
def prefill(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,
    mesh_info=None,
    extras: Optional[Dict] = None,
    cache_len: Optional[int] = None,
) -> Tuple[Dict, torch.Tensor]:
    """Encode the frames, run the prompt through the decoder, build the
    caches. Returns (cache, last logits)."""
    if tfm._on_mesh(mesh_info):
        return _prefill_mesh(cfg, params, tokens, mesh_info, extras, cache_len)
    enc_out = encode(cfg, params, _frames(extras))
    b, s = tokens.shape
    cache_len = cache_len or s
    x = _decoder_input(cfg, params, tokens)
    L, T, KV, hd = cfg.n_layers, enc_out.shape[1], cfg.n_kv_heads, cfg.hd
    kcache = torch.zeros((L, b, cache_len, KV, hd), dtype=x.dtype, device=x.device)
    vcache = torch.zeros_like(kcache)
    xk = torch.empty((L, b, T, KV, hd), dtype=x.dtype, device=x.device)
    xv = torch.empty_like(xk)
    for i, lp in enumerate(params.dec):
        ek, ev = _cross_kv(cfg, enc_out, lp)
        x, (k, v) = _dec_block(cfg, x, lp, (ek, ev))
        kcache[i, :, :s] = k
        vcache[i, :, :s] = v
        xk[i] = ek
        xv[i] = ev
    x = rmsnorm(x[:, -1:], params.final_norm, cfg.norm_eps)
    logits = (x @ params.lm_head)[:, 0]
    pos = torch.full((), s - 1, dtype=torch.int32, device=x.device)
    return {"k": kcache, "v": vcache, "xk": xk, "xv": xv, "pos": pos}, logits


def decode_step(
    cfg: ArchConfig,
    params,
    cache: Dict,
    token: torch.Tensor,  # (B,) previous token
    mesh_info=None,
) -> Tuple[torch.Tensor, Dict]:
    """One autoregressive step; ``cache['pos']`` is the last filled position
    (a scalar, or one per lane). The self-attention cache is updated in
    place; the cross K/V are read at every position of the frames."""
    if tfm._on_mesh(mesh_info):
        return _decode_step_mesh(cfg, params, cache, token, mesh_info)
    b = token.shape[0]
    pos = cache["pos"] + 1  # position of the new token
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    x = F.embedding(token.long(), params.embed)[:, None, :]  # (B,1,D)
    # row pos of the sinusoid table over the cache, clamped into it, as the
    # reference's dynamic index reads it
    n = cache["k"].shape[2]
    table = sinusoidal_positions(n, cfg.d_model, x.device)
    x = x + table[pos.expand(b).long().clamp(0, n - 1)][:, None, :].to(x.dtype)
    last_frame = torch.full((), cache["xk"].shape[2] - 1, dtype=torch.int32, device=x.device)
    for i, lp in enumerate(params.dec):
        kc, vc = cache["k"][i], cache["v"][i]
        h = rmsnorm(x, lp["attn_norm"], cfg.norm_eps)
        q = (h @ lp["wq"]).reshape(b, 1, H, hd)
        k = (h @ lp["wk"]).reshape(b, 1, KV, hd)
        v = (h @ lp["wv"]).reshape(b, 1, KV, hd)
        attn.cache_update(kc, vc, k, v, pos)
        o = attn.decode_attention(q, kc, vc, pos)
        x = x + o.reshape(b, 1, H * hd) @ lp["wo"]
        hx = rmsnorm(x, lp["cross_norm"], cfg.norm_eps)
        qx = (hx @ lp["xwq"]).reshape(b, 1, H, hd)
        ox = attn.decode_attention(qx, cache["xk"][i], cache["xv"][i], last_frame)
        x = _mlp(cfg, x + ox.reshape(b, 1, H * hd) @ lp["xwo"], lp)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = (x @ params.lm_head)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "xk": cache["xk"], "xv": cache["xv"], "pos": pos}


def _mesh_mlp(cfg, ms, x, lp):
    y, _ = tfm._mesh_mlp(cfg, ms, lp, rmsnorm(x, ms.fetch(lp["mlp_norm"]), cfg.norm_eps), moe=False)
    return x + y


def _encode_mesh(cfg, params, frames, mesh_info) -> torch.Tensor:
    """:func:`encode` on a mesh: this rank's rows, every frame on every
    model rank at the end (the cross K/V's input)."""
    b, t, _ = frames.shape
    ms = tfm._serving_step(cfg, mesh_info, b, t)
    dt = dtype_of(cfg)
    x = frames[ms.block_rows].to(dt) + sinusoidal_positions(t, cfg.d_model, frames.device).to(dt)
    x = ms.shard_residual(x)
    for lp in params.enc:
        o, _ = tfm._mesh_attention(cfg, ms, lp, rmsnorm(x, ms.fetch(lp["attn_norm"]), cfg.norm_eps), None,
                                   causal=False)
        x = _mesh_mlp(cfg, ms, x + o, lp)
    return ms.gather_seq(rmsnorm(x, ms.fetch(params.enc_final_norm), cfg.norm_eps))


def _mesh_shapes(cfg, b: int, cache_len: int, t: int) -> Dict[str, torch.Tensor]:
    shapes = cache_shapes(cfg, b, cache_len)
    cross = torch.empty((cfg.n_layers, b, t, cfg.n_kv_heads, cfg.hd), dtype=dtype_of(cfg), device="meta")
    return {**shapes, "xk": cross, "xv": cross}


def _prefill_mesh(cfg, params, tokens, mesh_info, extras, cache_len):
    """``prefill`` on a mesh: the caches come back as ``DTensor``s placed
    by the sanitized ``cache_specs``, the last logits as one full (B, V)
    tensor on every rank."""
    enc = _encode_mesh(cfg, params, _frames(extras), mesh_info)
    b, s = tokens.shape
    cache_len = cache_len or s
    ms = tfm._serving_step(cfg, mesh_info, b, s)
    dt = dtype_of(cfg)
    x = F.embedding(tokens[ms.block_rows].long(), ms.fetch(params.embed))
    x = ms.shard_residual(x + sinusoidal_positions(s, cfg.d_model, x.device).to(dt))
    shapes = _mesh_shapes(cfg, b, cache_len, enc.shape[1])
    specs, cache = tfm._mesh_cache(cfg, ms, shapes, x.device)
    lo, hi = tfm._seq_block(ms, specs["k"], shapes["k"].shape)
    hi = min(hi, s)  # this rank's filled cache rows
    flo, fhi = tfm._seq_block(ms, specs["xk"], shapes["xk"].shape)  # and its frames
    for i, lp in enumerate(params.dec):
        h = rmsnorm(x, ms.fetch(lp["attn_norm"]), cfg.norm_eps)
        o, kv = tfm._mesh_attention(cfg, ms, lp, h, None)
        x = x + o
        hx = rmsnorm(x, ms.fetch(lp["cross_norm"]), cfg.norm_eps)
        o2, xkv = tfm._mesh_attention(cfg, ms, lp, hx, None, causal=False, kf=enc, prefix="x")
        x = _mesh_mlp(cfg, ms, x + o2, lp)
        (k, v), (ek, ev) = tfm._every_head(ms, kv), tfm._every_head(ms, xkv)
        if hi > lo:
            cache["k"][i, :, : hi - lo] = k[:, lo:hi]
            cache["v"][i, :, : hi - lo] = v[:, lo:hi]
        cache["xk"][i] = ek[:, flo:fhi]
        cache["xv"][i] = ev[:, flo:fhi]
    cache["pos"] = torch.full((), s - 1, dtype=torch.int32, device=x.device)
    return tfm._placed_cache(ms, specs, cache, shapes), tfm._last_logits(cfg, ms, params, x)


def _decode_step_mesh(cfg, params, cache, token, mesh_info):
    """``decode_step`` on a mesh: the self-attention as the transformer's
    mesh decode, the cross-attention as flash-decode over frame-split
    ``xk``/``xv`` at the last frame (plain decode attention where they
    are replicated); the cache's local blocks updated in place."""
    ms, pos = tfm._decode_mesh_step(cfg, mesh_info, cache, token)
    kl, vl, xkl, xvl = (cache[n].to_local() for n in ("k", "v", "xk", "xv"))
    offset, seq_split = tfm._cache_offset(ms, cache["k"])
    xoffset, frame_split = tfm._cache_offset(ms, cache["xk"])
    x = F.embedding(token[ms.block_rows].long(), ms.fetch(params.embed))[:, None, :]
    b, H, hd = x.shape[0], cfg.n_heads, cfg.hd
    # row pos of the sinusoid table over the cache, as the one-device step reads it
    n = cache["k"].shape[2]
    table = sinusoidal_positions(n, cfg.d_model, x.device)
    x = x + table[pos.expand(b).long().clamp(0, n - 1)][:, None, :].to(x.dtype)
    last_frame = torch.full((), cache["xk"].shape[2] - 1, dtype=torch.int32, device=x.device)
    for i, lp in enumerate(params.dec):
        h = rmsnorm(x, ms.fetch(lp["attn_norm"]), cfg.norm_eps)
        x = x + tfm._mesh_decode_attention(cfg, ms, lp, h, kl[i], vl[i], pos, None, offset, seq_split)
        hx = ms.gather_seq(rmsnorm(x, ms.fetch(lp["cross_norm"]), cfg.norm_eps))
        qx = ms.gather_cols(hx @ ms.fetch(lp["xwq"], 1)).reshape(b, 1, H, hd)
        ox = tfm._decode_attend(ms, qx, xkl[i], xvl[i], last_frame, xoffset, frame_split)
        x = _mesh_mlp(cfg, ms, x + tfm._decode_out(cfg, ms, ox, lp["xwo"]), lp)
    logits = tfm._last_logits(cfg, ms, params, x)
    return logits, {"k": cache["k"], "v": cache["v"], "xk": cache["xk"], "xv": cache["xv"], "pos": pos}


def cache_shapes(cfg: ArchConfig, batch: int, cache_len: int) -> Dict[str, torch.Tensor]:
    """The cache's tensors on the ``meta`` device (shapes and dtypes, no memory)."""
    L, KV, hd, T = cfg.n_layers, cfg.n_kv_heads, cfg.hd, cfg.enc_positions
    dt = dtype_of(cfg)

    def meta(shape, dtype=dt):
        return torch.empty(shape, dtype=dtype, device="meta")

    return {"k": meta((L, batch, cache_len, KV, hd)), "v": meta((L, batch, cache_len, KV, hd)),
            "xk": meta((L, batch, T, KV, hd)), "xv": meta((L, batch, T, KV, hd)), "pos": meta((), torch.int32)}
