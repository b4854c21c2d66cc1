"""xLSTM LM: mLSTM blocks with an sLSTM block every ``slstm_every`` layers.

The port of the JAX package's ``repro.models.xlstm`` on one device.
``params.mlstm[i]`` and ``params.slstm[i]`` hold the i-th block of each
kind (its ``norm``, ``norm2``, core and up/down projection leaves); the
stack runs them interleaved in layer order. No attention, no MoE, and no
rematerialization (the reference applies none here).

The cache is the recurrent state only, O(1) in the context length:
``{"mlstm": (C (nm, B, H, hd, hd), n (nm, B, H, hd), m (nm, B, H)),
"slstm": (c, n, m) each (ns, B, D), "pos"}``, float32, updated in place.

On a mesh (serving under ``1d`` or ``2d``; the reference trains this
family under ``dp`` only) the steps are tensor-parallel
(``models.transformer._MeshStep``): q, k and v gathered to every head, the
mLSTM's recurrence run on every model rank, the sLSTM's on this rank's
channels of its four gates, every row-parallel output summed over the
model axis. The state is placed as the sanitized ``cache_specs`` place it:
the batch over the data axes, replicated over the model axis, every copy
the same (the sLSTM's channels are gathered back after each block).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import ssm
from . import transformer as tfm
from .layers import _dense, dtype_of, next_token_loss, rmsnorm


def _layout(cfg: ArchConfig) -> Tuple[List[int], List[int]]:
    ks = cfg.slstm_every or (cfg.n_layers + 1)
    slstm_ids = [i for i in range(cfg.n_layers) if (i + 1) % ks == 0]
    mlstm_ids = [i for i in range(cfg.n_layers) if (i + 1) % ks != 0]
    return mlstm_ids, slstm_ids


def stacks(cfg: ArchConfig) -> Dict[str, int]:
    """The model's stacked containers and their lengths."""
    mids, sids = _layout(cfg)
    return {"mlstm": len(mids), "slstm": len(sids)}


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """Random parameters on the generator's device, by state-dict name
    (``embed``, ``mlstm.<i>.<leaf>``, ``slstm.<i>.<leaf>``, ``final_norm``,
    ``lm_head``)."""
    D, V = cfg.d_model, cfg.vocab
    dt, dev = dtype_of(cfg), gen.device
    out = {"embed": _dense(gen, (V, D), D, dt)}
    for kind, init in (("mlstm", ssm.init_mlstm), ("slstm", ssm.init_slstm)):
        for i in range(stacks(cfg)[kind]):
            leaves = {"norm": torch.ones((D,), dtype=dt, device=dev),
                      "norm2": torch.ones((D,), dtype=dt, device=dev), **init(gen, cfg)}
            out.update({f"{kind}.{i}.{leaf}": t for leaf, t in leaves.items()})
    out["final_norm"] = torch.ones((D,), dtype=dt, device=dev)
    out["lm_head"] = _dense(gen, (D, V), D, dt)
    return out


def _block(core, cfg, x, lp, state=None):
    h = rmsnorm(x, lp["norm"], cfg.norm_eps)
    o, st = core(lp, h, cfg, state)
    x = x + o
    h2 = rmsnorm(x, lp["norm2"], cfg.norm_eps)
    return x + ssm.xlstm_proj(lp, h2), st


def _mesh_block(core, cfg, x, lp, state, ms):
    """:func:`_block` on a mesh: this rank's column blocks of the
    projections, the row-parallel outputs summed into the residual
    layout."""
    bax = ms.bax
    h = ms.gather_seq(rmsnorm(x, ms.fetch(lp["norm"]), cfg.norm_eps))
    if core is ssm.mlstm_core:
        p = {k: ms.fetch(lp[k], 1, bax) for k in ("wq", "wk", "wv")}
        p.update({k: ms.fetch(lp[k]) for k in ("w_i", "w_f", "b_i", "b_f")}, wo=ms.fetch(lp["wo"], 0, bax))
        o, st = core(p, h, cfg, state, mesh=ms)
    else:
        b_zifo = ms.chunk_cols(ms.fetch(lp["b_zifo"]).reshape(4, -1)).reshape(-1)  # this rank's channels
        p = {"w_zifo": ms.fetch(lp["w_zifo"], 1, bax), "b_zifo": b_zifo, "wo": ms.fetch(lp["wo"], 0, bax)}
        local = None if state is None else tuple(ms.chunk_cols(t) for t in state)
        o, st = core(p, h, cfg, local, mesh=ms)
        st = tuple(ms.gather_cols(t) for t in st)  # every channel again: the copies stay equal
    x = x + ms.reduce_seq(o)
    h2 = ms.gather_seq(rmsnorm(x, ms.fetch(lp["norm2"]), cfg.norm_eps))
    y = ssm.xlstm_proj({"up": ms.fetch(lp["up"], 1, bax), "down": ms.fetch(lp["down"], 0, bax)}, h2)
    return x + ms.reduce_seq(y), st


def _stack(cfg, params, x, states=None, ms=None):
    """Run the interleaved stack; with ``states`` (a cache) each block
    starts from its carried state and writes its new one back in place.
    ``ms``: the mesh step's layout. Returns ``(x, [(kind, index, new
    state), ...])``."""
    _, sids = _layout(cfg)
    new = []
    im = is_ = 0
    for i in range(cfg.n_layers):
        if i in sids:
            kind, j, core = "slstm", is_, ssm.slstm_core
            is_ += 1
        else:
            kind, j, core = "mlstm", im, ssm.mlstm_core
            im += 1
        st = None if states is None else tuple(t[j] for t in states[kind])
        lp = getattr(params, kind)[j]
        x, st = _block(core, cfg, x, lp, st) if ms is None else _mesh_block(core, cfg, x, lp, st, ms)
        new.append((kind, j, st))
    return x, new


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
    x, _ = _stack(cfg, params, _embed(params, tokens))
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = x @ params.lm_head
    return next_token_loss(logits[:, :-1], labels[:, 1:]), {}


def _write(cache: Dict, new) -> None:
    for kind, j, st in new:
        for t, s in zip(cache[kind], st):
            t[j] = s


def prefill(
    cfg: ArchConfig,
    params,
    tokens: torch.Tensor,
    mesh_info=None,
    extras: Optional[Dict] = None,
    cache_len: Optional[int] = None,
) -> Tuple[Dict, torch.Tensor]:
    """Run the prompt, build the recurrent state. Returns (cache, last logits)."""
    if tfm._on_mesh(mesh_info):
        return _prefill_mesh(cfg, params, tokens, mesh_info)
    b, s = tokens.shape
    x, new = _stack(cfg, params, _embed(params, tokens))
    x = rmsnorm(x[:, -1:], params.final_norm, cfg.norm_eps)
    logits = (x @ params.lm_head)[:, 0]
    cache = {kind: tuple(torch.zeros(t.shape, dtype=t.dtype, device=x.device) for t in ts)
             for kind, ts in cache_shapes(cfg, b, 0).items() if kind != "pos"}
    _write(cache, new)
    cache["pos"] = torch.full((), s - 1, dtype=torch.int32, device=x.device)
    return cache, logits


def decode_step(
    cfg: ArchConfig,
    params,
    cache: Dict,
    token: torch.Tensor,  # (B,) previous token
    mesh_info=None,
) -> Tuple[torch.Tensor, Dict]:
    """One autoregressive step on the carried state (updated in place);
    ``cache['pos']`` (a scalar or one per lane) only counts."""
    if tfm._on_mesh(mesh_info):
        return _decode_step_mesh(cfg, params, cache, token, mesh_info)
    x = params.embed[token.long()][:, None, :]
    x, new = _stack(cfg, params, x, states=cache)
    _write(cache, new)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = (x @ params.lm_head)[:, 0]
    return logits, {"mlstm": cache["mlstm"], "slstm": cache["slstm"], "pos": cache["pos"] + 1}


def _prefill_mesh(cfg, params, tokens, mesh_info):
    """``prefill`` on a mesh: the state comes back as ``DTensor``s placed by
    the sanitized ``cache_specs``, the last logits as one full (B, V)
    tensor on every rank."""
    b, s = tokens.shape
    ms = tfm._serving_step(cfg, mesh_info, b, s)
    x = tfm._mesh_embed(cfg, ms, params, tokens, {})
    shapes = cache_shapes(cfg, b, 0)
    specs, cache = tfm._mesh_cache(cfg, ms, shapes, x.device)
    x, new = _stack(cfg, params, x, ms=ms)
    _write(cache, new)
    cache["pos"] = torch.full((), s - 1, dtype=torch.int32, device=x.device)
    return tfm._placed_cache(ms, specs, cache, shapes), tfm._last_logits(cfg, ms, params, x)


def _decode_step_mesh(cfg, params, cache, token, mesh_info):
    """``decode_step`` on a mesh: this rank's rows of the state, updated in
    place, every model rank's copy alike."""
    ms = tfm._serving_step(cfg, mesh_info, token.shape[0], 1)
    local = {kind: tuple(t.to_local() for t in cache[kind]) for kind in ("mlstm", "slstm")}
    x = F.embedding(token[ms.block_rows].long(), ms.fetch(params.embed))[:, None, :]
    x, new = _stack(cfg, params, x, states=local, ms=ms)
    _write(local, new)
    logits = tfm._last_logits(cfg, ms, params, x)
    return logits, {"mlstm": cache["mlstm"], "slstm": cache["slstm"], "pos": cache["pos"] + 1}


def cache_shapes(cfg: ArchConfig, batch: int, cache_len: int) -> Dict:
    """The state's tensors on the ``meta`` device; ``cache_len`` is
    unused: the state does not grow with the context."""
    del cache_len
    n = stacks(cfg)
    D, H = cfg.d_model, cfg.n_heads
    hd = D // H
    nm, ns = n["mlstm"], n["slstm"]

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device="meta")

    return {
        "mlstm": (f32(nm, batch, H, hd, hd), f32(nm, batch, H, hd), f32(nm, batch, H)),
        "slstm": (f32(ns, batch, D), f32(ns, batch, D), f32(ns, batch, D)),
        "pos": torch.empty((), dtype=torch.int32, device="meta"),
    }
