"""xLSTM LM: mLSTM blocks with an sLSTM block every ``slstm_every`` layers.

The port of the JAX package's ``repro.models.xlstm`` on one device.
``params.mlstm[i]`` and ``params.slstm[i]`` hold the i-th block of each
kind (its ``norm``, ``norm2``, core and up/down projection leaves); the
stack runs them interleaved in layer order. No attention, no MoE, and no
rematerialization (the reference applies none here).

The cache is the recurrent state only, O(1) in the context length:
``{"mlstm": (C (nm, B, H, hd, hd), n (nm, B, H, hd), m (nm, B, H)),
"slstm": (c, n, m) each (ns, B, D), "pos"}``, float32, updated in place.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from . import ssm
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


def _stack(cfg, params, x, states=None):
    """Run the interleaved stack; with ``states`` (a cache) each block
    starts from its carried state and writes its new one back in place.
    Returns ``(x, [(kind, index, new state), ...])``."""
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
        x, st = _block(core, cfg, x, getattr(params, kind)[j], st)
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
    x = params.embed[token.long()][:, None, :]
    x, new = _stack(cfg, params, x, states=cache)
    _write(cache, new)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = (x @ params.lm_head)[:, 0]
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
