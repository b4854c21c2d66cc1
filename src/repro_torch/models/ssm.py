"""State-space / recurrent blocks: Mamba (S6) for jamba, mLSTM/sLSTM for xlstm.

The port of the JAX package's ``repro.models.ssm`` on one device. Both
families carry a constant-size recurrent state: training and prefill run
the recurrence over every position, decoding is one step on the carried
state, whatever the context length.

The reference runs each recurrence as a ``lax.scan`` over time; the port
runs it as Python loops over time steps, in float32, each element in the
reference's order of operations. That loop is the parity path: on the
card it issues 4 (Mamba), 5 (sLSTM) or 7 (mLSTM) ops a step and block, so
the card waits on the host (a fused scan for Hopper is later work). What
does not depend on the carry runs once over the whole sequence: the
projections and casts, the Mamba step's exp(dt A) and (dt x) B, the
mLSTM's v k^T; the xLSTM gates need only the stabiliser's chain
(``_gates``), and the normaliser n rides beside the memory as one more
row (mLSTM) or column (sLSTM) of the same update. Only the state's
contractions sum in another order than XLA's.

Simplifications of the published blocks (the reference's): Mamba keeps the
S6 selective scan with a low-rank Δ projection but has no groups; sLSTM
has no recurrent gate matrices (its gates see the input only); mLSTM keeps
the exponential gating with its stabiliser and per-head scalar gates.

Parameters are one layer's tensors (a dict or ``nn.ParameterDict``), where
the reference's carry a leading stacked axis.

On a mesh each block takes ``mesh``, the step's layout
(``models.transformer._MeshStep``), and its parameters' local blocks
(stored split over the model axis as ``models.sharding`` specs them):
Mamba runs on this rank's channels (``in_proj``'s product regrouped to
them, ``x1 @ w_xdbc`` summed over the model axis before the split into
dt, B and C); the mLSTM gathers q, k and v to every head and runs the
recurrence on all of them on every rank; the sLSTM runs on this rank's
channels of its four gates. Each returns the row-parallel output's
partial sum, which the caller sums over the model axis.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import _dense, dtype_of

#: the stabilisers' start: exp(log f + m - m_new) is exactly 0 at the first
#: step, with no NaN
M_START = -1e30


# ------------------------------------------------------------------ mamba
def mamba_dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    """(d_inner, d_state, d_conv, dt_rank)."""
    di = cfg.mamba_expand * cfg.d_model
    return di, cfg.mamba_d_state, cfg.mamba_d_conv, max(cfg.d_model // 16, 1)


def init_mamba(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    D = cfg.d_model
    di, N, dk, dtr = mamba_dims(cfg)
    dt, dev = dtype_of(cfg), gen.device
    return {
        "in_proj": _dense(gen, (D, 2 * di), D, dt),
        "conv_w": _dense(gen, (dk, di), dk, dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        "w_xdbc": _dense(gen, (di, dtr + 2 * N), di, dt),
        "w_dt": _dense(gen, (dtr, di), dtr, torch.float32),
        "b_dt": torch.full((di,), -4.6, dtype=torch.float32, device=dev),  # softplus ≈ 0.01
        "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=dev)).expand(di, N).clone(),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": _dense(gen, (di, D), di, dt),
    }


def _mamba_inner(p, x1: torch.Tensor, z: torch.Tensor, h0: torch.Tensor, cfg: ArchConfig, mesh=None):
    """Selective scan. x1 (B,S,di) post-conv, h0 (B,di,N). Returns y, h."""
    _, N, _, dtr = mamba_dims(cfg)
    A = -torch.exp(p["A_log"])  # (di, N)
    xdbc = x1 @ p["w_xdbc"]
    if mesh is not None:  # this rank's channels' share: summed before the softplus
        xdbc = mesh.psum_split(xdbc)
    xdbc = xdbc.float()
    dtr_part, B_part, C_part = torch.split(xdbc, [dtr, N, N], dim=-1)
    # F.softplus is x above 20 where the reference's is log1p(exp(x)): the
    # two differ by under 3e-9 there, and b_dt starts at -4.6
    dt = F.softplus(dtr_part @ p["w_dt"] + p["b_dt"])  # (B,S,di)
    # the step's inputs for every position at once: exp(dt A) and
    # (dt x) B, each (B,S,di,N); the loop carries h alone
    da = torch.exp(dt[..., None] * A)
    dbx = (dt * x1.float())[..., None] * B_part[:, :, None, :]
    h, ys = h0, []
    for da_t, dbx_t, c_t in zip(da.unbind(1), dbx.unbind(1), C_part[:, :, None, :].unbind(1)):
        h = da_t * h + dbx_t
        ys.append((h * c_t).sum(-1))  # (B,di)
    y = torch.stack(ys, dim=1) + p["D"] * x1.float()  # (B,S,di)
    y = y.to(x1.dtype) * F.silu(z.float()).to(x1.dtype)
    return y, h


def mamba_block(p, x: torch.Tensor, cfg: ArchConfig, state=None, mesh=None):
    """x (B,S,D) -> (y (B,S,D), state). state = (h (B,di,N), conv (B,dk-1,di)),
    di this rank's channels on a mesh, where x is the whole sequence."""
    b, s, _ = x.shape
    _, N, dk, _ = mamba_dims(cfg)
    xz = x @ p["in_proj"]
    if mesh is not None:
        xz = mesh.regroup(xz, 2)
    x1, z = torch.chunk(xz, 2, dim=-1)
    di = x1.shape[-1]
    if state is None:
        conv_st = torch.zeros((b, dk - 1, di), dtype=x.dtype, device=x.device)
        h0 = torch.zeros((b, di, N), dtype=torch.float32, device=x.device)
    else:
        h0, conv_st = state
    # causal conv over time with carried left context: the taps summed in
    # order, in the activation dtype, then the bias
    xc = torch.cat([conv_st, x1], dim=1)  # (B, S+dk-1, di)
    conv_w = p["conv_w"]
    conv = sum(xc[:, i : i + s, :] * conv_w[i] for i in range(dk)) + p["conv_b"]
    x1 = F.silu(conv.float()).to(x.dtype)
    y, h = _mamba_inner(p, x1, z, h0, cfg, mesh)
    out = y @ p["out_proj"]
    new_conv = xc[:, s:, :] if dk > 1 else conv_st  # the last dk-1 positions
    return out, (h, new_conv)


def mamba_state_shape(cfg: ArchConfig, batch: int):
    di, N, dk, _ = mamba_dims(cfg)
    return ((batch, di, N), (batch, dk - 1, di))


# ------------------------------------------------------------------ xlstm
def init_mlstm(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    D, H = cfg.d_model, cfg.n_heads
    dt, dev = dtype_of(cfg), gen.device
    return {
        "wq": _dense(gen, (D, D), D, dt),
        "wk": _dense(gen, (D, D), D, dt),
        "wv": _dense(gen, (D, D), D, dt),
        "wo": _dense(gen, (D, D), D, dt),
        "w_i": _dense(gen, (D, H), D, torch.float32),
        "w_f": _dense(gen, (D, H), D, torch.float32),
        "b_i": torch.zeros((H,), dtype=torch.float32, device=dev),
        "b_f": torch.full((H,), 3.0, dtype=torch.float32, device=dev),
        "up": _dense(gen, (D, 2 * D), D, dt),
        "down": _dense(gen, (2 * D, D), 2 * D, dt),
    }


def _root(hd: int, like: torch.Tensor) -> torch.Tensor:
    """sqrt(hd) in ``like``'s dtype: the reference divides an activation by
    ``jnp.sqrt(hd)``, a weakly typed float32 that takes the activation's
    dtype (bfloat16 rounds 5.657 to 5.656)."""
    return torch.full((), math.sqrt(hd), dtype=torch.float32, device=like.device).to(like.dtype)


def mlstm_core(p, x: torch.Tensor, cfg: ArchConfig, state=None, mesh=None):
    """Matrix-memory LSTM with exponential gating + stabiliser.

    state = (C (B,H,hd,hd), n (B,H,hd), m (B,H)), every head on every rank
    of a mesh.
    """
    b, s, D = x.shape
    H = cfg.n_heads
    hd = D // H

    def proj(name):  # every head's columns
        t = x @ p[name]
        return (t if mesh is None else mesh.gather_cols(t)).reshape(b, s, H, hd)

    q = proj("wq")
    k = proj("wk")
    k = k / _root(hd, k)
    v = proj("wv")
    xf = x.float()
    log_i = xf @ p["w_i"] + p["b_i"]  # (B,S,H)
    log_f = F.logsigmoid(xf @ p["w_f"] + p["b_f"])
    if state is None:
        C = torch.zeros((b, H, hd, hd), dtype=torch.float32, device=x.device)
        n = torch.zeros((b, H, hd), dtype=torch.float32, device=x.device)
        m = torch.full((b, H), M_START, dtype=torch.float32, device=x.device)
    else:
        C, n, m = state
    i_, f_, m = _gates(log_i, log_f, m)
    # n rides as row hd of the memory: its update f n + i k is the memory's
    # own with v = 1; and one contraction with q reads C q and n . q at once
    qf, kf = q.float().unsqueeze(3), k.float().unsqueeze(3)  # (B,S,H,1,hd)
    v1 = torch.cat([v.float(), torch.ones_like(kf[:, :, :, 0, :1])], dim=-1)  # (B,S,H,hd+1)
    vk = v1.unsqueeze(4) * kf  # (B,S,H,hd+1,hd)
    Cn = torch.cat([C, n[:, :, None, :]], dim=2)  # (B,H,hd+1,hd)
    reads = []
    for f_t, i_t, vk_t, q_t in zip(f_[..., None, None].unbind(1), i_[..., None, None].unbind(1), vk.unbind(1),
                                   qf.unbind(1)):
        Cn = f_t * Cn + i_t * vk_t
        reads.append((Cn * q_t).sum(-1))  # (B,H,hd+1): C q, then n . q
    r = torch.stack(reads, dim=1)
    h = r[..., :hd] / torch.clamp(torch.abs(r[..., hd:]), min=1.0)
    h = h.reshape(b, s, D).to(x.dtype)
    if mesh is not None:
        h = mesh.chunk_cols(h)  # the rows of wo this rank holds
    return h @ p["wo"], (Cn[:, :, :hd], Cn[:, :, hd], m)


def _gates(log_i: torch.Tensor, log_f: torch.Tensor, m0: torch.Tensor):
    """The exponential gates under the stabiliser, for every position:
    ``(i, f, last m)``. The chain m_t = max(log f_t + m_{t-1}, log i_t) is
    the only carry they need; i = exp(log i - m_t) and f = exp(log f +
    m_{t-1} - m_t) then take one op each over the whole sequence, each
    element as the reference computes it."""
    ms, m = [], m0
    for li, lf in zip(log_i.unbind(1), log_f.unbind(1)):
        m = torch.maximum(lf + m, li)
        ms.append(m)
    m_all = torch.stack(ms, dim=1)
    m_prev = torch.cat([m0[:, None], m_all[:, :-1]], dim=1)
    return torch.exp(log_i - m_all), torch.exp(log_f + m_prev - m_all), m


def init_slstm(gen: torch.Generator, cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    D = cfg.d_model
    dt, dev = dtype_of(cfg), gen.device
    return {
        "w_zifo": _dense(gen, (D, 4 * D), D, torch.float32),
        "b_zifo": torch.zeros((4 * D,), dtype=torch.float32, device=dev),
        "up": _dense(gen, (D, 2 * D), D, dt),
        "down": _dense(gen, (2 * D, D), 2 * D, dt),
        "wo": _dense(gen, (D, D), D, dt),
    }


def slstm_core(p, x: torch.Tensor, cfg: ArchConfig, state=None, mesh=None):
    """Scalar-memory LSTM with exponential gating. state = (c, n, m) (B,D),
    D this rank's channels on a mesh (``b_zifo`` then this rank's channels
    of each gate)."""
    zifo = x.float() @ p["w_zifo"]
    if mesh is not None:
        zifo = mesh.regroup(zifo, 4)
    zifo = zifo + p["b_zifo"]
    b, s, D = x.shape[0], x.shape[1], zifo.shape[-1] // 4
    z, log_i, f_pre, o = torch.chunk(zifo, 4, dim=-1)
    log_f = F.logsigmoid(f_pre)
    if state is None:
        c = torch.zeros((b, D), dtype=torch.float32, device=x.device)
        n = torch.zeros((b, D), dtype=torch.float32, device=x.device)
        m = torch.full((b, D), M_START, dtype=torch.float32, device=x.device)
    else:
        c, n, m = state
    i_, f_, m = _gates(log_i, log_f, m)
    # n rides beside c: its update f n + i is c's own with tanh z = 1
    u = torch.stack([torch.tanh(z), torch.ones_like(z)], dim=-1)  # (B,S,D,2)
    cn = torch.stack([c, n], dim=-1)
    cns = []
    for f_t, i_t, u_t in zip(f_[..., None].unbind(1), i_[..., None].unbind(1), u.unbind(1)):
        cn = f_t * cn + i_t * u_t
        cns.append(cn)
    c_all, n_all = torch.stack(cns, dim=1).unbind(-1)
    h = (torch.sigmoid(o) * c_all / torch.clamp(n_all, min=1.0)).to(x.dtype)
    return h @ p["wo"], (cn[..., 0], cn[..., 1], m)


def xlstm_proj(p, x: torch.Tensor) -> torch.Tensor:
    """Post-core up/down projection (in place of the FFN: d_ff = 0).
    ``jax.nn.gelu`` defaults to the tanh form."""
    u = x @ p["up"]  # (.., 2D)
    h = F.gelu(u.float(), approximate="tanh").to(x.dtype)
    return h @ p["down"]
