"""Mixture-of-Experts with sort-based token dispatch, single device.

The port of the JAX package's ``repro.models.moe``, its single-device part:
the router, the expert FFN and the grouped-GEMM dispatch of ``moe_tp``.
Dispatching tokens to experts is step 9 of SORT_DET_BSP: a stable integer
sort of the (token, choice) records by expert id, each expert's block then
one dense GEMM, and the records scattered back. The expert-parallel paths
(``moe_ep*``, ``moe_tp_sharded``, ``moe_ep_safe``, ``moe_ep_counts``) run
under ``shard_map`` in the reference and wait for the port's
``torch.distributed`` runner (ROADMAP.md, queue 1 item 5).

Two choices the reference makes implicitly are explicit here:

* **Top-k tie order.** ``lax.top_k`` puts the lower index first among
  equal values; ``torch.topk`` on CUDA promises no order, so the router
  takes the first k of a stable descending sort.
* **Deterministic gradients.** A gather with repeated indices adds its
  gradients by atomics in the backward pass (on the CPU's threads; a
  CUDA ``index_put_`` sorts them, serially per row). The dispatch's
  ``x2d[order // k]`` is a broadcast and a permutation instead, and the
  combine below gathers by a permutation too.
* **The combine.** The reference adds each record's weighted output into
  its token with one scatter-add, in sorted-record order. A scatter-add on
  CUDA orders its adds by atomics, so the port gathers each token's k
  records in that same order and sums them one after another in the
  model dtype: deterministic on every device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from .layers import _dense, dtype_of, top_k_stable


@dataclasses.dataclass(frozen=True)
class MoEMeshInfo:
    """How the MoE layer sees the mesh. The port has the single-device path
    only (``mesh=None``); a mesh waits for the ``torch.distributed`` runner."""

    mesh: object = None
    model_axis: str = "model"
    data_axes: tuple = ("data",)

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "the port's MoE has no mesh path yet: the expert-parallel dispatch "
                "waits for the torch.distributed runner (ROADMAP.md, queue 1 item 5)"
            )

    @property
    def model_size(self) -> int:
        return 1


def init_moe(gen: torch.Generator, cfg: ArchConfig, d_ff: Optional[int] = None) -> Dict[str, torch.Tensor]:
    D = cfg.d_model
    Fd = d_ff if d_ff is not None else cfg.d_ff
    E = cfg.moe_experts
    dt = dtype_of(cfg)
    return {
        "router": _dense(gen, (D, E), D, torch.float32),
        "w_gate": _dense(gen, (E, D, Fd), D, dt),
        "w_up": _dense(gen, (E, D, Fd), D, dt),
        "w_down": _dense(gen, (E, Fd, D), Fd, dt),
    }


def _router(x2d: torch.Tensor, w: torch.Tensor, top_k: int):
    """Top-k routing. x2d (T, D) -> (probs (T,k), experts (T,k), aux)."""
    logits = x2d.float() @ w
    probs_full = torch.softmax(logits, dim=-1)
    probs, experts = top_k_stable(probs_full, top_k)
    probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-9)
    # Shazeer-style load-balance loss + router z-loss
    e = w.shape[-1]
    me = probs_full.mean(0)
    # a scatter of ones, not bincount: bincount reads its input's maximum
    # back to the host, a sync a layer; integer counts are exact in any order
    flat = experts.reshape(-1)
    ce = torch.zeros(e, device=w.device).scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    ce = ce / max(experts.numel(), 1)
    aux_lb = e * torch.sum(me * ce)
    aux_z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return probs, experts.to(torch.int32), {"lb_loss": aux_lb, "z_loss": aux_z}


def _expert_ffn(x, wg, wu, wd):
    g = x @ wg
    u = x @ wu
    return (F.silu(g.float()).to(x.dtype) * u) @ wd


def _grouped_gemm_moe(params: Dict, x2d: torch.Tensor, cfg: ArchConfig, capacity_factor, lanes: int = 1):
    """Grouped-GEMM dispatch on a 2-D token block (paper step 9: stable
    integer sort by expert id → dense (E, C, D)·(E, D, F) GEMMs).

    ``lanes`` splits the T tokens into that many independent lanes of
    T / lanes consecutive tokens, each with the capacity rule applied to its
    own record count: the reference's serving engine decodes its slots as
    ``jax.vmap`` over batch-1 lanes, so each lane's MoE sees T = 1 and
    always has full capacity. With ``lanes=1`` this is the reference's
    dispatch record for record.
    """
    T, D = x2d.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    dev = x2d.device
    probs, experts, aux = _router(x2d, params["router"], k)

    n = (T // lanes) * k  # records per lane
    # decode/small-batch regime: full capacity (no record may ever drop at
    # serving time); capacity-managed at scale with the overflow flag
    cap = n if n <= 512 else int(-(-n * capacity_factor // E))
    N = T * k
    flat_e = experts.reshape(-1).long()  # record i = (token i//k, choice i%k)
    key = (torch.arange(N, device=dev) // n) * E + flat_e  # (lane, expert)
    order = torch.sort(key, stable=True).indices  # paper step 9
    sorted_key = key[order]
    # position of each record within its (lane, expert) block
    bounds = torch.searchsorted(sorted_key, torch.arange(lanes * E, device=dev), side="left")
    within = torch.arange(N, device=dev) - bounds[sorted_key]
    slot = sorted_key * cap + within
    ok = within < cap
    aux["overflow"] = torch.any(~ok)
    rows = lanes * E * cap
    slot = torch.where(ok, slot, rows)  # dropped records -> scratch row

    grouped = torch.zeros((rows + 1, D), dtype=x2d.dtype, device=dev)
    # x2d[order // k] as a broadcast and a permutation: its backward sums
    # each token's k record gradients by a reduction, in a fixed order,
    # where the gather's would add them by atomics; a dropped record's row
    # goes to the scratch row and its gradient (0) with it
    grouped[slot] = x2d[:, None, :].expand(T, k, D).reshape(N, D)[order]
    # (lane, expert, cap) rows -> one (lanes * cap)-row block per expert
    grouped = grouped[:-1].reshape(lanes, E, cap, D).transpose(0, 1).reshape(E, lanes * cap, D)
    h = torch.bmm(grouped, params["w_gate"])
    u = torch.bmm(grouped, params["w_up"])
    h = F.silu(h.float()).to(x2d.dtype) * u
    out_g = torch.bmm(h, params["w_down"])
    out_g = out_g.reshape(E, lanes, cap, D).transpose(0, 1).reshape(rows, D)

    # combine: gather each record's output back and weight it ...
    # a dropped record reads row i % rows (and gets zero): its index is only
    # a placeholder, and spread so the gather's backward (one sorted pass
    # that adds a row's repeats one after another) finds no long run of
    # repeats, where one clamped row would take every dropped record
    at = torch.where(ok, slot, torch.arange(N, device=dev) % rows)
    rec_out = torch.where(ok[:, None], out_g[at], torch.zeros((), dtype=x2d.dtype, device=dev))
    rec = (rec_out.float() * probs.reshape(-1)[order][:, None]).to(x2d.dtype)
    return _combine(rec, order, T, k), aux


def _combine(rec: torch.Tensor, order: torch.Tensor, T: int, k: int) -> torch.Tensor:
    """Sum the sorted records ``rec`` (record ``i`` belongs to token
    ``order[i] // k``) into their T tokens: each token's k records in
    sorted-record order, one add after another in ``rec``'s dtype — the
    order of the reference's scatter-add ``y.at[order // k].add(rec)``,
    without atomics."""
    at = torch.empty_like(order)
    at[order] = torch.arange(order.numel(), device=order.device)
    per_token = rec[torch.sort(at.reshape(T, k), dim=1).values]  # (T, k, D)
    y = torch.zeros((T, rec.shape[1]), dtype=rec.dtype, device=rec.device)
    for j in range(k):
        y = y + per_token[:, j]
    return y


def moe_tp(params: Dict, x: torch.Tensor, cfg: ArchConfig, capacity_factor=1.25, lanes: int = 1):
    """Grouped-GEMM MoE on one device (``lanes``: see ``_grouped_gemm_moe``)."""
    *lead, D = x.shape
    y, aux = _grouped_gemm_moe(params, x.reshape(-1, D), cfg, capacity_factor, lanes)
    return y.reshape(*lead, D), aux
