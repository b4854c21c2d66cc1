"""Mixture-of-Experts with sort-based token dispatch.

The port of the JAX package's ``repro.models.moe``. Dispatching tokens to
experts is steps 9–11 of SORT_DET_BSP: a stable integer sort of the
(token, choice) records by expert id, then one balanced all-to-all, the
stable inverse permutation restoring token order. Paths:

* ``moe_tp`` — one device: the grouped-GEMM dispatch, each expert's block
  one dense GEMM, the records scattered back.
* ``moe_ep`` — expert parallelism over the ``model`` axis of a
  ``DeviceMesh`` (``torch.distributed``). Each rank holds its block of the
  tokens (B over the data axes, S over the model axis when they divide)
  and its E / model_size experts. It sorts its records by expert, cuts
  one row per model shard, and sends them by ONE byte-packed
  ``all_to_all`` (expert ids and token rows in one buffer,
  ``core/routing.pack_bytes``) at a capacity of ⌈n·cf/p⌉ records a row;
  overflow is detected and surfaced (``aux['overflow']``), never silent.
  The reverse ``all_to_all`` and the stable unsort are the combine.
* ``moe_ep_decode`` — few tokens: every model shard evaluates its experts
  on every token of its data shard, combined by one ``all_reduce``.
* ``moe_tp_sharded`` — experts replicated, their FFN width split over the
  model axis: a row-parallel FFN with one ``all_reduce`` of the (T_loc, D)
  output. Its tokens are sharded over the data axes only: every model
  shard must hold the same tokens for that sum to be one token's. (The
  JAX package also shards S over the model axis here when it divides,
  which sums the partial outputs of different tokens; the port does not
  copy that.)
* ``moe_ep_safe`` — the capacity ladder (whp → whp2 → full) of the sort
  driver over ``moe_ep``, or ``route="radix"``: the exact counts from
  ``moe_ep_counts`` first, then one dispatch that cannot overflow.

Each rank passes its own blocks: :func:`token_block` cuts a rank's tokens
from the global batch and :func:`expert_block` / :func:`ffn_block` its
weights, as the reference's ``shard_map`` specs do. The router's aux terms
are averaged and the overflow flag maxed over every axis of the mesh; or,
with ``aux_over`` (the transformer's mesh steps), the aux terms are the
whole batch's, from the router's statistics summed over the token axes,
as on one device.

The mesh paths are differentiable, each collective with its own
transpose: the dispatch's byte-packed ``all_to_all`` sends only the rows'
gradient back along the reverse exchange (the JAX package's bitcast
passes none), the combine's exchange is its own transpose
(``sharding.exchange``), a row-parallel ``psum`` passes each rank its
gradient unchanged (``sharding.psum``), and a mean over the mesh passes
1/n of it.

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

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import obs as obs_mod
from ..configs.base import ArchConfig
from ..core import routing
from ..core.api import TierStats
from ..core.primitives import GroupProcs, LocalProcs
from . import sharding as shd
from .layers import _dense, dtype_of, top_k_stable


@dataclasses.dataclass(frozen=True)
class MoEMeshInfo:
    """How the MoE layer sees the mesh: a ``DeviceMesh`` and the names of
    its model axis and data axes (``mesh=None``: one device)."""

    mesh: object = None
    model_axis: str = "model"
    data_axes: tuple = ("data",)

    def __post_init__(self):
        if self.mesh is not None and not hasattr(self.mesh, "mesh_dim_names"):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh, not {type(self.mesh).__name__}")

    def size(self, axis: str) -> int:
        return self.mesh.size(self.mesh.mesh_dim_names.index(axis))

    @property
    def model_size(self) -> int:
        return 1 if self.mesh is None else self.size(self.model_axis)

    @property
    def data_size(self) -> int:
        return 1 if self.mesh is None else math.prod(self.size(a) for a in self.data_axes)

    def index(self, axis: str) -> int:
        return self.mesh.get_local_rank(axis)

    @property
    def data_index(self) -> int:
        """This rank's place along the data axes, the first axis major."""
        i = 0
        for a in self.data_axes:
            i = i * self.size(a) + self.index(a)
        return i

    def model_procs(self):
        """The model axis as a processor group (one processor without a mesh)."""
        return LocalProcs(1) if self.mesh is None else GroupProcs.from_mesh(self.mesh, self.model_axis)

    def axis_procs(self) -> list:
        """Every axis of the mesh as a processor group, data axes first."""
        if self.mesh is None:
            return []
        return [GroupProcs.from_mesh(self.mesh, a) for a in (*self.data_axes, self.model_axis)]


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


@dataclasses.dataclass(frozen=True)
class AuxOver:
    """The router's aux terms as the one-device terms of the whole batch:
    their token statistics summed over ``axes`` (processor groups of the
    mesh axes over which the tokens differ). ``redundant`` > 1 when every
    rank along an axis of that many ranks routes the same tokens and the
    caller sums their input gradients over it: the statistics then pass
    1/redundant of their gradient back on each."""

    axes: tuple = ()
    redundant: int = 1


#: the list :func:`counting_drops` collects into; None while it is off
_DROPS: Optional[list] = None


@contextlib.contextmanager
def counting_drops():
    """Count the records the capacity rule drops: yields a list to which
    each MoE call of a train or prefill step appends its whole batch's
    count (a 0-d int64 tensor, the same on every rank of a mesh step;
    a rematerialized block appends again). A mesh step's counts are then
    held to one process's, record for record of the batch."""
    global _DROPS
    prev, _DROPS = _DROPS, []
    try:
        yield _DROPS
    finally:
        _DROPS = prev


def _note_drops(dropped: torch.Tensor, aux_over: Optional[AuxOver]) -> None:
    """Append the sum of ``dropped`` (this rank's mask of dropped records,
    or their count) over the whole batch (``aux_over``'s axes of distinct
    tokens) to the :func:`counting_drops` list, if it is on."""
    if _DROPS is None:
        return
    n = dropped.detach().to(torch.int64).sum()
    for a in () if aux_over is None else aux_over.axes:
        n = a.all_reduce(n)
    _DROPS.append(n)


def _router(x2d: torch.Tensor, w: torch.Tensor, top_k: int, aux_over: Optional[AuxOver] = None):
    """Top-k routing. x2d (T, D) -> (probs (T,k), experts (T,k), aux)."""
    logits = x2d.float() @ w
    probs_full = torch.softmax(logits, dim=-1)
    probs, experts = top_k_stable(probs_full, top_k)
    probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-9)
    # Shazeer-style load-balance loss + router z-loss
    e = w.shape[-1]
    # a scatter of ones, not bincount: bincount reads its input's maximum
    # back to the host, a sync a layer; integer counts are exact in any order
    flat = experts.reshape(-1)
    ce = torch.zeros(e, device=w.device).scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    lse2 = torch.logsumexp(logits, dim=-1) ** 2
    if aux_over is not None:
        return probs, experts.to(torch.int32), _global_aux(probs_full, ce, lse2, top_k, aux_over)
    me = probs_full.mean(0)
    ce = ce / max(experts.numel(), 1)
    aux_lb = e * torch.sum(me * ce)
    aux_z = torch.mean(lse2)
    return probs, experts.to(torch.int32), {"lb_loss": aux_lb, "z_loss": aux_z}


def _global_aux(probs_full, counts, lse2, top_k: int, aux_over: AuxOver) -> Dict:
    """The aux terms of every token over ``aux_over.axes``: the sums of the
    router's probabilities, choice counts and squared log-normalizers, and
    the token count, in one float32 tensor summed over each axis."""
    e = probs_full.shape[-1]
    pf, l2 = probs_full, lse2
    if aux_over.redundant > 1:
        pf, l2 = shd.scale_grad(pf, 1.0 / aux_over.redundant), shd.scale_grad(l2, 1.0 / aux_over.redundant)
    t = torch.full((1,), float(probs_full.shape[0]), device=pf.device)
    packed = torch.cat([pf.sum(0), counts, l2.sum()[None], t])
    for a in aux_over.axes:
        packed = shd.psum(packed, a)
    n_tok = packed[-1]
    me = packed[:e] / n_tok
    ce = packed[e : 2 * e] / (n_tok * top_k)
    return {"lb_loss": e * torch.sum(me * ce), "z_loss": packed[2 * e] / n_tok}


# ------------------------------------------------ the EP dispatch
class _Dispatch(torch.autograd.Function):
    """The EP dispatch: ONE byte-packed ``all_to_all`` of the records'
    expert ids and token rows (``core/routing.pack_bytes``). The ids carry
    no gradient, so the backward sends only the rows' gradient back, along
    the reverse ``all_to_all``."""

    @staticmethod
    def forward(ctx, rows_x, rows_e, procs):
        ctx.procs = procs
        fused, metas = routing.pack_bytes([rows_e, rows_x], lead=2)
        recv_e, recv_x = routing.unpack_bytes(procs.all_to_all(fused[None])[0], metas, lead=2)
        ctx.mark_non_differentiable(recv_e)
        return recv_x, recv_e

    @staticmethod
    def backward(ctx, g_x, g_e):
        return ctx.procs.all_to_all(g_x.contiguous()[None])[0], None, None


def _expert_ffn(x, wg, wu, wd):
    g = x @ wg
    u = x @ wu
    return (F.silu(g.float()).to(x.dtype) * u) @ wd


def _grouped_gemm_moe(params: Dict, x2d: torch.Tensor, cfg: ArchConfig, capacity_factor, lanes: int = 1,
                      aux_over: Optional[AuxOver] = None, rule: Optional["OneDeviceCap"] = None, rows: int = 1):
    """Grouped-GEMM dispatch on a 2-D token block (paper step 9: stable
    integer sort by expert id → dense (E, C, D)·(E, D, F) GEMMs).

    ``lanes`` splits the T tokens into that many independent lanes of
    T / lanes consecutive tokens, each with the capacity rule applied to its
    own record count: the reference's serving engine decodes its slots as
    ``jax.vmap`` over batch-1 lanes, so each lane's MoE sees T = 1 and
    always has full capacity. With ``lanes=1`` this is the reference's
    dispatch record for record. On a mesh, ``rule`` keeps the records the
    one-device rule keeps over the whole batch (``x2d`` is ``rows`` rows
    of this rank's tokens); the kept records of an expert are a prefix of
    its records here, so its block needs room for at most them.
    """
    T, D = x2d.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    dev = x2d.device
    probs, experts, aux = _router(x2d, params["router"], k, aux_over)

    n = (T // lanes) * k  # records per lane
    # decode/small-batch regime: full capacity (no record may ever drop at
    # serving time); capacity-managed at scale with the overflow flag
    cap = n if n <= 512 else int(-(-n * capacity_factor // E))
    if rule is not None:
        cap = min(n, rule.cap)
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
    if rule is not None:
        ok = one_device_keep(experts, rows, rule, E)[order]
    aux["overflow"] = torch.any(~ok)
    _note_drops(~ok, aux_over)
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


def _local_experts(rows: torch.Tensor, local_e: torch.Tensor, params: Dict, e_loc: int) -> torch.Tensor:
    """Each received row through its local expert ``local_e`` (0 .. e_loc-1;
    a padding row, any other id, gives 0): the rows sorted by expert (a
    permutation, both ways), one host read of the e_loc + 1 counts, and
    each expert's FFN on its own slice. (The reference runs every local
    expert on every row and masks: e_loc times the products.) On ``meta``
    tensors (the dry-run's trace, which cannot read the counts) the rows
    split evenly over the experts, the products the card runs on an even
    routing."""
    w = [(params["w_gate"][e], params["w_up"][e], params["w_down"][e]) for e in range(e_loc)]
    if rows.is_meta:
        order = torch.arange(rows.shape[0], device=rows.device)
        q = rows.shape[0] // e_loc
        sizes = [q] * e_loc + [rows.shape[0] - q * e_loc]
    else:
        key = torch.where((local_e >= 0) & (local_e < e_loc), local_e, torch.full_like(local_e, e_loc)).long()
        order = torch.sort(key, stable=True).indices
        sizes = torch.zeros(e_loc + 1, dtype=torch.int64, device=key.device).scatter_add_(
            0, key, torch.ones_like(key)).tolist()
    parts = torch.split(rows[order], sizes)
    outs = [_expert_ffn(parts[e], *w[e]) for e in range(e_loc)] + [torch.zeros_like(parts[-1])]
    out = torch.empty_like(rows)
    out[order] = torch.cat(outs)
    return out


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


def moe_tp(params: Dict, x: torch.Tensor, cfg: ArchConfig, capacity_factor=1.25, lanes: int = 1,
           aux_over: Optional[AuxOver] = None, rule: Optional["OneDeviceCap"] = None):
    """Grouped-GEMM MoE on one device (``lanes``: see ``_grouped_gemm_moe``).
    Under the ``dp`` policy each rank runs it on its own (B_loc, S) rows:
    ``aux_over`` sums the router's statistics and ``rule`` applies the
    capacity rule over the whole batch; the overflow flag is this rank's."""
    *lead, D = x.shape
    y, aux = _grouped_gemm_moe(params, x.reshape(-1, D), cfg, capacity_factor, lanes, aux_over, rule,
                               x.shape[0] if x.dim() == 3 else 1)
    return y.reshape(*lead, D), aux


# ------------------------------------------------------- the mesh's blocks
def _dp_spec(mesh_info: MoEMeshInfo, batch: int):
    """Batch sharding over the data axes, or replication when indivisible
    (the global_batch=1 long-context decode cell)."""
    return mesh_info.data_axes if batch % mesh_info.data_size == 0 else None


def token_slices(shape, mesh_info: MoEMeshInfo, seq_shard: bool) -> Tuple[slice, slice]:
    """This rank's (batch, sequence) slices of global (B, S, D) tokens: B
    over the data axes when it divides, S over the model axis when
    ``seq_shard`` and it divides (the reference's ``P(dp, seq, None)``)."""
    b, s = shape[0], shape[1]
    bs, ss = slice(0, b), slice(0, s)
    if mesh_info.mesh is None:
        return bs, ss
    if _dp_spec(mesh_info, b) is not None:
        n = b // mesh_info.data_size
        bs = slice(mesh_info.data_index * n, (mesh_info.data_index + 1) * n)
    p = mesh_info.model_size
    if seq_shard and s % p == 0:
        n = s // p
        m = mesh_info.index(mesh_info.model_axis)
        ss = slice(m * n, (m + 1) * n)
    return bs, ss


def token_block(x: torch.Tensor, mesh_info: MoEMeshInfo, seq_shard: bool = True) -> torch.Tensor:
    """This rank's block of global (B, S, D) tokens (see :func:`token_slices`):
    ``seq_shard=True`` for ``moe_ep`` and ``moe_ep_counts``, False for
    ``moe_ep_decode`` and ``moe_tp_sharded``."""
    bs, ss = token_slices(x.shape, mesh_info, seq_shard)
    return x[bs, ss]


def expert_block(params: Dict[str, torch.Tensor], mesh_info: MoEMeshInfo) -> Dict[str, torch.Tensor]:
    """This rank's experts: the router whole, the expert weights' E
    dimension split over the model axis (``P(model, None, None)``)."""
    p = mesh_info.model_size
    E = params["w_gate"].shape[0]
    if E % p:
        raise ValueError(f"the EP paths need the {E} experts divisible by the model axis ({p})")
    m = 0 if mesh_info.mesh is None else mesh_info.index(mesh_info.model_axis)
    e = slice(m * (E // p), (m + 1) * (E // p))
    return {"router": params["router"], **{k: params[k][e] for k in ("w_gate", "w_up", "w_down")}}


def ffn_block(params: Dict[str, torch.Tensor], mesh_info: MoEMeshInfo) -> Dict[str, torch.Tensor]:
    """This rank's slice of every expert's FFN width (``moe_tp_sharded``):
    ``w_gate``/``w_up`` split on F (their last dimension), ``w_down`` on F
    (its middle one)."""
    p = mesh_info.model_size
    Fd = params["w_gate"].shape[-1]
    m = 0 if mesh_info.mesh is None else mesh_info.index(mesh_info.model_axis)
    f = slice(m * (Fd // p), (m + 1) * (Fd // p))
    return {"router": params["router"], "w_gate": params["w_gate"][..., f], "w_up": params["w_up"][..., f],
            "w_down": params["w_down"][:, f]}


def _reduce_aux(aux: Dict, axes: list, flag: Optional[torch.Tensor] = None) -> Dict:
    """The aux terms averaged over every rank of the mesh (``pmean``) and
    ``flag`` raised where any rank raised it (``pmax``): the terms and the
    flag packed in one float32 tensor, one ``all_reduce`` per mesh axis.
    Without ``flag`` the result holds no ``overflow``."""
    if not axes:
        return aux if flag is None else {**aux, "overflow": flag}
    keys = list(aux)
    terms = [aux[k].float() for k in keys] + ([] if flag is None else [flag.float()])
    packed = torch.stack(terms)
    for a in axes:
        packed = shd.psum(packed, a)  # a mean's backward: 1/n to every rank
    n = math.prod(a.p for a in axes)
    out = {k: (packed[i] / n).to(aux[k].dtype) for i, k in enumerate(keys)}
    if flag is not None:
        out["overflow"] = packed[-1] > 0
    return out


def _psum_model(y: torch.Tensor, mesh_info: MoEMeshInfo) -> torch.Tensor:
    """The row-parallel sum over the model axis (identity backward)."""
    return y if mesh_info.mesh is None else shd.psum(y, mesh_info.model_procs())


def _finish_aux(aux: Dict, mesh_info: MoEMeshInfo, flag, aux_over: Optional[AuxOver]) -> Dict:
    """The aux terms leaving a mesh path: averaged over every rank (the
    reference's ``pmean``), or already the whole batch's under
    ``aux_over``; ``flag`` raised where any rank raised it."""
    if aux_over is None:
        return _reduce_aux(aux, mesh_info.axis_procs(), flag)
    if flag is not None:
        for a in mesh_info.axis_procs():
            flag = a.any(flag)
        aux = {**aux, "overflow": flag}
    return aux


# -------------------------------------------------------------- the TP path
def moe_tp_sharded(params: Dict, x: torch.Tensor, cfg: ArchConfig, mesh_info: MoEMeshInfo,
                   capacity_factor=1.25, aux_over: Optional[AuxOver] = None, rule: Optional["OneDeviceCap"] = None,
                   reduce=None):
    """Grouped-GEMM MoE with the experts' FFN width split over the model
    axis. ``x`` is this rank's (B_loc, S, D) block (``token_block(...,
    seq_shard=False)``), ``params`` its :func:`ffn_block`. The only
    collective is ONE ``all_reduce`` of the (T_loc, D) output over the
    model axis, the row-parallel reduction. The transformer's mesh steps
    pass ``aux_over`` and ``rule`` (the whole batch's aux terms and
    capacity rule, as on one device) and ``reduce``, which takes the
    (B_loc, S, D) partial sums in place of that ``all_reduce`` (they
    reduce-scatter them into their residual layout)."""
    bl, sl, D = x.shape
    y, aux = _grouped_gemm_moe(params, x.reshape(-1, D), cfg, capacity_factor, aux_over=aux_over, rule=rule,
                               rows=bl)
    y = y.reshape(bl, sl, D)
    y = _psum_model(y, mesh_info) if reduce is None else reduce(y)
    ov = aux.pop("overflow")
    return y, _finish_aux(aux, mesh_info, ov, aux_over)


# --------------------------------------------------------- the EP (a2a) path
@dataclasses.dataclass(frozen=True)
class OneDeviceCap:
    """The one-device capacity rule on a mesh: ``cap`` records an expert
    over the whole batch, kept in the batch's token order (rows of (B, S)
    in order, a token's choices in order), the rest dropped, as
    ``_grouped_gemm_moe`` drops them on one device. A rank holds rows
    ``B_loc`` of the batch (split over ``batch``, processor groups in the
    mesh's order, the first major) and, with ``seq`` (the model axis'
    group), a slice of each row's positions."""

    cap: int
    batch: tuple = ()
    seq: object = None


def one_device_keep(experts: torch.Tensor, rows: int, rule: OneDeviceCap, n_experts: int) -> torch.Tensor:
    """Which of this rank's records (``experts``: (T_loc, k), T_loc =
    ``rows`` local rows of positions in order) the one-device rule keeps:
    those with fewer than ``rule.cap`` records of their expert before them
    in the batch. Counts of each (row, expert) are gathered over the model
    axis and each row's totals over the batch axes: small integer
    collectives."""
    e = experts.reshape(rows, experts.numel() // rows).long()  # (rows, R): a row's records in order
    n_rec = e.numel()
    # same-expert records before each one in its row: a stable sort by
    # (row, expert) and each record's place in its group
    key = (torch.arange(rows, device=e.device)[:, None] * n_experts + e).reshape(-1)
    order = torch.sort(key, stable=True).indices
    sorted_key = key[order]
    first = torch.searchsorted(sorted_key, torch.arange(rows * n_experts, device=e.device))
    in_row = torch.empty_like(key)
    in_row[order] = torch.arange(n_rec, device=e.device) - first[sorted_key]
    in_row = in_row.reshape(rows, -1)
    counts = torch.zeros(rows * n_experts, dtype=torch.int64, device=e.device).scatter_add_(
        0, key, torch.ones_like(key)).reshape(rows, n_experts)  # (rows, E)
    if rule.seq is not None:  # the row's earlier positions lie on the lower model ranks
        every = rule.seq.gather_rows(counts[None])  # (p, rows, E)
        earlier = every[: rule.seq.index].sum(0)
        row_tot = every.sum(0)
    else:
        earlier, row_tot = torch.zeros_like(counts), counts
    prev_rows = torch.cumsum(row_tot, 0) - row_tot
    blocks, index = row_tot.sum(0)[None], 0  # (1, E): this rank's rows' totals
    for g in reversed(rule.batch):  # the minor axis first: block index = major * size + minor
        blocks = g.gather_rows(blocks[None]).reshape(-1, n_experts)
    for g in rule.batch:
        index = index * g.p + g.index
    offset = blocks[:index].sum(0) + prev_rows + earlier  # (rows, E)
    rank = torch.gather(offset, 1, e) + in_row
    return (rank < rule.cap).reshape(-1)


def moe_ep(params: Dict, x: torch.Tensor, cfg: ArchConfig, mesh_info: MoEMeshInfo,
           capacity_factor=1.25, pair_cap_override: Optional[int] = None, aux_over: Optional[AuxOver] = None,
           rule: Optional[OneDeviceCap] = None):
    """Expert-parallel MoE over the model axis.

    ``x`` is this rank's (B_loc, S_loc, D) block (:func:`token_block`),
    ``params`` its :func:`expert_block`: the router and its e_loc = E / p
    experts. The per-(src, dst) row capacity is ⌈n·cf/p⌉ for n = this
    rank's records; ``pair_cap_override`` pins it
    (``moe_ep_safe(route="radix")`` passes the counted maximum there);
    ``capacity_factor=None`` sizes it to the largest count of records a
    rank sends a rank over the model axis (one host read; on ``meta``
    tensors, which hold no counts, an even routing's ⌈n/p⌉), so the
    exchange drops nothing and carries no row more than the fullest pair
    needs. ``aux_over`` makes the aux terms the whole batch's; ``rule``
    drops the records the one-device capacity rule drops
    (:func:`one_device_keep`) before the exchange, and raises the flag
    for them. The exchanges are
    differentiable: the backward sends the rows' gradients back along the
    reverse exchanges (:class:`_Dispatch`, ``sharding.exchange``).
    """
    procs = mesh_info.model_procs()
    p = procs.p
    E, k = cfg.moe_experts, cfg.moe_top_k
    if E % p:
        raise ValueError("the EP path needs the experts divisible by the model axis")
    e_loc = E // p
    bl, sl, D = x.shape
    dev = x.device
    x2d = x.reshape(-1, D)
    t_loc = x2d.shape[0]
    probs, experts, aux = _router(x2d, params["router"], k, aux_over)

    n = t_loc * k

    # paper step 9: stable integer sort of the records by expert id (a
    # record the capacity rule drops takes id E: after every shard's)
    flat_e = experts.reshape(-1)
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    if rule is not None:
        keep = one_device_keep(experts, bl, rule, E)
        flag = ~keep.all()
        flat_e = torch.where(keep, flat_e, torch.full((), E, dtype=flat_e.dtype, device=dev))
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    dest = sorted_e // e_loc  # destination shard, contiguous in sorted order
    bounds = torch.searchsorted(dest, torch.arange(p + 1, dtype=dest.dtype, device=dev), side="left").to(torch.int32)
    counts = torch.diff(bounds)
    if pair_cap_override is not None:
        pair_cap = min(int(pair_cap_override), n)
    elif capacity_factor is not None:
        pair_cap = int(-(-n * capacity_factor // p))
    elif x.is_meta:
        pair_cap = -(-n // p)
    else:
        pair_cap = max(1, int(procs.max(counts.max())))
    cap = p * pair_cap
    aux = _finish_aux(aux, mesh_info, flag | torch.any(counts > pair_cap), aux_over)
    _note_drops((flat_e == E).sum() + torch.clamp(counts - pair_cap, min=0).sum(), aux_over)

    # paper steps 10-11: segment rows + ONE all_to_all of the byte-packed
    # expert ids and token rows (the fused h-relation of core/routing)
    tix = torch.arange(pair_cap, device=dev)[None, :]
    # a padding row's index is a placeholder (its row is zeroed), spread so
    # that the gathers' backward finds no long run of one repeated index
    gidx = ((bounds[:-1, None] + tix) % max(n, 1)).long()
    valid = tix < counts[:, None]
    # record i <-> token order[i] // k, as a broadcast and a permutation
    sorted_tok = x2d[:, None, :].expand(t_loc, k, D).reshape(n, D)[order]
    if n == 0:  # no tokens here (a share of no positions): padding rows only, a zero row that keeps the
        # exchange in the tokens' graph (its backward is a collective every rank must join)
        sorted_e, sorted_tok = sorted_e.new_zeros(1), x2d.sum(0, keepdim=True)
    rows_e = torch.where(valid, sorted_e[gidx], torch.full((), -1, dtype=sorted_e.dtype, device=dev))
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    rows_x = torch.where(valid[..., None], sorted_tok[gidx], zero)
    recv_x, recv_e = _Dispatch.apply(rows_x, rows_e, procs)

    # the local experts, each on its own received rows
    me = 0 if mesh_info.mesh is None else procs.index
    out = _local_experts(recv_x.reshape(cap, D), recv_e.reshape(cap) - me * e_loc, params, e_loc)

    # the reverse all_to_all, back to the source's sorted order; a record's
    # output came back in row i at t, its sorted position bounds[i] + t
    back = shd.exchange(out.reshape(1, p, pair_cap, D), procs)[0]
    src_pos = torch.where(valid, bounds[:-1, None] + tix, n).reshape(-1).long()
    sorted_out = torch.zeros((n + 1, D), dtype=x.dtype, device=dev)
    sorted_out[src_pos] = back.reshape(-1, D)  # unsent records read row n
    rec_out = torch.empty((n, D), dtype=x.dtype, device=dev)
    rec_out[order] = sorted_out[:n]  # the stable unsort
    w = probs.reshape(-1)[:, None].to(x.dtype)
    y = (rec_out * w).reshape(t_loc, k, D).sum(1)
    return y.reshape(bl, sl, D), aux


def moe_ep_counts(params: Dict, x: torch.Tensor, cfg: ArchConfig, mesh_info: MoEMeshInfo) -> torch.Tensor:
    """The radix EP route's counting pass: only the router runs, and the
    records of every destination shard are counted. Returns a 0-d int32,
    the largest per-(src, dst) count over the mesh, the same on every rank.
    ``x`` and ``params`` as for :func:`moe_ep`."""
    p = mesh_info.model_size
    E, k = cfg.moe_experts, cfg.moe_top_k
    if E % p:
        raise ValueError("the EP path needs the experts divisible by the model axis")
    _, experts, _ = _router(x.reshape(-1, x.shape[-1]), params["router"], k)
    dest = experts.reshape(-1).long() // (E // p)
    counts = torch.zeros(p, dtype=torch.int32, device=x.device).scatter_add_(
        0, dest, torch.ones_like(dest, dtype=torch.int32))
    top = counts.max()
    for a in mesh_info.axis_procs():
        top = a.max(top)
    return top


def moe_capacity_ladder(capacity_factor: float, p: int) -> tuple:
    """EP dispatch capacity tiers, after ``SortConfig.tier_ladder``:
    ``whp`` the configured guess (pair_cap = ⌈n·cf/p⌉), ``whp2`` twice it,
    ``full`` pair_cap = n, which no routing can overflow."""
    tiers = [("whp", float(capacity_factor)), ("whp2", 2.0 * capacity_factor)]
    if 2.0 * capacity_factor < p:
        tiers.append(("full", float(p)))
    else:  # whp2 already at or above full capacity: one terminal rung
        tiers[-1] = ("full", float(p))
    return tuple(tiers)


def moe_ep_safe(params: Dict, x: torch.Tensor, cfg: ArchConfig, mesh_info: MoEMeshInfo,
                capacity_factor: float = 1.25, stats: Optional[TierStats] = None, planner=None,
                route: str = "sample", obs=None):
    """Overflow-safe EP dispatch: escalate the capacity on a dropped record.

    Runs :func:`moe_ep` at each rung of :func:`moe_capacity_ladder` until
    the replicated ``aux['overflow']`` flag is clean (every rank reads the
    same flag, so all climb together); the terminal ``full`` rung holds
    every record. ``route="radix"`` counts first (:func:`moe_ep_counts`,
    one host read) and dispatches once at the count rounded up on a
    1/16-octave grid: zero retries. ``planner`` starts the ladder at the
    rung learned for the bucket ``moe/{name}/ep{p}/t{B·S}/cf{cf}`` (B·S of
    this rank's block); ``obs`` (a tracer) records a ``count`` span and a
    ``dispatch`` span per attempt on a ``moe`` lane. Returns ``(y, aux,
    stats)``.
    """
    stats = stats if stats is not None else TierStats()
    tracer = obs_mod.resolve_tracer(obs)
    tid = tracer.next_tid("moe") if tracer is not None else None
    if route == "radix":
        t0 = tracer.now() if tracer is not None else 0.0
        pair_true = int(moe_ep_counts(params, x, cfg, mesh_info))
        if tracer is not None:
            tracer.add_span("count", t0, cat="moe", tid=tid, pair_true=pair_true)
            tracer.point("host_sync", cat="moe", tid=tid, what="moe_counts")
        step = max(8, 1 << max(0, pair_true.bit_length() - 4))
        qpair = -(-max(pair_true, 1) // step) * step
        t1 = tracer.now() if tracer is not None else 0.0
        y, aux = moe_ep(params, x, cfg, mesh_info, 1.0, pair_cap_override=qpair)
        overflow = bool(aux["overflow"])
        if tracer is not None:
            tracer.add_span("dispatch", t1, cat="moe", tid=tid, tier="radix", ok=not overflow, pair_cap=qpair)
        obs_mod.metrics().counter("moe.radix_dispatches").inc()
        if overflow:  # the capacity covers the counted maximum: unreachable
            raise RuntimeError("radix EP dispatch overflowed its counted capacity")
        stats.record("radix", True)
        return y, aux, stats
    ladder = moe_capacity_ladder(capacity_factor, mesh_info.model_size)
    n_rungs, bucket = len(ladder), None
    if planner is not None and n_rungs > 1:
        bucket = f"moe/{cfg.name}/ep{mesh_info.model_size}/t{x.shape[0] * x.shape[1]}/cf{capacity_factor}"
        ladder = ladder[planner.rung_for(bucket, n_rungs):]
    faulted = False
    for tier, cf in ladder:
        t0 = tracer.now() if tracer is not None else 0.0
        y, aux = moe_ep(params, x, cfg, mesh_info, cf)
        ok = not bool(aux["overflow"])
        if tracer is not None:
            tracer.add_span("dispatch", t0, cat="moe", tid=tid, tier=tier, ok=ok, capacity_factor=cf)
        stats.record(tier, ok)
        if ok:
            if bucket is not None:
                planner.observe(bucket, faulted, n_rungs)
            return y, aux, stats
        faulted = True
    raise RuntimeError("EP capacity escalation exhausted — unreachable: the full tier holds every record")


def moe_ep_decode(params: Dict, x: torch.Tensor, cfg: ArchConfig, mesh_info: MoEMeshInfo,
                  aux_over: Optional[AuxOver] = None):
    """EP MoE for few tokens (decode): every model shard evaluates its
    experts on every token of its data shard, combined by one
    ``all_reduce``: no all-to-all, no capacity. ``x`` is this rank's
    (B_loc, S, D) block (``token_block(..., seq_shard=False)``), ``params``
    its :func:`expert_block`."""
    p = mesh_info.model_size
    E, k = cfg.moe_experts, cfg.moe_top_k
    e_loc = E // p
    bl, sl, D = x.shape
    x2d = x.reshape(-1, D)
    probs, experts, aux = _router(x2d, params["router"], k, aux_over)
    me = 0 if mesh_info.mesh is None else mesh_info.index(mesh_info.model_axis)
    y = torch.zeros_like(x2d)
    for e in range(e_loc):
        w_tok = (probs * (experts == me * e_loc + e)).sum(-1).to(x.dtype)  # (T,)
        y = y + w_tok[:, None] * _expert_ffn(x2d, params["w_gate"][e], params["w_up"][e], params["w_down"][e])
    y = _psum_model(y, mesh_info)
    aux = _finish_aux(aux, mesh_info, None, aux_over)
    aux["overflow"] = torch.zeros((), dtype=torch.bool, device=x.device)
    return y.reshape(bl, sl, D), aux
