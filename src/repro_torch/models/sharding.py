"""Partition specs of parameters, batches and caches, and their placements
on a ``DeviceMesh``.

The port of the JAX package's ``repro.models.sharding``. A spec is a
:class:`Spec`: one entry per tensor dimension, each ``None`` (replicated),
a mesh axis name, or a tuple of names (one dimension split over several
mesh axes, the first one major), as JAX's ``PartitionSpec``. Specs become
``DTensor`` placements only at the boundary (:func:`to_placements`,
:func:`place`).

Policy ``2d``: FSDP over ``data`` × TP over ``model`` (weights 2-D
sharded, gathered layer by layer); ``1d``: TP only; ``dp``: every weight
replicated and every mesh axis a data axis (the optimizer state stays 2-D
sharded: ZeRO-1, see ``train.train_step``). The ``pod`` axis is pure data
parallelism: parameters are never sharded over it.

Rules go by leaf name. The reference's leaves carry their stacked
dimensions ((L, ...) for a transformer's layers, (blocks, slot, ...) for
jamba's groups) and the port's do not: a port name carries one integer
segment per stacked dimension (``layers.3.w_gate``, ``blocks.0.mamba.1.in_proj``,
``blocks.0.attn_norm.1``), so the reference's rank is the port's plus the
count of those segments, and the stacked dimensions' ``None`` entries are
dropped from the port's spec.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch

__all__ = ["Spec", "all_gather", "axes_of", "axis_names", "axis_procs", "axis_size", "batch_specs", "cache_specs",
           "chunk", "dp_axes", "exchange", "full", "gather", "local_block", "local_of", "param_spec", "param_specs",
           "place", "psum", "reduce_scatter", "regroup", "sanitize_specs", "scale_grad", "scatter_sum", "spec_of",
           "split", "sum_grad", "to_placements", "tree_map"]


class Spec(tuple):
    """A partition spec: one entry per tensor dimension (``None``, an axis
    name or a tuple of axis names). A tuple subclass, so a spec tree's
    leaves are told apart from the tuples of a cache's structure."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


# trailing-dims spec by leaf name: (in-dim axis, out-dim axis) semantics.
_MATMUL_RULES = {
    "wq": ("data", "model"), "wk": ("data", "model"), "wv": ("data", "model"), "wo": ("model", "data"),
    "xwq": ("data", "model"), "xwk": ("data", "model"), "xwv": ("data", "model"), "xwo": ("model", "data"),
    "w_gate": ("data", "model"), "w_up": ("data", "model"), "w_down": ("model", "data"),
    "in_proj": ("data", "model"), "out_proj": ("model", "data"), "up": ("data", "model"),
    "down": ("model", "data"), "w_zifo": ("data", "model"), "w_xdbc": ("model", None), "w_dt": (None, "model"),
}
_VECTOR_RULES = {"conv_b": ("model",), "b_dt": ("model",), "D": ("model",)}  # 1 trailing dim
_MATRIX_RULES = {"conv_w": (None, "model"), "A_log": ("model", None)}  # non-matmul 2-D leaves


# ------------------------------------------------------------------ meshes
def axis_names(mesh) -> tuple:
    """The mesh's axis names (a ``DeviceMesh``, or anything with its
    ``mesh_dim_names`` and ``shape``)."""
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, entry) -> int:
    """The number of shards of a spec entry: 1 for ``None``, the product of
    the named axes' sizes otherwise."""
    if entry is None:
        return 1
    names = axis_names(mesh)
    return math.prod(mesh.shape[names.index(a)] for a in axes_of(entry))


def axes_of(entry) -> tuple:
    return () if entry is None else tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


# ------------------------------------------------------------------- specs
def _leaf_path(name: str):
    """(the reference's path names, the count of stacked dimensions) of a
    port state-dict name."""
    segs = name.split(".")
    return [s for s in segs if not s.isdigit()], sum(s.isdigit() for s in segs)


def param_spec(cfg, name: str, shape, model_axis_size: int = 16) -> Spec:
    """The spec of one parameter by its port name and shape."""
    if cfg.param_sharding == "dp":
        return Spec(*([None] * len(shape)))
    fsdp = "data" if cfg.param_sharding == "2d" else None
    names, depth = _leaf_path(name)
    leaf = names[-1]
    ndim = len(shape) + depth  # the reference's rank

    def fix(ax):
        return fsdp if ax == "data" else ax

    def port(*entries):
        return Spec(*entries[depth:])

    if leaf == "embed":
        return port("model", fsdp)
    if leaf == "lm_head":
        return port(fsdp, "model")
    if leaf == "router":
        return port(*([None] * ndim))
    is_moe_leaf = (leaf in ("w_gate", "w_up", "w_down") and cfg.moe_experts
                   and "dense" not in names  # hybrid's dense-MLP stacks are not MoE
                   and ("moe" in names or ndim >= 4))
    if is_moe_leaf:  # (..., E, D, F) / (..., E, F, D)
        lead = [None] * (ndim - 3)
        if cfg.moe_experts >= model_axis_size:  # EP: experts over model
            return port(*lead, "model", None, fsdp) if leaf == "w_down" else port(*lead, "model", fsdp, None)
        # TP: experts replicated, F sharded
        return port(*lead, None, "model", fsdp) if leaf == "w_down" else port(*lead, None, fsdp, "model")
    for rules, width in ((_MATMUL_RULES, 2), (_MATRIX_RULES, 2), (_VECTOR_RULES, 1)):
        if leaf in rules and ndim >= width:
            return port(*([None] * (ndim - width)), *(fix(a) for a in rules[leaf]))
    return port(*([None] * ndim))  # norms, biases, gates


def param_specs(cfg, shapes: Dict[str, torch.Tensor], model_axis_size: int = 16) -> Dict[str, Spec]:
    """The spec of every parameter of ``shapes`` (a state dict, tensors on
    any device or ``meta``)."""
    return {k: param_spec(cfg, k, tuple(t.shape), model_axis_size) for k, t in shapes.items()}


def dp_axes(mesh, cfg=None) -> tuple:
    """The data axes: ``("pod", "data")`` on a multi-pod mesh, and the model
    axis after them under the ``dp`` policy."""
    if mesh is None:
        return ("data",)
    axes = ("pod", "data") if "pod" in axis_names(mesh) else ("data",)
    if cfg is not None and cfg.param_sharding == "dp":
        axes = axes + ("model",)  # the model axis becomes extra DP
    return axes


def batch_specs(cfg, mesh, kind: str) -> Dict[str, Spec]:
    dp = dp_axes(mesh, cfg)
    if kind == "decode":
        return {"token": Spec(dp)}
    specs = {"tokens": Spec(dp, None), "labels": Spec(dp, None)}
    if cfg.family == "vlm":
        specs["patch_embeds"] = Spec(dp, None, None)
    if cfg.family == "audio":
        specs["frames"] = Spec(dp, None, None)
    return specs


def cache_specs(cfg, mesh, cache_tree: Any) -> Any:
    """KV caches: batch over the data axes, the sequence over the model axis
    (the flash-decode layout, ``models.attention``); recurrent states:
    batch over the data axes, the channel dimension over the model axis."""
    del cfg
    dp = dp_axes(mesh)

    def spec_for(path, leaf) -> Spec:
        name = path[0] if path else None
        ndim = leaf.dim()
        if name in ("k", "v", "xk", "xv"):  # (L, B, S, KV, hd)
            return Spec(None, dp, "model", None, None)
        if name == "mamba":  # (blocks, slots, B, di, N) / (blocks, slots, B, dk-1, di)
            if ndim == 5:
                if path[-1] == 0:
                    return Spec(None, None, dp, "model", None)
                return Spec(None, None, dp, None, "model")
            return Spec(*([None] * ndim))
        if name in ("mlstm", "slstm"):
            return Spec(None, dp, *([None] * (ndim - 2)))
        if name == "pos":
            return Spec()
        return Spec(*([None] * ndim))

    return _map_path(spec_for, cache_tree)


def sanitize_specs(mesh, spec_tree: Any, shape_tree: Any) -> Any:
    """Drop the spec entries whose shard count does not divide their
    dimension (uneven vocabularies 49155 and 51865, batch-1 decode cells,
    KV heads fewer than the model axis): the largest prefix of a
    multi-axis entry that divides stays, else the dimension is
    replicated."""
    if mesh is None:
        return spec_tree

    def fit(dim, entry):
        if entry is None or dim % axis_size(mesh, entry) == 0:
            return entry
        if isinstance(entry, (tuple, list)):
            for cut in range(len(entry) - 1, 0, -1):
                sub = tuple(entry[:cut])
                if dim % axis_size(mesh, sub) == 0:
                    return sub if len(sub) > 1 else sub[0]
        return None

    def fix(spec, leaf):
        dims = tuple(leaf.shape)
        entries = list(spec) + [None] * (len(dims) - len(spec))
        return Spec(*(fit(d, e) for d, e in zip(dims, entries)))

    return tree_map(fix, spec_tree, shape_tree)


# --------------------------------------------------------------- the trees
def _map_path(fn: Callable, tree: Any, path=()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return type(tree)(_map_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def tree_map(fn: Callable, spec_tree: Any, *trees: Any) -> Any:
    """``fn(spec, *leaves)`` over a spec tree and trees of its structure."""
    if isinstance(spec_tree, Spec):
        return fn(spec_tree, *trees)
    if isinstance(spec_tree, dict):
        return {k: tree_map(fn, v, *(t[k] for t in trees)) for k, v in spec_tree.items()}
    return type(spec_tree)(tree_map(fn, v, *(t[i] for t in trees)) for i, v in enumerate(spec_tree))


# -------------------------------------------------------------- placements
def to_placements(mesh, spec: Spec) -> list:
    """The ``DTensor`` placements of ``spec``: one per mesh axis, ``Shard(d)``
    where tensor dimension d names the axis, ``Replicate()`` elsewhere. An
    entry that names several axes must name them in the mesh's order (the
    first one major, as ``DTensor`` shards)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = axes_of(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec entry {entry} must name its axes in the mesh's order {names}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return out


def spec_of(mesh, placements, ndim: int) -> Spec:
    """The spec of ``DTensor`` placements (the inverse of :func:`to_placements`)."""
    from torch.distributed.tensor import Shard

    entries = [[] for _ in range(ndim)]
    for a, p in zip(axis_names(mesh), placements):
        if isinstance(p, Shard):
            entries[p.dim].append(a)
        elif not p.is_replicate():
            raise ValueError(f"a partial placement has no spec: {placements}")
    return Spec(*(None if not e else e[0] if len(e) == 1 else tuple(e) for e in entries))


def local_block(mesh, spec: Spec, shape) -> tuple:
    """This rank's slices of a tensor of ``shape`` placed by ``spec``."""
    names, coord = axis_names(mesh), mesh.get_coordinate()
    out = []
    for d, dim in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        n, i = 1, 0
        for a in axes_of(entry):
            k = names.index(a)
            n, i = n * mesh.shape[k], i * mesh.shape[k] + coord[k]
        if dim % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not split {n} ways; sanitize the spec")
        out.append(slice(i * (dim // n), (i + 1) * (dim // n)))
    return tuple(out)


def place(t: torch.Tensor, mesh, spec: Spec):
    """``t``, the same full tensor on every rank, as a ``DTensor`` placed by
    ``spec``: each rank keeps its block, nothing is sent. A block smaller
    than ``t`` is copied out: a view (a block of leading rows is one)
    would keep the whole of ``t`` alive."""
    from torch.distributed.tensor import DTensor

    local = t[local_block(mesh, spec, t.shape)]
    local = local.clone(memory_format=torch.contiguous_format) if local.numel() < t.numel() else local.contiguous()
    return DTensor.from_local(local, mesh, to_placements(mesh, spec), run_check=False,
                              shape=t.shape, stride=t.contiguous().stride())


# ---------------------------------------------------- the explicit collectives
# ``DTensor``'s Shard -> Replicate redistribute is the functional
# collectives' ``all_gather_into_tensor``, which gloo's process group runs
# through ``allgather_into_tensor_coalesced``: on CUDA tensors that crashes
# the process (SIGSEGV, torch 2.11 with gloo on an H100; its reduce-scatter
# and all-reduce run). Gathers go through ``torch.distributed``'s own
# ``all_gather_into_tensor`` here instead, each with its transpose. Every
# differentiable collective of the mesh paths (the layers', the MoE's, the
# train step's) is here, each backward the forward's transpose.
def axis_procs(mesh, axis: str):
    from ..core.primitives import GroupProcs

    return GroupProcs.from_mesh(mesh, axis)


def all_gather(t: torch.Tensor, procs, dim: int) -> torch.Tensor:
    """Every processor's ``t`` of a group, concatenated along ``dim`` in the
    processors' order (no autograd)."""
    import torch.distributed as dist

    x = t.movedim(dim, 0).contiguous()
    out = torch.empty((procs.p,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out.view((procs.p * x.shape[0],) + tuple(x.shape[1:])), x, group=procs.group)
    out = procs._by_proc(out).reshape((procs.p * x.shape[0],) + tuple(x.shape[1:]))
    return out.movedim(0, dim).contiguous()


def reduce_scatter(t: torch.Tensor, procs, dim: int) -> torch.Tensor:
    """The sum over a group of ``t``, this processor's chunk of ``dim``
    (chunks in the processors' order; no autograd)."""
    import torch.distributed as dist

    x = t.movedim(dim, 0)
    n = x.shape[0] // procs.p
    x = procs._by_group(x.reshape((procs.p, n) + tuple(x.shape[1:]))).contiguous()
    out = torch.empty((n,) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, x.view((procs.p * n,) + tuple(x.shape[2:])), group=procs.group)
    return out.movedim(0, dim).contiguous()


def chunk(t: torch.Tensor, procs, dim: int) -> torch.Tensor:
    n = t.shape[dim] // procs.p
    return t.narrow(dim, procs.index * n, n)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``. Backward: the gradient's sum over the
    group, this rank's chunk (``summed``: each rank's use of the whole
    tensor adds to it), or this rank's chunk of a gradient every rank
    holds alike."""

    @staticmethod
    def forward(ctx, t, procs, dim, summed):
        ctx.procs, ctx.dim, ctx.summed = procs, dim, summed
        return all_gather(t, procs, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return reduce_scatter(g, ctx.procs, ctx.dim), None, None, None
        return chunk(g, ctx.procs, ctx.dim).contiguous(), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """Partial sums -> this rank's chunk of their sum; backward all-gathers."""

    @staticmethod
    def forward(ctx, t, procs, dim):
        ctx.procs, ctx.dim = procs, dim
        return reduce_scatter(t, procs, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.procs, ctx.dim), None, None


class _Split(torch.autograd.Function):
    """A tensor every rank holds alike -> this rank's chunk; backward
    all-gathers the chunks' gradients."""

    @staticmethod
    def forward(ctx, t, procs, dim):
        ctx.procs, ctx.dim = procs, dim
        return chunk(t, procs, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.procs, ctx.dim), None, None


class _PSum(torch.autograd.Function):
    """``psum`` over a processor group whose backward is the identity on
    each rank: the sum's inputs are partial contributions of one value that
    every rank then holds, and each rank's gradient of its own
    contribution is the gradient of that value. (An all-reduce in the
    backward, as ``torch.distributed.nn.functional.all_reduce`` does, would
    count each gradient once per rank.)"""

    @staticmethod
    def forward(ctx, x, procs):
        return procs.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScaleGrad(torch.autograd.Function):
    """Identity; backward the gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _Exchange(torch.autograd.Function):
    """The all-to-all of (1, p, ...) chunks (chunk j to processor j), whose
    transpose is the same exchange: the backward sends each chunk's
    gradient back to the processor it came from."""

    @staticmethod
    def forward(ctx, x, procs):
        ctx.procs = procs
        return procs.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.procs.all_to_all(g.contiguous()), None


class _SumGrad(torch.autograd.Function):
    """Identity; backward the gradient's sum over the group (the input of
    products whose gradients are partial over it)."""

    @staticmethod
    def forward(ctx, t, procs):
        ctx.procs = procs
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.procs.all_reduce(g), None


def gather(t: torch.Tensor, procs, dim: int, summed: bool = True) -> torch.Tensor:
    return _Gather.apply(t, procs, dim, summed)


def scatter_sum(t: torch.Tensor, procs, dim: int) -> torch.Tensor:
    return _ReduceScatter.apply(t, procs, dim)


def split(t: torch.Tensor, procs, dim: int) -> torch.Tensor:
    return _Split.apply(t, procs, dim)


def sum_grad(t: torch.Tensor, procs) -> torch.Tensor:
    return _SumGrad.apply(t, procs)


def psum(t: torch.Tensor, procs) -> torch.Tensor:
    """The sum over a group, its backward the identity (:class:`_PSum`)."""
    return _PSum.apply(t, procs)


def scale_grad(t: torch.Tensor, scale: float) -> torch.Tensor:
    """``t``, its gradient multiplied by ``scale`` on the way back."""
    return _ScaleGrad.apply(t, scale)


def exchange(t: torch.Tensor, procs) -> torch.Tensor:
    """The all-to-all of ``t``'s (1, p, ...) chunks, its backward the same
    exchange (:class:`_Exchange`)."""
    return _Exchange.apply(t, procs)


def _regroup(t: torch.Tensor, procs, gates: int, dim: int, inverse: bool) -> torch.Tensor:
    """The exchange of :func:`regroup` (``inverse``: its transpose).

    Unit ``g·p + j`` is gate g's channel block j, ``u`` = width / p wide:
    processor r stores units [r·gates, (r+1)·gates) (its contiguous block
    of the concatenated columns) and needs units ``g·p + r``, one of each
    gate. Each unit goes to one processor, so one ``all_to_all_single``
    with uneven splits moves every unit once; a unit that stays is copied."""
    import torch.distributed as dist

    from ..core.primitives import _from_wire, _to_wire

    m, r = procs.p, procs.index
    x = t.movedim(dim, 0)
    if x.shape[0] % gates:
        raise ValueError(f"{x.shape[0]} columns do not hold {gates} equal gate blocks")
    x = x.reshape((gates, x.shape[0] // gates) + tuple(x.shape[1:]))

    def stored(k):  # (processor, slot) of unit k in the stored layout
        return divmod(k, gates)

    def wanted(k):  # (processor, slot) of unit k in the channel layout
        return k % m, k // m

    src, dst = (wanted, stored) if inverse else (stored, wanted)
    order = procs._order  # the group rank of each processor: the wire's order
    units = range(gates * m)
    send = sorted((k for k in units if src(k)[0] == r), key=lambda k: (order[dst(k)[0]], k))
    recv = sorted((k for k in units if dst(k)[0] == r), key=lambda k: (order[src(k)[0]], k))
    out_splits = [sum(order[src(k)[0]] == g for k in recv) for g in range(m)]
    in_splits = [sum(order[dst(k)[0]] == g for k in send) for g in range(m)]
    wire = _to_wire(torch.cat([x[src(k)[1]: src(k)[1] + 1] for k in send]))
    got = torch.empty_like(wire)
    dist.all_to_all_single(got, wire, out_splits, in_splits, group=procs.group)
    got = _from_wire(got, x.dtype, x.shape)
    slot = {dst(k)[1]: i for i, k in enumerate(recv)}
    out = torch.cat([got[slot[g]: slot[g] + 1] for g in range(gates)])
    return out.reshape((-1,) + tuple(x.shape[2:])).movedim(0, dim)


class _Regroup(torch.autograd.Function):
    """:func:`regroup`; backward the inverse exchange."""

    @staticmethod
    def forward(ctx, t, procs, gates, dim):
        ctx.procs, ctx.gates, ctx.dim = procs, gates, dim
        return _regroup(t, procs, gates, dim, inverse=False)

    @staticmethod
    def backward(ctx, g):
        return _regroup(g.contiguous(), ctx.procs, ctx.gates, ctx.dim, inverse=True), None, None, None


def regroup(t: torch.Tensor, procs, gates: int, dim: int = -1) -> torch.Tensor:
    """A product of concatenated column blocks (``x @ in_proj``'s ``x1 | z``,
    ``x @ w_zifo``'s ``z | i | f | o``), its weight stored ``Shard`` over
    ``procs`` as one contiguous block a processor, moved to the channel
    layout: this processor's channel block of every gate, gate after gate
    (at p = 2 processor 0 stores all of ``x1`` and processor 1 all of
    ``z``; processor r needs channels [r·di/p, (r+1)·di/p) of both). It
    moves the product's columns, not the weight's blocks: at a decode step
    or a prefill of fewer tokens than the model's width the product is the
    smaller of the two, and the stored weights (and checkpoints) keep the
    one-process layout. One uneven all-to-all; its backward the inverse."""
    if procs.p == 1:
        return t
    return _Regroup.apply(t, procs, gates, dim % t.dim())


def local_of(w, gather_axes: dict, grad_placements: list) -> torch.Tensor:
    """A ``DTensor`` parameter's local block with the dimensions of
    ``gather_axes`` ({axis: (procs, summed)}) gathered whole (the minor
    mesh axis first), its gradient in ``grad_placements``."""
    local = w.to_local(grad_placements=grad_placements)
    names = axis_names(w.device_mesh)
    for a in sorted(gather_axes, key=names.index, reverse=True):
        procs, summed = gather_axes[a]
        local = gather(local, procs, w.placements[names.index(a)].dim, summed)
    return local


def full(t) -> torch.Tensor:
    """A ``DTensor``'s full tensor on every rank of its mesh (a collective;
    no autograd); any other tensor as it is."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(t, DTensor):
        return t
    local = t.to_local().detach()
    names = axis_names(t.device_mesh)
    for i in reversed(range(len(names))):
        p = t.placements[i]
        if isinstance(p, Shard):
            local = all_gather(local, axis_procs(t.device_mesh, names[i]), p.dim)
        elif not p.is_replicate():
            raise ValueError(f"a partial DTensor has no full tensor: {t.placements}")
    return local
