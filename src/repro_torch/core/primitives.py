"""BSP primitives (paper §4): the processors and their collectives.

The JAX package runs one per-processor body under a named axis and
expresses Ph3–Ph5's supersteps as collectives over it. Here a *processor
group* stands where that axis name stands, and every stage function takes
one (``procs=``; ``None`` is :class:`LocalProcs` over ``cfg.p``):

* :class:`LocalProcs` — p simulated processors in one process. Every
  tensor carries the processor as dimension 0 and each collective is a
  tensor operation: ``all_to_all`` a transpose, ``all_gather`` a
  broadcast, ``any``/``max``/``min`` reductions over dimension 0,
  ``exchange_with`` a row permutation, ``ppermute_shift`` a roll.
* :class:`GroupProcs` — one processor per rank of a ``torch.distributed``
  process group (a mesh axis): every tensor holds the rank's own row
  (dimension 0 of size 1) and each collective is one ``torch.distributed``
  call on the group. The permutations are one ``all_to_all_single`` with
  one non-zero split each way (gloo's ``send``/``recv`` take host tensors
  only; ``all_to_all_single`` takes the card's tensors on gloo and NCCL).
  The data collectives move int32, int64 and uint8 tensors only: other
  dtypes travel as their bytes, since the backends do not all move bool,
  uint32 and bfloat16 alike. The reductions reduce flags and extremes as
  int32 or int64, and :meth:`GroupProcs.all_reduce` sums in float32 or
  int64.

``rows`` is the number of processors a tensor holds (p, or 1), ``p`` the
number of processors in all; a stage function shapes its tensors by the
first and its bucket count by the second.

The JAX package orders float keys with XLA's sort comparator: ``-0.0``
equals ``+0.0`` and every NaN is equal and above ``+inf``. :func:`sort_key`
gives that order as integers; :func:`stable_sort` sorts by it (on the card
``torch.sort`` of floats orders NaNs otherwise than on the CPU) and
:func:`searchsorted` reproduces ``jnp.searchsorted`` on it.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


class LocalProcs:
    """p simulated processors, dimension 0 of every tensor (one process)."""

    local = True

    def __init__(self, p: int) -> None:
        self.p = self.rows = p

    @property
    def nprocs(self) -> int:
        return self.p

    def proc_id(self, device) -> torch.Tensor:
        """(rows,) int32 processor index of every row."""
        return torch.arange(self.p, dtype=torch.int32, device=device)

    def own_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The rows of a (p, ...) table that this group holds."""
        return t

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Deliver row ``[src, dst]`` to processor ``dst``: ``(p_dst, p_src, ...)``."""
        return x.transpose(0, 1).contiguous()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every processor receives every row: ``(rows, ...) -> (rows, p, ...)``."""
        return x.unsqueeze(0).expand(x.shape[0], *x.shape)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every processor's row, ``(p, ...)``, as one replicated tensor."""
        return x

    def any(self, flags: torch.Tensor) -> torch.Tensor:
        """0-d bool: any flag of any processor (the ``pmax`` of a flag)."""
        return flags.any()

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """0-d: the largest element over every processor (``pmax``)."""
        return x.max()

    def min(self, x: torch.Tensor) -> torch.Tensor:
        """0-d: the smallest element over every processor (``pmin``)."""
        return x.min()

    def broadcast_from(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Lemma 4.1's one-superstep broadcast: every row takes row ``src``."""
        return x[src : src + 1].expand_as(x)

    def prefix_counts(self, counts: torch.Tensor) -> torch.Tensor:
        """Lemma 4.2's parallel prefixes: (rows, m) counts -> the sums of the
        counts of the lower-ranked processors, one superstep."""
        return torch.cumsum(counts, dim=0, dtype=counts.dtype) - counts

    def exchange_with(self, x, partner_xor: int):
        """Row ``k`` receives row ``k ^ partner_xor`` (a tuple maps elementwise)."""
        if isinstance(x, (tuple, list)):
            return type(x)(self.exchange_with(v, partner_xor) for v in x)
        perm = torch.arange(x.shape[0], device=x.device) ^ partner_xor
        return x[perm]

    def ppermute_shift(self, x, shift: int = 1):
        """Row ``k`` receives row ``k - shift`` (mod p): processor i sends to
        i + shift around the ring. A tuple or list maps elementwise."""
        if isinstance(x, (tuple, list)):
            return type(x)(self.ppermute_shift(v, shift) for v in x)
        return torch.roll(x, shifts=shift, dims=0)


def procs_or_local(procs, p: int):
    """``procs``, or p simulated processors when it is None."""
    return LocalProcs(p) if procs is None else procs


#: dtypes that go on the wire as they are; every other dtype goes as bytes
_WIRE = (torch.int32, torch.int64, torch.uint8)


def _to_wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` (leading dimension kept) in a wire dtype: its bytes otherwise."""
    t = t.contiguous()
    if t.dtype in _WIRE:
        return t
    flat = t.reshape(t.shape[0], -1)
    if flat.stride(-1) != 1:  # a size-1 dimension may keep any stride
        flat = torch.empty(flat.shape, dtype=flat.dtype, device=flat.device).copy_(flat)
    return flat.view(torch.uint8)


def _from_wire(w: torch.Tensor, dtype: torch.dtype, shape) -> torch.Tensor:
    return (w if dtype in _WIRE else w.view(dtype)).reshape(shape)


class GroupProcs:
    """One processor per rank of a ``torch.distributed`` group.

    ``ranks[k]`` is the global rank that holds processor k (the mesh's
    order along its axis) and ``index`` this rank's processor. A group's
    own ranks are numbered in sorted order, which need not be the mesh's,
    so every collective lays its chunks out in group order on the way in
    and back in processor order on the way out. Tensors stay on the
    device they are on: on the card, gloo stages them through the host
    itself and NCCL moves them between cards.
    """

    local = False
    rows = 1

    def __init__(self, group, ranks: Sequence[int], index: int) -> None:
        self.group = group
        self.ranks = tuple(int(r) for r in ranks)
        self.p = len(self.ranks)
        self.index = int(index)
        #: group rank of processor k
        self._order = [dist.get_group_rank(group, r) for r in self.ranks]
        self._inverse: Optional[List[int]] = None
        if self._order != list(range(self.p)):
            self._inverse = [0] * self.p
            for k, g in enumerate(self._order):
                self._inverse[g] = k

    @classmethod
    def from_mesh(cls, mesh, axis: str) -> "GroupProcs":
        """The processors along ``axis`` of a ``DeviceMesh`` through this rank."""
        dim = mesh.mesh_dim_names.index(axis)
        coord = mesh.get_coordinate()
        line = tuple(slice(None) if d == dim else c for d, c in enumerate(coord))
        return cls(mesh.get_group(axis), mesh.mesh[line].tolist(), coord[dim])

    @property
    def nprocs(self) -> int:
        return self.p

    def proc_id(self, device) -> torch.Tensor:
        return torch.full((1,), self.index, dtype=torch.int32, device=device)

    def own_rows(self, t: torch.Tensor) -> torch.Tensor:
        return t[self.index : self.index + 1]

    # chunks by processor <-> chunks by group rank (identity on most meshes)
    def _by_group(self, t: torch.Tensor) -> torch.Tensor:
        if self._inverse is None:
            return t
        return t[torch.tensor(self._inverse, device=t.device)]

    def _by_proc(self, t: torch.Tensor) -> torch.Tensor:
        if self._inverse is None:
            return t
        return t[torch.tensor(self._order, device=t.device)]

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(1, p, ...): chunk j goes to processor j; chunk j of the result
        came from processor j."""
        send = self._by_group(_to_wire(x[0]))
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        return _from_wire(self._by_proc(recv), x.dtype, x.shape)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(1, ...) -> (p, ...): every processor's row, on every rank."""
        w = _to_wire(x)
        parts = [torch.empty_like(w) for _ in range(self.p)]
        dist.all_gather(parts, w, group=self.group)
        return _from_wire(self._by_proc(torch.cat(parts)), x.dtype, (self.p,) + tuple(x.shape[1:]))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return self.gather_rows(x).unsqueeze(0)

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        t = t.reshape(1).clone()
        dist.all_reduce(t, op=op, group=self.group)
        return t[0]

    def any(self, flags: torch.Tensor) -> torch.Tensor:
        return self._reduce(flags.any().to(torch.int32), dist.ReduceOp.MAX) > 0

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(_integer(x.max()), dist.ReduceOp.MAX)

    def min(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(_integer(x.min()), dist.ReduceOp.MIN)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """``psum`` of a tensor over the group. Floats sum in float32
        (bfloat16 rounds once, after the sum), integers as int64."""
        wire = torch.float32 if x.is_floating_point() else torch.int64
        t = x.to(wire).contiguous().clone()
        dist.all_reduce(t, group=self.group)
        return t.to(x.dtype)

    def broadcast_from(self, x: torch.Tensor, src: int) -> torch.Tensor:
        w = _to_wire(x).clone()
        dist.broadcast(w, src=self.ranks[src], group=self.group)
        return _from_wire(w, x.dtype, x.shape)

    def prefix_counts(self, counts: torch.Tensor) -> torch.Tensor:
        every = self.gather_rows(counts)
        return every[: self.index].sum(dim=0, keepdim=True, dtype=counts.dtype)

    def _permute(self, x: torch.Tensor, dst: int, src: int) -> torch.Tensor:
        """Send this rank's tensor to processor ``dst``, receive ``src``'s:
        one ``all_to_all_single`` with one non-zero split each way."""
        w = _to_wire(x).reshape(-1)
        send = [0] * self.p
        recv = [0] * self.p
        send[self._order[dst]] = recv[self._order[src]] = w.numel()
        out = torch.empty_like(w)
        dist.all_to_all_single(out, w, recv, send, group=self.group)
        return _from_wire(out, x.dtype, x.shape)

    def exchange_with(self, x, partner_xor: int):
        if isinstance(x, (tuple, list)):
            return type(x)(self.exchange_with(v, partner_xor) for v in x)
        partner = self.index ^ partner_xor
        return self._permute(x, partner, partner)

    def ppermute_shift(self, x, shift: int = 1):
        if isinstance(x, (tuple, list)):
            return type(x)(self.ppermute_shift(v, shift) for v in x)
        return self._permute(x, (self.index + shift) % self.p, (self.index - shift) % self.p)


def _integer(t: torch.Tensor) -> torch.Tensor:
    """A scalar in a dtype every backend reduces alike (bool -> int32)."""
    if t.dtype in (torch.int32, torch.int64):
        return t
    if t.dtype == torch.bool:
        return t.to(torch.int32)
    raise TypeError(f"processor reductions take integer tensors, not {t.dtype}")


def exclusive_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.cumsum(x, dim=dim, dtype=x.dtype) - x


#: signed integer dtype of each element size, for bit views of float keys
_BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def gather(x: torch.Tensor, dim: int, index: torch.Tensor) -> torch.Tensor:
    """``x.gather(dim, index)``, bit-exact for every dtype: float keys move
    as integers of their width (the CPU gather rewrites bfloat16 NaNs)."""
    if not x.is_floating_point():
        return x.gather(dim, index)
    return x.view(_BITS[x.element_size()]).gather(dim, index).view(x.dtype)


def scatter_(buf: torch.Tensor, dim: int, index: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``buf.scatter_(dim, index, src)``, bit-exact as :func:`gather`."""
    if not buf.is_floating_point():
        return buf.scatter_(dim, index, src)
    bits = _BITS[buf.element_size()]
    buf.view(bits).scatter_(dim, index, src.view(bits))
    return buf


def lex_sort(operands: Sequence[torch.Tensor], num_keys: int) -> tuple:
    """Stable lexicographic sort along the last dimension (§5.1.1 tagged
    compare): stable argsorts of the keys, least significant key first."""
    order = None
    for key in reversed(operands[:num_keys]):
        k = key if order is None else gather(key, -1, order)
        step = stable_sort(k)[1]
        order = step if order is None else order.gather(-1, step)
    return tuple(gather(op, -1, order) for op in operands)


def lex_less(ka, pa, ia, kb, pb, ib):
    """(key, proc, idx) lexicographic strict less-than — §5.1.1's comparator."""
    return (ka < kb) | ((ka == kb) & ((pa < pb) | ((pa == pb) & (ia < ib))))


def take_rows(v: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``out[r, j, ...] = v[r, index[r, j], ...]`` for any trailing dims."""
    rows = torch.arange(v.shape[0], device=v.device).unsqueeze(1)
    return v[rows, index.long()]


# ------------------------------------------------- the JAX package's order
_INT_MIN = -(2**31)


def bias_unsigned(x: torch.Tensor) -> torch.Tensor:
    """uint32 -> int32 with the same order (``x ^ 0x80000000``, viewed)."""
    return x.view(torch.int32) ^ _INT_MIN


def unbias_unsigned(x: torch.Tensor) -> torch.Tensor:
    """Invert :func:`bias_unsigned`."""
    return (x ^ _INT_MIN).view(torch.uint32)


def sort_key(x: torch.Tensor) -> torch.Tensor:
    """Integers ordered as the JAX package's sort comparator orders ``x``.

    Floats are canonicalised first (``-0.0`` -> ``+0.0``, every NaN -> one
    positive NaN), then their bits are mapped to a signed integer of the
    same order. Integer tensors are returned as they are.
    """
    if not x.is_floating_point():
        return x
    if x.dtype == torch.float64:
        f, ity, width = x, torch.int64, 64
    else:
        f, ity, width = x.float(), torch.int32, 32
    f = torch.where(f == 0, torch.zeros((), dtype=f.dtype, device=f.device), f)
    f = torch.where(torch.isnan(f), torch.full((), float("nan"), dtype=f.dtype, device=f.device), f)
    b = f.view(ity)
    return b ^ ((b >> (width - 1)) & (2 ** (width - 1) - 1))


def canonical_nans(x: torch.Tensor) -> torch.Tensor:
    """bfloat16 NaNs rewritten to the quiet NaN of their sign (``0x7fc0`` /
    ``0xffc0``); any other tensor unchanged.

    The JAX package's ops that compute on bfloat16 (``lax.sort``,
    ``jnp.where``, ``jnp.concatenate``) do this on XLA:CPU, since they run
    in float32 and round back; its gathers keep the bits. The port applies
    it where those ops stand (:func:`stable_sort`, the routing's row
    formation), on every device, with integer operations on the bits.
    """
    if x.dtype != torch.bfloat16:
        return x
    b = x.view(torch.int16)
    quiet = torch.where(b < 0, torch.full((), -64, dtype=torch.int16, device=x.device),  # 0xffc0
                        torch.full((), 0x7FC0, dtype=torch.int16, device=x.device))
    return torch.where((b & 0x7FFF) > 0x7F80, quiet, b).view(torch.bfloat16)


def stable_sort(x: torch.Tensor, dim: int = -1):
    """``(values, indices)`` of a stable ascending sort in the JAX package's
    order, the same on every device (float keys sort by :func:`sort_key`;
    bfloat16 NaNs come out canonical, as from ``lax.sort``)."""
    if not x.is_floating_point():
        return tuple(torch.sort(x, dim=dim, stable=True))
    order = torch.sort(sort_key(x), dim=dim, stable=True).indices
    return canonical_nans(gather(x, dim, order)), order


def searchsorted(
    arr: torch.Tensor, query: torch.Tensor, side: str = "left", exact_probes: bool = False
) -> torch.Tensor:
    """``jnp.searchsorted`` of (R, S) queries in (R, n) runs, int32.

    On a sorted run every binary search gives the same answer, and
    ``torch.searchsorted`` is taken. ``exact_probes=True`` replays the JAX
    function's own search (⌈lg(n+1)⌉ halving steps, its midpoints, its
    comparator), so the answer equals the JAX package's on a run that is
    not sorted too: a bitonic network leaves float runs with NaNs unsorted.
    """
    if side not in ("left", "right"):
        raise ValueError(f"unknown side {side!r}")
    n = arr.shape[-1]
    if not exact_probes:
        return torch.searchsorted(arr.contiguous(), query.contiguous(), side=side, out_int32=True)
    if n == 0:
        return torch.zeros(query.shape, dtype=torch.int32, device=query.device)
    ka, kq = sort_key(arr), sort_key(query)
    low = torch.zeros(query.shape, dtype=torch.int64, device=query.device)
    high = torch.full(query.shape, n, dtype=torch.int64, device=query.device)
    for _ in range(int(math.ceil(math.log2(n + 1)))):
        mid = (low + high) // 2
        v = ka.gather(-1, mid)
        go_left = kq <= v if side == "left" else kq < v
        low = torch.where(go_left, low, mid)
        high = torch.where(go_left, mid, high)
    return high.to(torch.int32)
