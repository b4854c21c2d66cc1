"""Roofline terms of one step of the port, counted from the ops it runs.

The port of the JAX package's ``repro.roofline.analysis``. The reference reads XLA's compiled artifact: ``cost_analysis``, and the
dots of the optimized HLO text (``parse_dot_stats``), scaled by each
``while`` body's trip count. The port has no HLO. :func:`count_step` runs
the step under a dispatch mode instead (on ``meta`` tensors for the
dry-run: nothing is allocated or computed) and sums, over every matrix
product it dispatches (``mm``, ``bmm``, ``addmm``, ``baddbmm`` and the
``_scaled_dot_product_*`` attention kernels), the FLOPs (2 · result
elements · contracted size) and the bytes (the products' operands and
result). A loop runs as many times as the step runs it, so no trip-count
correction is needed; a rematerialized block counts its forward twice, as
the card runs it. On a mesh (the dry-run's fake world of 256 or 512
ranks) the mode sees one rank's local ops and collectives: the FLOPs and
bytes are one device's, and each collective's bytes are counted with the
reference's ring factors (:func:`_ring_bytes`).

Terms per step, in seconds:

    compute = counted FLOPs / PEAK_FLOPS
    memory  = counted bytes / HBM_BW
    collective = counted collective bytes / NET_BW

The constants are the published peaks of one H100 SXM and of its network
link off a DGX H100 node, so the seconds
are bounds a step cannot beat, not times. ``model_flops`` is the analytic
6 · N_active · D (train) or 2 · N_active · D (inference) beside them;
their ratio (``useful_flops_ratio``) flags remat's recompute and the
attention's quadratic work.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: H100 SXM published dense bfloat16 tensor-core peak (no sparsity), FLOP/s
PEAK_FLOPS = 989e12
#: H100 SXM published HBM3 bandwidth, bytes/s
HBM_BW = 3.35e12
#: bytes/s one H100 sends off its node: a DGX H100 gives each of its 8 GPUs
#: one 400 Gb/s ConnectX-7 NIC (NVIDIA DGX H100 user guide, "Hardware
#: overview"), 50 GB/s. Every axis of the (16, 16) and (2, 16, 16) meshes
#: spans more than one 8-GPU node, so a collective over one moves at this
#: rate, not at NVLink's 900 GB/s
NET_BW = 50e9


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·D tokens for train, 2·N_active·D for
    inference (per generated/prefilled token)."""
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * n_active * tokens


def _nbytes(t: torch.Tensor) -> int:
    """A tensor's bytes on this device (a ``DTensor``'s local block)."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()


def _tensors(tree):
    """The tensors of a nested structure of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


#: the collectives a step dispatches: op name -> (kind, index of the
#: tensor this rank sends). ``_c10d_functional`` ops are ``DTensor``'s
#: (and the functional collectives'); ``c10d`` ops are ``torch.distributed``'s
#: own (the MoE's and the sort's processor groups, the flash-decode combine)
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", 0), "reduce_scatter_tensor": ("reduce-scatter", 0),
    "all_reduce": ("all-reduce", 0), "all_to_all_single": ("all-to-all", 0),
    "allreduce_": ("all-reduce", 0), "allgather_": ("all-gather", 1), "_allgather_base_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1), "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1), "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_base_": ("all-to-all", 1), "alltoall_": ("all-to-all", 1), "broadcast_": ("broadcast", 0),
}


def _group_size(func, args) -> int:
    """The size of the process group a collective runs over: the functional
    collectives name it (or give its size), ``c10d``'s ops carry it."""
    import torch.distributed as dist

    for a in args:
        if isinstance(a, dist.ProcessGroup):
            return a.size()
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:  # another boxed class (the reduce op)
                continue
    name = args[-1]
    if isinstance(name, str):
        from torch.distributed.distributed_c10d import _resolve_process_group

        return _resolve_process_group(name).size()
    raise TypeError(f"no process group in {func}'s arguments")


def _ring_bytes(kind: str, sent: int, g: int) -> float:
    """Bytes a rank moves for one collective over g ranks, by the ring
    algorithms (the reference's factors): all-gather (g-1)·shard,
    reduce-scatter operand·(g-1)/g, all-reduce 2·operand·(g-1)/g,
    all-to-all and broadcast the operand."""
    if kind == "all-gather":
        return (g - 1) * sent
    if kind == "reduce-scatter":
        return sent * (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * sent * (g - 1) / g
    return float(sent)


class _DotCounter(TorchDispatchMode):
    """Sums the FLOPs and bytes of every matrix product dispatched under it,
    counts every aten op, and sums each collective's bytes by kind. A
    ``DTensor`` op is passed on to ``DTensor`` first (``NotImplemented``,
    as ``CommDebugMode`` does), so the mode sees the local ops and the
    collectives it turns into: the counts are one rank's."""

    def __init__(self):
        super().__init__()
        self.flops = self.bytes = 0.0
        self.ops = 0
        self.collectives: Dict[str, float] = {}
        self.collective_ops = 0

    def _collective(self, func, args) -> None:
        kind, at = _COLLECTIVES[func.overloadpacket.__name__]
        sent = args[at]
        sent = sum(_nbytes(t) for t in _tensors(sent))
        g = _group_size(func, args)
        if g > 1:
            self.collectives[kind] = self.collectives.get(kind, 0.0) + _ring_bytes(kind, sent, g)
        self.collective_ops += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func.overloadpacket
        if func.namespace in ("c10d", "_c10d_functional", "c10d_functional") and packet.__name__ in _COLLECTIVES:
            self._collective(func, args)
            return out
        if packet in (torch.ops.aten.mm, torch.ops.aten.bmm):
            a, b = args[0], args[1]
        elif packet in (torch.ops.aten.addmm, torch.ops.aten.baddbmm):
            a, b = args[1], args[2]  # the bias is added, not multiplied
        elif packet.__name__.startswith("_scaled_dot_product"):
            from torch.utils.flop_counter import flop_registry

            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
                self.bytes += sum(_nbytes(t) for t in list(_tensors(args))[:3]) + _nbytes(next(_tensors(out)))
            return out
        else:
            return out
        self.flops += 2.0 * out.numel() * a.shape[-1]
        self.bytes += _nbytes(a) + _nbytes(b) + _nbytes(out)
        return out


def count_step(fn, *args) -> Dict[str, float]:
    """Run ``fn(*args)`` once and count it: ``dot_flops`` and ``dot_bytes``
    of its matrix products (the reference's ``parse_dot_stats``),
    ``aten_ops`` dispatched, and ``args_bytes``, the bytes of every tensor
    in ``args`` (parameters, optimizer state, batch or cache: the
    reference's ``memory_analysis().argument_size_in_bytes``)."""
    args_bytes = sum(_nbytes(t) for t in _tensors(args))
    counter = _DotCounter()
    with counter:
        fn(*args)
    return {"dot_flops": counter.flops, "dot_bytes": counter.bytes, "aten_ops": counter.ops,
            "args_bytes": float(args_bytes), "collectives": dict(counter.collectives),
            "collective_ops": counter.collective_ops}


def analyze(counts: Dict[str, float], *, cfg, shape, devices: int = 1) -> Dict:
    """The reference's ``analyze_compiled`` keys, where they mean the same,
    from ``count_step``'s counts of one device's step."""
    info: Dict = {"devices": devices, "mem_args_gb": round(counts["args_bytes"] / 2**30, 3)}
    flops, bytes_ = counts["dot_flops"], counts["dot_bytes"]
    info["dot_flops_per_dev"] = flops
    info["dot_bytes_per_dev"] = bytes_
    mf = model_flops(cfg, shape)
    info["model_flops_total"] = mf
    per_dev_model = mf / devices

    coll = counts.get("collectives", {})
    coll_total = sum(coll.values())
    info["collectives"] = {k: round(v / 2**20, 2) for k, v in coll.items()}
    info["collective_mb_per_dev"] = round(coll_total / 2**20, 2)
    t_compute = flops / PEAK_FLOPS
    t_compute_model = per_dev_model / PEAK_FLOPS
    t_memory = bytes_ / HBM_BW
    t_coll = coll_total / NET_BW
    info["t_compute_s"] = t_compute
    info["t_compute_model_s"] = t_compute_model
    info["t_memory_s"] = t_memory
    info["t_collective_s"] = t_coll
    terms = {"compute": max(t_compute, t_compute_model), "memory": t_memory, "collective": t_coll}
    info["dominant"] = max(terms, key=terms.get)
    if flops:
        info["useful_flops_ratio"] = round(per_dev_model / flops, 4)
    # useful work's time over the achievable bound (the terms' sum: no
    # overlap), as the reference
    bound = t_compute + t_memory + t_coll
    if bound > 0:
        info["roofline_fraction"] = round(t_compute_model / bound, 4)
    return info
