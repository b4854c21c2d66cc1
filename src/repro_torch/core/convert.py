"""Carry state across from the JAX package.

The JAX package's ``SortConfig`` and ``PreparedSort`` arrive as plain data
(a dict of fields, numpy arrays), so this module imports nothing of it. A
test can then run the reference's prepare stage, carry its state across,
and hold the port's route stage (Ph4–Ph6) alone against the reference's.
A capacity planner's JSON history (the reference's
``CapacityPlanner.save``) loads into the port's planner, a sorted
view's snapshot (keys and payloads as numpy) installs into the port's
``SortedView``, and a ``FaultPlan`` or a ``ServiceConfig`` carries every
field across, so both packages run one seeded fault schedule. An LM's
parameter pytree (numpy leaves) becomes the port's parameters by name, its
AdamW state the port's state, and port tensors by name go back to the
reference's stacked tree for a leaf-by-leaf comparison.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from .types import PreparedSort, SortConfig, resolve_device

def _fields_from_reference(fields: Mapping, cls) -> dict:
    """Keyword arguments of the port's ``cls`` from a reference dataclass's
    fields: a fault plan is converted, a tracer refused (a reference
    ``Tracer`` means nothing to the port; pass ``obs=None``)."""
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in fields.items():
        if key not in names:
            raise ValueError(f"unknown {cls.__name__} field {key!r}")
        if key == "obs" and value is not None:
            raise ValueError("the port cannot use the reference's 'obs' handle; pass obs=None")
        if key == "chaos" and value is not None:
            value = fault_plan_from_reference(value)
        kwargs[key] = value
    return kwargs


def config_from_reference(fields: Mapping) -> SortConfig:
    """A port ``SortConfig`` from the reference config's fields as a dict."""
    return SortConfig(**_fields_from_reference(fields, SortConfig))


def fault_plan_from_reference(plan):
    """A port ``FaultPlan`` with every field of the JAX package's plan.

    Fields only: the port's plan starts a fresh schedule (its sequence
    numbers, fired sets and injection counts at zero), so both plans give
    the same decisions on the same sequence of queries.
    """
    from ..chaos import FaultPlan

    return FaultPlan(**_fields_from_reference(_asdict(plan), FaultPlan))


def service_config_from_reference(cfg):
    """A port ``ServiceConfig`` with every field of the JAX package's (its
    fault plan converted by :func:`fault_plan_from_reference`)."""
    from ..service import ServiceConfig

    return ServiceConfig(**_fields_from_reference(_asdict(cfg), ServiceConfig))


def _asdict(obj) -> dict:
    """A dataclass instance's fields, shallow (``dataclasses.asdict`` would
    deep-copy a fault plan held in a field)."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _tensor(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def prepared_from_reference(xs, vals: Sequence, splits, device=None) -> PreparedSort:
    """A port ``PreparedSort`` from the reference's arrays (global layout).

    xs (p, n_per_proc); vals a sequence of (p, n_per_proc, ...) payloads;
    splits the det (keys, procs, idxs) splitters, each (p, p-1), or the
    radix route's counted ``(bounds,)``, (p, p+1).
    """
    dev = resolve_device(device)
    return PreparedSort(
        xs=_tensor(xs, dev),
        vals=tuple(_tensor(v, dev) for v in vals),
        splits=None if splits is None else tuple(_tensor(s, dev) for s in splits),
    )


def planner_from_reference(history, **planner_kw):
    """A port ``CapacityPlanner`` holding a history the JAX package's
    planner wrote: a path to its JSON file, or the JSON text. The format is
    shared, so the port plans from it as the reference would."""
    import os

    from ..planner import CapacityPlanner

    if os.path.exists(str(history)):
        return CapacityPlanner(path=str(history), **planner_kw)
    planner = CapacityPlanner(**planner_kw)
    planner.load_json(history)
    return planner


def view_from_reference(keys, payloads: Sequence = (), **view_kw):
    """A port ``SortedView`` installed with a snapshot of the JAX package's
    view: its sorted ``keys`` and aligned ``payloads`` as numpy arrays."""
    from ..delta import SortedView

    view = SortedView(**view_kw)
    view.install(np.asarray(keys), [np.asarray(v) for v in payloads])
    return view


def _host_tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor; ``ml_dtypes.bfloat16`` (which
    ``torch.from_numpy`` refuses) goes through its uint16 bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


#: the reference's stacked sub-trees: each path here holds leaves with one
#: leading stacked axis per listed prefix of it (jamba's ``blocks.mamba``
#: leaves are ``(blocks, slot, ...)``: ``blocks`` and ``blocks.mamba``)
_STACKED = {("layers",), ("blocks",), ("blocks", "mamba"), ("blocks", "dense"), ("blocks", "moe"),
            ("blocks", "attn_norm"), ("blocks", "mlp_norm"), ("mlstm",), ("slstm",), ("enc",), ("dec",)}


def _leaves(tree: Mapping, path=()):
    """``(path, leaf)`` of a nested dict, in insertion order."""
    for key, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _leaves(sub, path + (key,))
        else:
            yield path + (key,), sub


def _stacked_depth(path) -> int:
    return sum(path[:i] in _STACKED for i in range(1, len(path) + 1))


def _port_name(path, index) -> str:
    """The state-dict name of one slice of a stacked leaf: each stacking
    key of ``path`` followed by its index (``blocks.3.mamba.2.in_proj``)."""
    out, it = [], iter(index)
    for i, key in enumerate(path):
        out.append(key)
        if path[: i + 1] in _STACKED:
            out.append(str(next(it)))
    return ".".join(out)


def params_from_reference(tree: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's LM parameter pytree (leaves as numpy arrays) as the
    port's parameters by state-dict name: top-level leaves keep their name,
    and each stacked leaf splits along its stacked axes into one tensor per
    layer, or per block and slot (``layers.<i>.<leaf>``,
    ``blocks.<b>.mamba.<slot>.<leaf>``, ``blocks.<b>.attn_norm.<i>``,
    ``mlstm.<i>.<leaf>``, ``enc.<i>.<leaf>``; see ``models.lm``). A stack
    of length 0 gives no name. Bytes and dtypes are kept."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(tree):
        t = _host_tensor(leaf)
        depth = _stacked_depth(path)
        for index in np.ndindex(*t.shape[:depth]):
            out[_port_name(path, index)] = t[index].to(dev)
    return out


def opt_state_from_reference(state: Mapping, device=None) -> Dict:
    """The JAX package's AdamW state ``{"m", "v", "step"}`` (numpy leaves)
    as the port's: ``m`` and ``v`` split by layer as the parameters are
    (``params_from_reference``), ``step`` kept as an int32 scalar."""
    dev = resolve_device(device)
    return {"m": params_from_reference(state["m"], dev), "v": params_from_reference(state["v"], dev),
            "step": _host_tensor(np.asarray(state["step"])).to(dev)}


def tree_to_reference(named: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of ``params_from_reference``, for parameters, gradients
    or moments: port tensors by state-dict name as the JAX package's nested
    tree of numpy arrays, each stacked leaf's slices stacked again along
    its stacked axes (``layers.<i>.<leaf>`` into ``layers[leaf]`` of shape
    ``(L, ...)``). A stack of length 0 has no name, so its leaves are
    absent. bfloat16 widens to float32 (exactly: numpy has no bfloat16 of
    its own); other dtypes are kept."""

    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    slices: Dict[tuple, Dict[tuple, np.ndarray]] = {}
    for name, t in named.items():
        segs = name.split(".")
        path = tuple(s for s in segs if not s.isdigit())
        index = tuple(int(s) for s in segs if s.isdigit())
        slices.setdefault(path, {})[index] = host(t)
    out: Dict = {}
    for path, per in slices.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _restack(per) if _stacked_depth(path) else per[()]
    return out


def _restack(per: Dict[tuple, np.ndarray]) -> np.ndarray:
    """Slices by index tuple as one array, the index axes leading."""
    shape = tuple(max(ix) + 1 for ix in zip(*per))
    if len(per) != math.prod(shape):
        raise ValueError(f"{len(per)} slices for a stack of {shape}")
    first = next(iter(per.values()))
    out = np.empty(shape + first.shape, first.dtype)
    for index, a in per.items():
        out[index] = a
    return out
