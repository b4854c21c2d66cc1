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


def params_from_reference(tree: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """The JAX package's LM parameter pytree (leaves as numpy arrays) as the
    port's parameters by state-dict name: top-level leaves keep their name,
    and each stacked ``(L, ...)`` leaf of ``tree["layers"]`` splits into
    ``layers.<i>.<leaf>``. Bytes and dtypes are kept."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in tree.items():
        if name == "layers":
            for sub, stacked in leaf.items():
                t = _host_tensor(stacked)
                out.update({f"layers.{i}.{sub}": t[i].to(dev) for i in range(t.shape[0])})
        else:
            out[name] = _host_tensor(leaf).to(dev)
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
    or moments: port tensors by state-dict name as the JAX package's tree of
    numpy arrays, ``layers.<i>.<leaf>`` stacked into ``layers[leaf]`` of
    shape ``(L, ...)``. bfloat16 widens to float32 (exactly: numpy has no
    bfloat16 of its own); other dtypes are kept."""

    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    out: Dict = {}
    layers: Dict[str, Dict[int, np.ndarray]] = {}
    for name, t in named.items():
        if name.startswith("layers."):
            _, i, leaf = name.split(".")
            layers.setdefault(leaf, {})[int(i)] = host(t)
        else:
            out[name] = host(t)
    if layers:
        out["layers"] = {leaf: np.stack([per[i] for i in range(len(per))]) for leaf, per in layers.items()}
    return out
