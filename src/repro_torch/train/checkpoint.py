"""Checkpointing + restart (fault tolerance substrate).

The port of the JAX package's ``repro.train.checkpoint``, with its on-disk
layout:

* a save is one ``ckpt_<step:08d>.npz`` (leaves ``leaf_0`` ... in
  flattening order) plus a JSON manifest ``ckpt_<step:08d>.json`` carrying
  ``step``, the payload's ``sha256``, the tree structure (``treedef``),
  ``nleaves`` and ``extra``;
* writes are atomic (temporary file + ``os.replace``), so a crash mid-save
  never corrupts the latest checkpoint;
* ``latest_step`` / ``restore`` implement the restart path; the data
  pipeline is stateless-seeded (step → batch), so restart is exact;
* a bounded ``keep`` window garbage-collects old saves.

A tree is a nested dict of tensors (``{"params": ..., "opt": ...}``),
flattened in sorted-key order at every level, as ``jax.tree.flatten``
orders a dict. bfloat16 has no npz codec: it is stored as its 16 bits,
viewed through torch (no ``ml_dtypes``).
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> List:
    """``[(path, leaf), ...]`` in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def _treedef(tree: Any) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    return "*"


def _unflatten(tree: Any, leaves) -> Any:
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def _placed(tree: Any) -> bool:
    """Whether the tree holds ``DTensor`` leaves (placed on a mesh)."""
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for _, t in _flatten(tree))


def _to_saveable(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_saved(raw: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """The saved leaf as ``like``'s: its dtype and device, and for a
    ``DTensor`` its mesh and placements (each rank keeps its block)."""
    from torch.distributed.tensor import DTensor

    if isinstance(like, DTensor):
        from ..models import sharding as shd

        spec = shd.spec_of(like.device_mesh, like.placements, like.dim())
        return shd.place(_from_saved(raw, like.to_local()), like.device_mesh, spec)
    if like.dtype == torch.bfloat16 and raw.dtype == np.uint16:
        t = torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(raw)).to(like.dtype)
    return t.to(like.device)


def save(path: str, step: int, tree: Any, *, keep: int = 3, extra: Optional[Dict] = None) -> str:
    """Save ``tree``; returns the payload's path. A tree placed on a mesh
    (``DTensor`` leaves) is saved by every rank of the world: each leaf is
    gathered whole, rank 0 writes it, so the files are the one-process
    checkpoint's, byte for byte, and no rank returns before rank 0 has
    written the files and pruned the old ones (a barrier)."""
    import torch.distributed as dist

    from ..models.sharding import full

    leaves = _flatten(tree)
    placed = _placed(tree)
    # a DTensor leaf gathered whole: a collective, every rank of its mesh
    arrays = {f"leaf_{i}": _to_saveable(full(t)) for i, (_, t) in enumerate(leaves)}
    final = os.path.join(path, f"ckpt_{step:08d}.npz")
    if not placed or dist.get_rank() == 0:
        _write(path, final, step, tree, arrays, len(leaves), keep, extra)
    if placed:
        dist.barrier()
    return final


def _write(path: str, final: str, step: int, tree: Any, arrays: Dict, nleaves: int, keep: int,
           extra: Optional[Dict]) -> None:
    os.makedirs(path, exist_ok=True)
    tmp_fd, blob = tempfile.mkstemp(dir=path, suffix=".tmp.npz")
    os.close(tmp_fd)
    np.savez(blob, **arrays)  # name ends in .npz → written in place
    with open(blob, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    os.replace(blob, final)
    manifest = {
        "step": step,
        "sha256": digest,
        "treedef": _treedef(tree),
        "nleaves": nleaves,
        "extra": extra or {},
    }
    mtmp = final + ".manifest.tmp"
    with open(mtmp, "w") as f:
        json.dump(manifest, f, indent=2)
    os.replace(mtmp, final.replace(".npz", ".json"))
    _gc(path, keep)


def _gc(path: str, keep: int) -> None:
    steps = sorted(all_steps(path))
    for s in steps[:-keep] if keep > 0 else []:
        for suffix in (".npz", ".json"):
            p = os.path.join(path, f"ckpt_{s:08d}{suffix}")
            if os.path.exists(p):
                os.remove(p)


def all_steps(path: str):
    if not os.path.isdir(path):
        return []
    out = []
    for f in os.listdir(path):
        if f.startswith("ckpt_") and f.endswith(".npz"):
            out.append(int(f[5:13]))
    return sorted(out)


def latest_step(path: str) -> Optional[int]:
    steps = all_steps(path)
    return steps[-1] if steps else None


def restore(path: str, step: int, like: Any, *, verify: bool = True) -> Any:
    """Restore into the structure of ``like``: each leaf a new tensor on the
    device and in the dtype of ``like``'s leaf, and a ``DTensor`` leaf's
    placements on its mesh (the reference restores into shardings)."""
    blob = os.path.join(path, f"ckpt_{step:08d}.npz")
    man = blob.replace(".npz", ".json")
    if verify and os.path.exists(man):
        with open(man) as f:
            manifest = json.load(f)
        with open(blob, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if digest != manifest["sha256"]:
            raise IOError(f"checkpoint {blob} integrity check failed")
    with np.load(blob) as data:
        leaves = [_from_saved(data[f"leaf_{i}"], t) for i, (_, t) in enumerate(_flatten(like))]
    return _unflatten(like, iter(leaves))
