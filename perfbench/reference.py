"""The plain reference of a sort, its comparison, and its controls.

The reference is a stable sort of the row-major flattened input (keys,
and the payload carried with each key): plain ``torch.sort(stable=True)``
and a gather. It imports nothing of the program. ``compare`` judges the
program's output against it by three counts, each with the limit 0:

* ``lost_keys`` — |keys the answer holds − keys of the input|;
* ``key_mismatches`` — positions whose key differs from the reference's
  (a length difference counts its surplus positions);
* ``payload_mismatches`` — positions whose payload differs (the stable
  order of equal keys included), in a configuration with a payload.

The controls stand in the program's place with one of its guarantees
broken, and have to come out not correct:

* ``int16`` — keys compared at the next narrower integer width (their top
  16 bits), the step of a shorter radix or compare key;
* ``unstable`` — equal keys in a drawn order, not the input's: breaks
  stability, which only a payload can show.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

#: every number compared has the limit 0: a sort is exact
LIMITS = {"lost_keys": 0, "key_mismatches": 0, "payload_mismatches": 0}


def stable_sort(keys: torch.Tensor, vals: Optional[torch.Tensor] = None):
    """The reference: flattened keys (and payload) in stable key order."""
    flat = keys.reshape(-1)
    sorted_keys, order = torch.sort(flat, stable=True)
    return sorted_keys, (None if vals is None else vals.reshape(-1)[order])


def control(keys: torch.Tensor, vals: Optional[torch.Tensor], mode: str, gen: Optional[torch.Generator] = None):
    """The reference with one guarantee broken (see the module's list)."""
    flat = keys.reshape(-1)
    fvals = None if vals is None else vals.reshape(-1)
    if mode == "int16":
        order = torch.sort(torch.bitwise_right_shift(flat, 16), stable=True).indices
    elif mode == "unstable":
        perm = torch.randperm(flat.numel(), generator=gen, device=flat.device)
        order = perm[torch.sort(flat[perm], stable=True).indices]
    else:
        raise ValueError(f"unknown control {mode!r}")
    return flat[order], (None if fvals is None else fvals[order])


def _mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    m = min(got.numel(), want.numel())
    return int((got[:m] != want[:m]).sum()) + abs(got.numel() - want.numel())


def compare(
    out_keys: torch.Tensor,
    out_vals: Optional[torch.Tensor],
    ref_keys: torch.Tensor,
    ref_vals: Optional[torch.Tensor],
) -> Dict[str, int]:
    """The counts of the module's list for one answer (flat tensors)."""
    nums = {
        "lost_keys": abs(out_keys.numel() - ref_keys.numel()),
        "key_mismatches": _mismatches(out_keys, ref_keys),
    }
    if ref_vals is not None:
        nums["payload_mismatches"] = (
            out_keys.numel() if out_vals is None else _mismatches(out_vals, ref_vals)
        )
    return nums


def judge(out_keys, out_vals, keys, vals) -> Dict[str, int]:
    """The reference of ``keys``/``vals`` worked out here, and the answer's counts."""
    ref_keys, ref_vals = stable_sort(keys, vals)
    return compare(out_keys, out_vals, ref_keys, ref_vals)
