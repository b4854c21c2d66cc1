"""Peaks of one NVIDIA H100 and the work of the sort's stages.

A stage's roofline share is the least time the card could take for the
stage's work, the larger of its bytes over the memory bandwidth and its
operations over the operation rate, divided by the device time of the
kernels the stage launched. The work is the stage's, counted from what
its inputs need, not from whichever kernel implements it: each key and
payload byte the stage takes read once, each byte it gives written once.
A sort stage counts no operations here, so its bound is the bytes.

The peaks are NVIDIA's data sheet for the SXM part at its full power
limit of 700 W; the harness reads the card's limit beside them.
"""
from __future__ import annotations

from typing import Optional

#: HBM3 bandwidth, bytes/s
HBM_BYTES_PER_S = 3.35e12
#: 32-bit operations outside the tensor cores, ops/s
OPS_PER_S = 67e12
#: the power limit the peaks assume, W
PEAK_POWER_W = 700.0


def least_seconds(bytes_moved: float, ops: float = 0.0) -> float:
    """The larger of the bytes' and the operations' time at the peaks."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / OPS_PER_S)


def share_pct(bytes_moved: float, device_s: float, ops: float = 0.0) -> Optional[float]:
    """The least time over the measured device time, in %; None where no
    device time was measured (never 0 for a share of a roofline)."""
    if device_s <= 0:
        return None
    return 100.0 * least_seconds(bytes_moved, ops) / device_s


def sort_stage_bytes(n_keys: int, key_bytes: int, payload_bytes: int = 0) -> int:
    """A stage that takes n keys (and their payloads) and gives them back
    reordered: everything read once and written once."""
    return 2 * n_keys * (key_bytes + payload_bytes)
