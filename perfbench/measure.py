"""The arithmetic of the end-to-end metrics, from a window's records.

A record is one call: its start and end on the host's clock (seconds)
and the keys it sorted. Every end-to-end metric is taken over all the
calls and all the time of the window.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

Record = Tuple[float, float, int]  # (start, end, keys)


def keys_per_s(records: Sequence[Record]) -> float:
    """Keys of every call ÷ the window: first call's start to last call's end."""
    span = records[-1][1] - records[0][0]
    return sum(r[2] for r in records) / span


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q % of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def latencies_ms(records: Sequence[Record]) -> List[float]:
    return [(end - start) * 1e3 for start, end, _ in records]


def sort_p95_ms(records: Sequence[Record]) -> float:
    return percentile(latencies_ms(records), 95.0)


def end_to_end(records: Sequence[Record], peak_bytes: int, setup_s: float) -> Dict[str, Tuple[float, str]]:
    """Every end-to-end metric this harness knows: name -> (value, unit).

    A ``.host_paced`` metric is the same quantity, under its own name and
    bound, in a cell whose card waits on the host's launches for a fifth
    of the profiled window or more: its numbers move with the host's
    speed from run to run, several times as far as a device-paced cell's.
    """
    rate, p95 = keys_per_s(records), sort_p95_ms(records)
    return {
        "keys_per_s": (rate, "keys/s"),
        "keys_per_s.host_paced": (rate, "keys/s"),
        "sort_p95_ms": (p95, "ms"),
        "sort_p95_ms.host_paced": (p95, "ms"),
        "peak_mem_gib": (peak_bytes / 2**30, "GiB"),
        "setup_s": (setup_s, "s"),
    }
