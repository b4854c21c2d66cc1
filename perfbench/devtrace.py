"""The device trace of a run's profiled part, reduced to what the metrics read.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` (CPU and CUDA
activity) inside a ``perfbench:window`` range, exports the Chrome trace
to a temporary file, reads it back and deletes it. ``reduce`` takes the
trace's events apart:

* device operations: kernels, copies and sets on the card's timeline;
* ``busy_s``: the union of their intervals inside the window, and
  ``window_s``: the window range's length on the host, on the same clock;
* ``range_device_s[name]``: the device time of the operations launched
  while the host was inside a ``perfbench:<name>`` range, matched by the
  launch's correlation id (a kernel runs later than its launch, so its
  own interval says nothing of which range launched it);
* ``device_ops``: device seconds by operation name, the largest first;
* ``idle_gaps``: the window's idle seconds on the device, by what the
  host was doing halfway through each gap (the innermost ``perfbench``
  range, or ``harness`` outside them, and the innermost host event, or
  ``python`` between events), the largest first.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

PREFIX = "perfbench:"
WINDOW = PREFIX + "window"
_DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
_LAUNCH_CATS = {"cuda_runtime", "cuda_driver", "runtime", "driver"}
_HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "runtime", "driver"}
TOP = 10


def range_fn(name: str, fn: Callable) -> Callable:
    """``fn`` wrapped in a ``perfbench:<name>`` profiler range."""
    import torch

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(PREFIX + name):
            return fn(*args, **kwargs)

    return wrapped


@contextlib.contextmanager
def ranges(points: List[Tuple[object, str, str]]):
    """Open a range around each ``(module, attribute, name)`` the program
    looks up at call time, for the duration of the block."""
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in points]
    try:
        for mod, attr, name in points:
            setattr(mod, attr, range_fn(name, getattr(mod, attr)))
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def profiled(fn: Callable, device_type: str = "cuda") -> Dict:
    """Run ``fn`` under the profiler and return ``reduce`` of its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device_type == "cuda" else [])
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            if device_type == "cuda":
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)
    return reduce(events.get("traceEvents", events) if isinstance(events, dict) else events)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class _HostSweep:
    """What the host was doing at increasing times: the stack of host
    events open at t (one thread's events nest), built in one pass."""

    def __init__(self, host: List[Tuple[float, float, str]]) -> None:
        self._host, self._i, self._open = host, 0, []

    def at(self, t: float) -> Tuple[str, str]:
        """(innermost perfbench range, innermost other host event) at t."""
        while self._i < len(self._host) and self._host[self._i][0] <= t:
            self._open.append(self._host[self._i])
            self._i += 1
        self._open = [h for h in self._open if h[1] >= t]
        rng = next((n[len(PREFIX):] for _, _, n in reversed(self._open)
                    if n.startswith(PREFIX) and n != WINDOW), "")
        ev = next((n for _, _, n in reversed(self._open) if not n.startswith(PREFIX)), "")
        return rng, ev


def reduce(events: List[Dict]) -> Dict:
    """The module's quantities from a Chrome trace's event list (µs)."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    windows = [e for e in xs if e.get("name") == WINDOW and e.get("cat", "").lower() == "user_annotation"]
    if not windows:
        raise ValueError("the trace holds no perfbench:window range")
    win = windows[0]
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    tid = win.get("tid")

    device = [e for e in xs if e.get("cat", "").lower() in _DEVICE_CATS]
    host = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("name", ""))
        for e in xs
        if e.get("cat", "").lower() in _HOST_CATS and e.get("tid") == tid
    )
    launches = {
        e["args"]["correlation"]: float(e["ts"])
        for e in xs
        if e.get("cat", "").lower() in _LAUNCH_CATS and "correlation" in e.get("args", {})
    }
    spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for e in xs:
        name = e.get("name", "")
        if e.get("cat", "").lower() == "user_annotation" and name.startswith(PREFIX) and name != WINDOW:
            spans[name[len(PREFIX):]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    for ivs in spans.values():
        ivs.sort()

    by_op: Dict[str, float] = defaultdict(float)
    range_us: Dict[str, float] = defaultdict(float)
    range_n: Dict[str, int] = defaultdict(int)
    clipped = []
    for e in device:
        a, d = float(e["ts"]), float(e.get("dur", 0))
        by_op[e.get("name", "?")[:120]] += d
        clipped.append((max(a, w0), min(a + d, w1)))
        t = launches.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        for name, ivs in spans.items():
            i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
            if i >= 0 and ivs[i][0] <= t <= ivs[i][1]:
                range_us[name] += d
                range_n[name] += 1
    busy = _union([(a, b) for a, b in clipped if b > a])

    gaps: Dict[str, float] = defaultdict(float)
    sweep = _HostSweep(host)
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            rng, ev = sweep.at((edge + a) / 2)
            gaps[f"{rng or 'harness'}/{ev or 'python'}"] += a - edge
        edge = max(edge, b)
    top = lambda d: [[k, v / 1e6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]  # noqa: E731
    return {
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "n_device_ops": len(device),
        "range_device_s": {k: v / 1e6 for k, v in range_us.items()},
        "range_device_ops": dict(range_n),
        "device_ops": top(by_op),
        "idle_gaps": top(gaps),
    }
