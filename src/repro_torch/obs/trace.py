"""Superstep spans — host-side tracing of the BSP sort pipeline.

A :class:`Tracer` records *spans* (named intervals with labeled args) and
*points* (instant events: host syncs, distribution snapshots) from the
launch/wait boundaries of the sort drivers and the service dispatcher.
Everything the tracer touches is host-side Python around the drivers'
device launches, never inside a stage, so a traced run launches the same
kernels on the same tensors as an untraced one (``SortConfig.obs`` is
excluded from the config's equality/hash — see ``core/types.py``) and
differs only in host-side bookkeeping plus the explicit syncs at span
boundaries (``torch.cuda.synchronize``) that make span durations include
the device's time.

Span schema (one dict per span, the JAX package's)::

    name  str   "prepare" | "route" | "queue" | "form" | "launch" |
                "flight" | ...
    cat   str   "sort" | "dispatch" | "moe" | ...
    tid   str   timeline lane ("sort0", "batch3", ...)
    t0    float perf_counter seconds at span start
    dur   float span length in seconds (>= 0)
    args  dict  JSON-able labels/measurements, notably for "route" spans:
                tier, rung, ok, h_words, supersteps, recv_max, recv_mean,
                imbalance, sync_s

``chrome_trace()`` exports the standard Chrome ``trace_event`` JSON
(load in chrome://tracing or Perfetto): spans become ``ph="X"`` complete
events on one row per ``tid``, points become ``ph="i"`` instants — the
dispatcher's queue→form→launch→flight rows make ``max_in_flight`` overlap
visually auditable. :func:`validate_chrome_trace` is the schema check CI
runs on the emitted file.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import time
from typing import Dict, List, Optional

import numpy as np


def _jsonable(v):
    """Coerce span args to JSON-able types (numpy scalars/arrays included)."""
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return v


class Tracer:
    """Collects spans/points from the drivers; one instance per traced run.

    Passed as ``SortConfig(obs=...)`` — the config field is
    compare/hash-excluded, so a traced and an untraced config share every
    executor entry. ``clock`` is injectable for tests.
    """

    def __init__(self, clock=time.perf_counter) -> None:
        self._clock = clock
        self.t0 = clock()  # chrome-trace epoch
        self.spans: List[Dict] = []
        self.points: List[Dict] = []
        self._ids = itertools.count()

    def next_tid(self, prefix: str) -> str:
        """A fresh timeline-lane id (``sort0``, ``batch3``, ...)."""
        return f"{prefix}{next(self._ids)}"

    def now(self) -> float:
        """The tracer's clock — drivers capture launch timestamps with it."""
        return self._clock()

    def add_span(
        self,
        name: str,
        t_start: float,
        *,
        t_end: Optional[float] = None,
        cat: str = "sort",
        tid: str = "main",
        **args,
    ) -> None:
        """Record an interval whose start was captured earlier with :meth:`now`.

        The async drivers need this form: a route span opens at launch (in
        ``InFlightSort.__init__``) and closes at the overflow host-sync (in
        ``wait``) — two different stack frames, so the :meth:`span` context
        manager cannot bracket it. ``t_end`` pins the close to the sync
        itself, excluding any host-side count reads done after it.
        """
        end = self._clock() if t_end is None else t_end
        self.spans.append(
            {
                "name": name,
                "cat": cat,
                "tid": tid,
                "t0": t_start,
                "dur": max(0.0, end - t_start),
                "args": _jsonable(args),
            }
        )

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "sort", tid: str = "main", **args):
        """Record one interval; the yielded dict collects late-bound args."""
        extra: Dict = {}
        t0 = self._clock()
        try:
            yield extra
        finally:
            self.spans.append(
                {
                    "name": name,
                    "cat": cat,
                    "tid": tid,
                    "t0": t0,
                    "dur": max(0.0, self._clock() - t0),
                    "args": _jsonable({**args, **extra}),
                }
            )

    def point(self, name: str, cat: str = "sort", tid: str = "main", **args):
        """Record one instant event (host syncs, distribution snapshots)."""
        self.points.append(
            {
                "name": name,
                "cat": cat,
                "tid": tid,
                "t0": self._clock(),
                "args": _jsonable(args),
            }
        )

    # ------------------------------------------------------------- queries
    def route_spans(self) -> List[Dict]:
        """The per-rung route spans — the (g, L) fit's samples."""
        return [s for s in self.spans if s["name"] == "route"]

    # ------------------------------------------------------------- exports
    def chrome_trace(self) -> Dict:
        """Standard Chrome ``trace_event`` JSON (ts/dur in microseconds)."""
        tids = sorted(
            {e["tid"] for e in self.spans} | {e["tid"] for e in self.points}
        )
        tid_no = {t: i for i, t in enumerate(tids)}
        events: List[Dict] = [
            {
                "ph": "M",
                "pid": 0,
                "tid": tid_no[t],
                "name": "thread_name",
                "args": {"name": t},
            }
            for t in tids
        ]
        for s in self.spans:
            events.append(
                {
                    "ph": "X",
                    "pid": 0,
                    "tid": tid_no[s["tid"]],
                    "name": s["name"],
                    "cat": s["cat"],
                    "ts": (s["t0"] - self.t0) * 1e6,
                    "dur": s["dur"] * 1e6,
                    "args": s["args"],
                }
            )
        for p in self.points:
            events.append(
                {
                    "ph": "i",
                    "pid": 0,
                    "tid": tid_no[p["tid"]],
                    "name": p["name"],
                    "cat": p["cat"],
                    "ts": (p["t0"] - self.t0) * 1e6,
                    "s": "t",
                    "args": p["args"],
                }
            )
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)
        return path

    def fit(self):
        """Least-squares (g, L) machine profile over the route spans."""
        from .profile import fit_gl

        return fit_gl(self.route_spans())

    def cost_report(self) -> Dict:
        """Fitted profile + per-superstep predicted-vs-measured rows."""
        from .profile import cost_report

        return cost_report(self)


def validate_chrome_trace(data: Dict) -> List[str]:
    """Schema check of an exported trace; returns problems (empty = valid)."""
    problems: List[str] = []
    events = data.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents missing or empty"]
    for i, e in enumerate(events):
        where = f"traceEvents[{i}]"
        ph = e.get("ph")
        if ph not in ("X", "i", "M"):
            problems.append(f"{where}: bad ph {ph!r}")
            continue
        for field in ("name", "pid", "tid"):
            if field not in e:
                problems.append(f"{where}: missing {field!r}")
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < -1e-6:
            problems.append(f"{where}: bad ts {ts!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"{where}: bad dur {dur!r}")
    return problems


def validate_spans(tracer: "Tracer") -> List[str]:
    """Schema check of the raw span list; returns problems (empty = valid)."""
    problems: List[str] = []
    for i, s in enumerate(tracer.spans):
        where = f"spans[{i}]"
        for field in ("name", "cat", "tid", "t0", "dur", "args"):
            if field not in s:
                problems.append(f"{where}: missing {field!r}")
        if s.get("dur", 0) < 0:
            problems.append(f"{where}: negative dur")
        if not isinstance(s.get("args", {}), dict):
            problems.append(f"{where}: args not a dict")
        if s.get("name") == "route":
            for field in ("tier", "ok", "h_words", "supersteps"):
                if field not in s["args"]:
                    problems.append(f"{where}: route span missing {field!r}")
    return problems


def resolve_tracer(obj) -> Optional[Tracer]:
    """The tracer carried by a config-ish object, or None.

    Drivers call this on ``cfg.obs`` — any object with span()/point() duck-
    types, so tests can inject fakes.
    """
    if obj is None:
        return None
    if hasattr(obj, "span") and hasattr(obj, "point"):
        return obj
    return None
