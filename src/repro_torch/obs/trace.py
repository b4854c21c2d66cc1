"""Superstep spans — host-side tracing of the BSP sort pipeline.

A :class:`Tracer` records *spans* (named intervals with labeled args) and
*points* (instant events: host syncs, distribution snapshots). The sort
drivers record a ``prepare`` span and one ``route`` span a rung at their
launch/wait boundaries; the stages of the sort record ``stage`` spans from
inside, through :func:`stage`. A traced run launches the same kernels on
the same tensors as an untraced one (``SortConfig.obs`` is excluded from
the config's equality/hash — see ``core/types.py``) and differs only in
host-side bookkeeping, CUDA timing events, and the one synchronize that
closes the ``prepare`` span, so that its duration includes the device's
time. Nothing else here waits for the device: an event is read at a sync
the driver makes anyway (the prepare span's, a rung's overflow read), and
one not yet complete is read at the next.

Span schema (one dict per span, the JAX package's, plus the stages)::

    name  str   "prepare" | "route" | "queue" | "form" | "launch" |
                "flight" | ... | a stage: "local_sort",
                "local_sort.tiles", "local_sort.rank_merge", "splitters",
                "partition", "exchange", "merge_tree", "merge_sort"
    cat   str   "sort" | "dispatch" | "moe" | "stage" | ...
    tid   str   timeline lane ("sort0", "batch3", ...)
    t0    float perf_counter seconds at span start
    dur   float span length in seconds (>= 0)
    args  dict  JSON-able labels/measurements, notably for "route" spans:
                tier, rung, ok, h_words, supersteps, recv_max, recv_mean,
                imbalance, sync_s, stream_ms; for "stage" spans: parent
                ("prepare" | "route"), rung, tier, host_ms (the enqueue
                time, ``dur`` in ms), stream_ms, and the stage's counts
                from shapes (keys in; the exchange's receive slots)

``stream_ms`` is the device stream's time between two CUDA events
recorded at the span's edges (``prepare``/``route``: at the launch and
after the stage's last enqueued work), or null off CUDA.

:func:`stage` is the hook the stage code enters. It acts three ways:

* no tracer active and no profiler recording: one shared null context,
  after two flag reads — no clock, no event, no range;
* a profiler recording: a ``bsp:<name>`` range
  (``torch.profiler.record_function``), tracer or not;
* a tracer active (:func:`lane`, which the drivers enter around the
  prepare stage and around each rung's launch): a ``stage`` span too.

The drivers open ``bsp:prepare`` and ``bsp:rung.<tier>`` ranges the same
way (:func:`lane`). Under a profiler every sort span the tracer records
therefore has a range on the device trace's clock, and
``chrome_trace(align_to=<profiler trace>)`` shifts the tracer's spans onto
that clock by the offset between its spans and their matched ranges.

``chrome_trace()`` exports the standard Chrome ``trace_event`` JSON
(load in chrome://tracing or Perfetto): spans become ``ph="X"`` complete
events on one row per ``tid``, points become ``ph="i"`` instants — the
dispatcher's queue→form→launch→flight rows make ``max_in_flight`` overlap
visually auditable. :func:`validate_chrome_trace` is the schema check CI
runs on the emitted file.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

#: the prefix of the program's profiler ranges
RANGE_PREFIX = "bsp:"


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
        #: idle CUDA timing events, reused; and the spans whose two events
        #: have not been read yet: (args, start event, end event)
        self._events: List = []
        self._pending: List[tuple] = []

    def next_tid(self, prefix: str) -> str:
        """A fresh timeline-lane id (``sort0``, ``batch3``, ...)."""
        return f"{prefix}{next(self._ids)}"

    def now(self) -> float:
        """The tracer's clock — drivers capture launch timestamps with it."""
        return self._clock()

    def mark(self, device: Optional[torch.device]):
        """A timing event recorded now on ``device``'s current stream, or
        None off CUDA. Recording enqueues; it does not wait."""
        if device is None or device.type != "cuda":
            return None
        ev = self._events.pop() if self._events else torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev

    def resolve(self) -> int:
        """Fill ``stream_ms`` of every span whose two events have completed.

        Called right after a host sync the driver makes anyway; an event
        still pending (``query()`` is false, which never waits) is left for
        the next call. Returns how many spans remain pending.
        """
        waiting = []
        for args, a, b in self._pending:
            if a.query() and b.query():
                args["stream_ms"] = a.elapsed_time(b)
                self._events += (a, b)
            else:
                waiting.append((args, a, b))
        self._pending = waiting
        return len(waiting)

    def add_span(
        self,
        name: str,
        t_start: float,
        *,
        t_end: Optional[float] = None,
        cat: str = "sort",
        tid: str = "main",
        stream: Optional[tuple] = None,
        **args,
    ) -> Dict:
        """Record an interval whose start was captured earlier with :meth:`now`.

        The async drivers need this form: a route span opens at launch (in
        ``InFlightSort.__init__``) and closes at the overflow host-sync (in
        ``wait``) — two different stack frames, so the :meth:`span` context
        manager cannot bracket it. ``t_end`` pins the close to the sync
        itself, excluding any host-side count reads done after it.
        ``stream`` (two events of :meth:`mark`) gives the span a
        ``stream_ms`` arg, filled by :meth:`resolve` (null off CUDA).
        Returns the recorded span.
        """
        end = self._clock() if t_end is None else t_end
        rec = {
            "name": name,
            "cat": cat,
            "tid": tid,
            "t0": t_start,
            "dur": max(0.0, end - t_start),
            "args": _jsonable(args),
        }
        if stream is not None:
            rec["args"]["stream_ms"] = None
            if stream[0] is not None and stream[1] is not None:
                self._pending.append((rec["args"], stream[0], stream[1]))
        self.spans.append(rec)
        return rec

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
    def profiler_offset_us(self, trace_events) -> float:
        """Microseconds to add to ``perf_counter`` seconds × 1e6 to land on
        a ``torch.profiler`` Chrome trace's clock.

        Each sort span is matched to its ``bsp:`` range (a stage to
        ``bsp:<name>``, ``prepare`` to ``bsp:prepare``, ``route`` to
        ``bsp:rung.<tier>``, which opens at the same launch): the k-th span
        of a name to the k-th range of that name. Names the trace holds
        another number of are left out, so the tracer should have been
        attached over the profiled stretch. The offset is the median of
        the matched starts' differences. Raises ``ValueError`` when nothing
        matches.
        """
        events = trace_events.get("traceEvents", []) if isinstance(trace_events, dict) else trace_events
        ranges: Dict[str, List[float]] = defaultdict(list)
        for e in events:
            name = e.get("name", "")
            if (e.get("ph") == "X" and name.startswith(RANGE_PREFIX)
                    and str(e.get("cat", "")).lower() == "user_annotation"):
                ranges[name].append(float(e["ts"]))
        starts: Dict[str, List[float]] = defaultdict(list)
        for s in self.spans:
            name = range_name(s)
            if name is not None:
                starts[name].append(s["t0"])
        diffs = []
        for name, ts in starts.items():
            got = sorted(ranges.get(name, ()))
            if len(got) == len(ts):
                diffs += [r - 1e6 * t for r, t in zip(got, sorted(ts))]
        if not diffs:
            raise ValueError("no span of the tracer matches a bsp: range of the trace")
        return float(np.median(diffs))

    def chrome_trace(self, align_to=None) -> Dict:
        """Standard Chrome ``trace_event`` JSON (ts/dur in microseconds).

        ``align_to`` (a ``torch.profiler`` Chrome trace, or its event list)
        puts the events on that trace's clock (:meth:`profiler_offset_us`),
        so they can be shown beside its kernels; without it ``ts`` counts
        from the tracer's creation.
        """
        off = None if align_to is None else self.profiler_offset_us(align_to)

        def ts(t: float) -> float:
            return (t - self.t0) * 1e6 if off is None else t * 1e6 + off

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
                    "ts": ts(s["t0"]),
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
                    "ts": ts(p["t0"]),
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


def range_name(span: Dict) -> Optional[str]:
    """The ``bsp:`` profiler range a sort span is opened with, or None."""
    if span.get("cat") == "stage":
        return RANGE_PREFIX + span["name"]
    if span.get("name") == "prepare":
        return RANGE_PREFIX + "prepare"
    if span.get("name") == "route" and "tier" in span.get("args", {}):
        return f"{RANGE_PREFIX}rung.{span['args']['tier']}"
    return None


# ------------------------------------------------------ the stage hook
class _Lane:
    """Where the stages entered now record: the tracer, the sort's lane,
    the driver span they sit under (``prepare`` or ``route``), the rung,
    and the device whose stream the events time."""

    __slots__ = ("tracer", "tid", "parent", "rung", "tier", "device")

    def __init__(self, tracer, tid, parent, rung, tier, device) -> None:
        self.tracer, self.tid, self.parent = tracer, tid, parent
        self.rung, self.tier, self.device = rung, tier, device


_LANE: contextvars.ContextVar[Optional[_Lane]] = contextvars.ContextVar("repro_torch_obs_lane", default=None)


def _profiling() -> bool:
    return torch.autograd._profiler_enabled()


class _Null:
    """The untraced, unprofiled path's one shared context: enters nothing
    and is false, so a stage skips what only a span needs."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False


_NULL = _Null()


class _Stage:
    """One stage entered under a profiler, a tracer, or both."""

    __slots__ = ("_lane", "_name", "args", "_range", "_t0", "_ev0")

    def __init__(self, lane: Optional[_Lane], name: str, profiling: bool, counts: Dict) -> None:
        self._lane, self._name, self.args = lane, name, counts
        self._range = torch.profiler.record_function(RANGE_PREFIX + name) if profiling else None
        self._t0, self._ev0 = 0.0, None

    def __bool__(self) -> bool:
        """True when a span is recorded: late counts go into ``args``."""
        return self._lane is not None

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        lane = self._lane
        if lane is not None:
            self._t0 = lane.tracer.now()
            self._ev0 = lane.tracer.mark(lane.device)
        return self

    def __exit__(self, *exc) -> bool:
        lane = self._lane
        if lane is not None and exc[0] is None:
            tr = lane.tracer
            ev1 = tr.mark(lane.device)
            t1 = tr.now()
            tr.add_span(self._name, self._t0, t_end=t1, cat="stage", tid=lane.tid, stream=(self._ev0, ev1),
                        parent=lane.parent, rung=lane.rung, tier=lane.tier, host_ms=(t1 - self._t0) * 1e3,
                        **self.args)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def stage(name: str, **counts):
    """The context a stage of the sort runs in (see the module doc).

    ``counts`` are the stage's work counts known from shapes; a count
    known only inside the block goes into the context's ``args`` when the
    context is true (a span is being recorded).
    """
    lane = _LANE.get()
    profiling = _profiling()
    if lane is None and not profiling:
        return _NULL
    return _Stage(lane, name, profiling, counts)


class _Scope:
    """A driver's lane: makes its tracer the active one for the stages
    entered inside, and opens its ``bsp:`` range under a profiler."""

    __slots__ = ("_lane", "_range", "_token")

    def __init__(self, lane: Optional[_Lane], name: str, profiling: bool) -> None:
        self._lane = lane
        self._range = torch.profiler.record_function(RANGE_PREFIX + name) if profiling else None
        self._token = None

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        if self._lane is not None:
            self._token = _LANE.set(self._lane)
        return self

    def __exit__(self, *exc) -> bool:
        if self._token is not None:
            _LANE.reset(self._token)
            self._token = None
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def lane(tracer, tid: Optional[str], parent: str, *, rung: Optional[int] = None, tier: Optional[str] = None,
         device=None):
    """The context a driver enters around its prepare stage
    (``parent="prepare"``) or a rung's launch (``parent="route"``, with the
    rung and its tier): inside it the stages record into ``tracer`` on lane
    ``tid``, and under a profiler it is the range ``bsp:prepare`` or
    ``bsp:rung.<tier>``. With no tracer and no profiler it is the shared
    null context.
    """
    profiling = _profiling()
    if tracer is None and not profiling:
        return _NULL
    name = parent if parent != "route" else f"rung.{tier}"
    active = None
    if tracer is not None:
        device = None if device is None else torch.device(device)
        active = _Lane(tracer, tid or "main", parent, rung, tier, device)
    return _Scope(active, name, profiling)
