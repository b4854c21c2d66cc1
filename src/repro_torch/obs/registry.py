"""Process-wide metrics registry — counters, gauges and histograms.

One flat namespace replaces the telemetry that used to live as ad-hoc
attributes scattered over four modules (``TierStats`` dicts, the
dispatcher's ``launches``/``in_flight_peak``, the planner's
``radix_plans``/``promotions``, the serve engine's refill/prefetch
counters). Every metric is keyed by a dotted name plus sorted ``k=v``
labels::

    dispatch.launches{svc=svc0}        counter
    service.request_latency_s{svc=svc0} histogram
    sort.tier_attempts{tier=whp}        counter

Naming conventions (the JAX package's, so both packages' snapshots read
alike):

* names are ``<subsystem>.<noun>``, lower_snake, units suffixed
  (``_s`` seconds, ``_bytes``, bare = count);
* instance-scoped metrics (several services in one process) carry an
  ``svc=``/``planner=``/``engine=`` label from :func:`repro_torch.obs.next_instance`,
  so per-instance attribute views stay exact while ``snapshot()`` sees the
  whole process;
* per-category tallies (tier names, pow2 buckets, flush triggers) are one
  counter per label value, re-assembled into the legacy dicts by the
  owners' thin property views.

The registry is plain Python over the GIL — metric updates are dict lookups
plus an integer add, cheap enough for per-request paths. ``snapshot()``
returns a flat JSON-able dict; ``reset()`` zeroes values but keeps
registrations (an owner's cached handle stays valid).
"""
from __future__ import annotations

import collections
from typing import Deque, Dict, Iterable, List, Tuple

import numpy as np


class Counter:
    """Monotonic counter. ``value`` is a plain attribute — reads are free."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def _reset(self) -> None:
        self.value = 0

    def _snap(self):
        return self.value


class Gauge:
    """Last-written value; ``set_max`` keeps a high-water mark."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def set_max(self, v) -> None:
        if v > self.value:
            self.value = v

    def _reset(self) -> None:
        self.value = 0

    def _snap(self):
        return self.value


class Histogram:
    """Bounded-window histogram: lifetime count/total + recent raw values.

    The window (``deque(maxlen=...)``) bounds memory for long-lived serving
    processes, exactly like the latency deque it replaces; percentiles are
    computed over the window with ``np.quantile`` and memoized per
    observation count, so a soak loop polling telemetry between completions
    never rescans the window.
    """

    __slots__ = ("values", "count", "total", "_memo")

    def __init__(self, maxlen: int = 1 << 16) -> None:
        self.values: Deque[float] = collections.deque(maxlen=maxlen)
        self.count = 0  # lifetime observations (window may have dropped some)
        self.total = 0.0
        self._memo: Tuple[int, Dict] = (-1, {})

    def observe(self, v: float) -> None:
        self.values.append(float(v))
        self.count += 1
        self.total += float(v)

    def quantiles(self, qs: Iterable[float]) -> List[float]:
        arr = np.fromiter(self.values, np.float64)
        if not arr.size:
            return [float("nan") for _ in qs]
        return [float(x) for x in np.quantile(arr, list(qs))]

    def summary(self) -> Dict[str, float]:
        """{count, mean, p50, p99} over the window, memoized by count."""
        done, row = self._memo
        if done == self.count:
            return row
        row = {"count": self.count}
        if self.values:
            arr = np.fromiter(self.values, np.float64)
            p50, p99 = np.quantile(arr, [0.5, 0.99])
            row |= {
                "mean": float(arr.mean()),
                "p50": float(p50),
                "p99": float(p99),
            }
        self._memo = (self.count, row)
        return row

    def _reset(self) -> None:
        self.values.clear()
        self.count = 0
        self.total = 0.0
        self._memo = (-1, {})

    def _snap(self):
        return {k: round(v, 6) if isinstance(v, float) else v
                for k, v in self.summary().items()}


def metric_key(name: str, labels: Dict[str, object]) -> str:
    """Canonical flat key: ``name{k=v,...}`` with labels sorted by key."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class MetricsRegistry:
    """Labeled counters/gauges/histograms with one snapshot()/reset().

    ``counter``/``gauge``/``histogram`` get-or-create (a kind clash on the
    same key raises — one name means one thing); ``collect`` re-assembles
    the per-label-value tallies the legacy dict attributes exposed.
    """

    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        #: key -> (name, labels) for collect()
        self._meta: Dict[str, Tuple[str, Dict[str, object]]] = {}

    def _get(self, kind, name: str, labels: Dict, **kw):
        key = metric_key(name, labels)
        m = self._metrics.get(key)
        if m is None:
            m = self._metrics[key] = kind(**kw)
            self._meta[key] = (name, dict(labels))
        elif type(m) is not kind:
            raise TypeError(
                f"metric {key!r} already registered as {type(m).__name__}, "
                f"not {kind.__name__}"
            )
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, maxlen: int = 1 << 16, **labels) -> Histogram:
        return self._get(Histogram, name, labels, maxlen=maxlen)

    def collect(self, name: str, **fixed) -> List[Tuple[Dict[str, object], object]]:
        """Every metric named ``name`` whose labels include ``fixed``.

        Returns ``[(labels, metric), ...]`` — the owners' thin dict views
        (per-tier attempts, per-bucket batch counts) are one comprehension
        over this.
        """
        out = []
        for key, (n, labels) in self._meta.items():
            if n != name:
                continue
            if all(labels.get(k) == v for k, v in fixed.items()):
                out.append((labels, self._metrics[key]))
        return out

    def snapshot(self) -> Dict[str, object]:
        """Flat JSON-able dict of every metric (histograms as summaries)."""
        return {key: m._snap() for key, m in sorted(self._metrics.items())}

    def reset(self) -> None:
        """Zero every metric; registrations (and cached handles) survive."""
        for m in self._metrics.values():
            m._reset()
