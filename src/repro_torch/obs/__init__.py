"""repro_torch.obs — the BSP cost-model observatory of the port.

Host code, a copy of the JAX package's ``repro.obs`` (the port imports
nothing of that package): nothing here reads or writes a tensor (the
tracer only records CUDA timing events on the stream), so tracing cannot
change what the device computes. Three pieces:

* :class:`MetricsRegistry` (``registry.py``) — process-wide labeled
  counters/gauges/histograms with one ``snapshot()``/``reset()``;
  ``TierStats``, the capacity planner and the delta views count into it.
* :class:`Tracer` (``trace.py``) — superstep spans recorded at the sort
  drivers' launch/wait boundaries, and ``stage`` spans from inside the
  sort's phases through the ``trace.stage`` hook, exported as Chrome
  ``trace_event`` JSON, on the tracer's clock or a profiler trace's. Off
  by default; enable per run with ``SortConfig(obs=tracer)``.
* the fitted machine profile (``profile.py``) — least-squares (g, L) over
  the traced h sizes and measured superstep walls, plus the per-run cost
  report (``w + g·h + L`` predicted vs measured) and the load-imbalance
  metric that tests the paper's balance claim.

``metrics()`` returns the process-wide default registry;
``next_instance("planner")`` hands out stable instance labels so several
planners or views in one process keep distinct metric keys.
"""
from __future__ import annotations

import itertools

from .profile import GLFit, cost_report, fit_gl, imbalance_of
from .registry import Counter, Gauge, Histogram, MetricsRegistry, metric_key
from .trace import (
    Tracer,
    resolve_tracer,
    validate_chrome_trace,
    validate_spans,
)

#: the process-wide default registry (one per process, like the default
#: SortExecutor) — owners cache metric handles from it at construction.
REGISTRY = MetricsRegistry()


def metrics() -> MetricsRegistry:
    return REGISTRY


_instance_ids = itertools.count()


def next_instance(prefix: str) -> str:
    """A process-unique instance label (``svc0``, ``planner1``, ...)."""
    return f"{prefix}{next(_instance_ids)}"


__all__ = [
    "Counter",
    "Gauge",
    "GLFit",
    "Histogram",
    "MetricsRegistry",
    "REGISTRY",
    "Tracer",
    "cost_report",
    "fit_gl",
    "imbalance_of",
    "metric_key",
    "metrics",
    "next_instance",
    "resolve_tracer",
    "validate_chrome_trace",
    "validate_spans",
]
