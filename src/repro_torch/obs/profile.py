"""Fitted machine profile — estimate the paper's (g, L) from traced spans.

The BSP model charges a superstep ``w + g·h + L``: local work, per-word
communication gap, and barrier latency. The paper measures g and L with
dedicated microbenchmarks on the Cray T3D (§1.1, ``core/bsp.py`` carries
those constants); here we go the other way — *regress the machine out of a
traced run*. Every route span carries its measured wall time, its traced
h-relation size (words) and its superstep count, so over a run with varying
h the least-squares fit of

    wall_i  ≈  g · h_i  +  L · s_i

identifies an *effective* g (seconds per 32-bit word, including the local
routing work that scales with h — an upper bound on the wire gap) and an
effective L (per-superstep fixed cost: barrier + dispatch + the
h-independent work share). The per-span residual ``w_i = wall_i − g·h_i −
L·s_i`` is then the local-work estimate, making the cost report's
``pred_s = w + g·h + L·s`` decomposition exact in-sample while the *shares*
show whether a run was communication- or compute-dominated.

Interpretation guardrails:

* the fit needs h to vary across spans (different sizes/mixes/rungs);
  with < 2 samples or constant h it returns ``ok=False`` and NaNs;
* g and L are clamped at 0 for reporting — tiny negative values are
  regression noise, not negative latency;
* ``r2`` is the fit's in-sample explanatory power; low r2 means the run
  was dominated by h-independent variance (compile, host work).

The load-imbalance metric (max/mean received keys per proc, from the same
route spans) directly tests the paper's balance claim: for balanced inputs
it must stay within the whp bound ``1 + theoretical_max_imbalance(cfg)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class GLFit:
    """Least-squares (g, L) estimate over traced route spans."""

    g_s_per_word: float  # effective comm gap, seconds per 32-bit word
    l_s: float  # effective per-superstep fixed cost, seconds
    n_samples: int
    r2: float  # in-sample R^2 of wall ~ g*h + L*s
    ok: bool  # enough spread in h to identify g

    def predict_s(self, h_words: float, supersteps: float) -> float:
        return self.g_s_per_word * h_words + self.l_s * supersteps


def fit_gl(route_spans: Sequence[Dict]) -> GLFit:
    """Fit ``wall = g·h + L·s`` over route spans (see module docstring)."""
    rows = [
        (float(s["args"]["h_words"]), float(s["args"]["supersteps"]), float(s["dur"]))
        for s in route_spans
        if "h_words" in s.get("args", {}) and "supersteps" in s.get("args", {})
    ]
    if len(rows) < 2:
        return GLFit(float("nan"), float("nan"), len(rows), float("nan"), False)
    a = np.array([[h, ss] for h, ss, _ in rows], np.float64)
    b = np.array([w for _, _, w in rows], np.float64)
    if np.ptp(a[:, 0]) <= 0:  # constant h: g unidentifiable
        return GLFit(float("nan"), float("nan"), len(rows), float("nan"), False)
    sol, *_ = np.linalg.lstsq(a, b, rcond=None)
    pred = a @ sol
    ss_res = float(np.sum((b - pred) ** 2))
    ss_tot = float(np.sum((b - b.mean()) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    g, l = (max(0.0, float(v)) for v in sol)
    return GLFit(g, l, len(rows), r2, True)


def imbalance_of(counts: np.ndarray) -> float:
    """max/mean received keys per proc — the paper's balance metric."""
    counts = np.asarray(counts, np.float64)
    mean = counts.mean()
    if mean <= 0:
        return 1.0
    return float(counts.max() / mean)


def cost_report(tracer) -> Dict:
    """Per-run BSP cost report: fitted (g, L) + per-superstep rows.

    Each route span becomes one row comparing its measured wall against the
    fitted ``w + g·h + L·s`` (w = residual local-work share, clamped at 0);
    the header carries the fit and the worst load imbalance. JSON-able.
    """
    fit = fit_gl(tracer.route_spans())
    rows: List[Dict] = []
    worst_imb: Optional[float] = None
    for s in tracer.route_spans():
        args = s["args"]
        h = float(args.get("h_words", float("nan")))
        ss = float(args.get("supersteps", float("nan")))
        measured = float(s["dur"])
        comm = fit.predict_s(h, ss) if fit.ok else float("nan")
        w = max(0.0, measured - comm) if fit.ok else float("nan")
        imb = args.get("imbalance")
        if imb is not None:
            worst_imb = imb if worst_imb is None else max(worst_imb, imb)
        rows.append(
            {
                "tid": s["tid"],
                "tier": args.get("tier"),
                "rung": args.get("rung"),
                "h_words": h,
                "supersteps": ss,
                "measured_s": round(measured, 6),
                "pred_comm_s": round(comm, 6) if not math.isnan(comm) else None,
                "w_resid_s": round(w, 6) if not math.isnan(w) else None,
                "imbalance": imb,
                "recv_max": args.get("recv_max"),
                "recv_mean": args.get("recv_mean"),
            }
        )
    return {
        "fit": {
            "g_s_per_word": fit.g_s_per_word,
            "l_s": fit.l_s,
            "n_samples": fit.n_samples,
            "r2": fit.r2,
            "ok": fit.ok,
        },
        "max_imbalance": worst_imb,
        "supersteps": rows,
    }
