"""BSP cost model — the paper's analytical machinery (§1.1, Props 5.1/5.3).

A BSP machine is ``(p, L, g)``: p processors, L = synchronization latency in
basic-op units (or seconds here), g = per-word routing cost. A superstep with
local work x and h-relation h costs ``max(L, x + g·h)``.

The model below prices each phase of SORT_DET_BSP / SORT_IRAN_BSP exactly as
the paper's analysis does (charging n·lg n for sorting n keys, n·lg q for
q-way merging, ⌈lg n⌉ per binary search), and produces the paper's headline
quantities:

* ``pi``  (π)  = p·C_A / C_A*      — computational efficiency ratio,
* ``mu``  (μ)  = p·M_A / C_A*      — communication impact ratio,
* speedup = p/(π+μ), parallel efficiency = 1/(π+μ).

``predict`` returns both op counts and seconds given a time per
comparison, the paper's predicted-vs-observed methodology (its §6 uses the
T3D constants below). Host arithmetic over the port's ``SortConfig``; the
JAX package's model, unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from .types import SortConfig, log2


#: Cray T3D BSP parameters from the paper (§6): p -> (L seconds, g sec/word).
CRAY_T3D = {
    16: (130e-6, 0.21e-6),
    32: (175e-6, 0.26e-6),
    64: (364e-6, 0.28e-6),
    128: (762e-6, 0.34e-6),
}


@dataclasses.dataclass(frozen=True)
class BSPMachine:
    p: int
    L: float  # seconds per synchronization
    g: float  # seconds per 32-bit word of h-relation
    t_comp: float = 1.0 / 7e6  # seconds per comparison (paper: 7 cmp/us on T3D)

    def superstep(self, work_ops: float, h_words: float) -> float:
        return max(self.L, work_ops * self.t_comp + self.g * h_words)


@dataclasses.dataclass
class PhaseCost:
    comp_ops: float = 0.0  # comparisons / basic ops (max over procs)
    h_words: float = 0.0  # max words sent or received by any proc
    supersteps: int = 0

    def seconds(self, m: BSPMachine) -> float:
        base = self.comp_ops * m.t_comp + m.g * self.h_words
        return max(base, m.L * max(self.supersteps, 1)) if (
            self.h_words or self.supersteps
        ) else base


def _lg(x: float) -> float:
    return log2(x)


def phase_costs_det(cfg: SortConfig) -> Dict[str, PhaseCost]:
    """Per-phase BSP cost of SORT_DET_BSP (Prop. 5.1), phases Ph1-Ph7."""
    p, np_, s = cfg.p, cfg.n_per_proc, cfg.s
    n_max = cfg.n_max
    lgp = _lg(p)
    costs = {
        "Init": PhaseCost(comp_ops=p),
        # Ph2 — local sort of n/p keys: (n/p)·lg(n/p)
        "SeqSort": PhaseCost(comp_ops=np_ * _lg(np_)),
        # Ph3 — sample selection O(s) + parallel bitonic sample-sort:
        # 2s(lg^2 p + lg p)/2 comp, (lg^2 p + lg p)/2 supersteps of g·s each.
        "Sampling": PhaseCost(
            comp_ops=s + s * (lgp**2 + lgp),
            h_words=s * (lgp**2 + lgp) / 2.0,
            supersteps=int((lgp**2 + lgp) / 2) + 1,
        ),
        # Ph4 — splitter broadcast + partition (binary search of p-1 splitters
        # into the local run) + p parallel prefixes.
        "Prefix": PhaseCost(
            comp_ops=p * _lg(np_) + 2 * p * lgp,
            h_words=2.0 * p,
            supersteps=2 + int(lgp),
        ),
        # Ph5 — the single key-routing h-relation: h = n_max.
        "Routing": PhaseCost(comp_ops=0.0, h_words=float(n_max), supersteps=1),
        # Ph6 — p-way merge of n_max keys: n_max·lg p.
        "Merging": PhaseCost(comp_ops=n_max * lgp),
        "Termination": PhaseCost(comp_ops=1.0),
    }
    return costs


def phase_costs_iran(cfg: SortConfig) -> Dict[str, PhaseCost]:
    """Per-phase BSP cost of SORT_IRAN_BSP (Prop. 5.3)."""
    p, np_, s = cfg.p, cfg.n_per_proc, cfg.s
    n_max = cfg.n_max
    lgp = _lg(p)
    costs = phase_costs_det(cfg)
    # Randomized sampling: select s random keys O(s); parallel bitonic sort of
    # (p, s) sample: 2·s·lg n-ish terms per Prop 5.3: 2 ω² lg n lg² p comp.
    costs["Sampling"] = PhaseCost(
        comp_ops=s + s * (lgp**2 + lgp),
        h_words=s * (lgp**2 + lgp) / 2.0,
        supersteps=int((lgp**2 + lgp) / 2) + 1,
    )
    costs["Merging"] = PhaseCost(comp_ops=n_max * lgp)
    return costs


def phase_costs_ran(cfg: SortConfig) -> Dict[str, PhaseCost]:
    """Per-phase BSP cost of classic SORT_RAN_BSP (Prop. 5.2).

    Differences from IRAN: sample is shipped to processor 0 and sorted there
    (s·p·lg(s·p) on one proc), partition is a binary search of *keys into
    splitters* ((n/p)(lg p + 1)), and Ph6 is a full local sort (not merge).
    """
    p, np_, s = cfg.p, cfg.n_per_proc, cfg.s
    n_max = cfg.n_max
    costs = {
        "Init": PhaseCost(comp_ops=p),
        "SeqSort": PhaseCost(comp_ops=0.0),  # no up-front local sort
        "Sampling": PhaseCost(
            comp_ops=s * p * _lg(s * p) + p,
            h_words=float(s * p),
            supersteps=2,
        ),
        "Prefix": PhaseCost(comp_ops=np_ * (_lg(p) + 1), h_words=2.0 * p, supersteps=2),
        "Routing": PhaseCost(h_words=float(n_max), supersteps=1),
        "Merging": PhaseCost(comp_ops=n_max * _lg(max(n_max, 2))),  # local sort
        "Termination": PhaseCost(comp_ops=1.0),
    }
    return costs


_PHASES = {"det": phase_costs_det, "iran": phase_costs_iran, "ran": phase_costs_ran}


@dataclasses.dataclass
class Prediction:
    seconds_total: float
    seconds_comp: float
    seconds_comm: float
    pi: float
    mu: float
    efficiency: float
    speedup: float
    per_phase: Dict[str, float]


def predict(cfg: SortConfig, machine: BSPMachine) -> Prediction:
    """Price a sort under the BSP model; compare against sequential n·lg n."""
    costs = _PHASES[cfg.algorithm](cfg)
    per_phase = {k: c.seconds(machine) for k, c in costs.items()}
    comp = sum(c.comp_ops for c in costs.values()) * machine.t_comp
    comm = sum(
        max(machine.g * c.h_words, machine.L * c.supersteps)
        for c in costs.values()
        if c.h_words or c.supersteps
    )
    seq = cfg.n * _lg(cfg.n) * machine.t_comp  # best sequential comparison sort
    pi = cfg.p * comp / seq
    mu = cfg.p * comm / seq
    eff = 1.0 / (pi + mu)
    return Prediction(
        seconds_total=comp + comm,
        seconds_comp=comp,
        seconds_comm=comm,
        pi=pi,
        mu=mu,
        efficiency=eff,
        speedup=cfg.p * eff,
        per_phase=per_phase,
    )


def theoretical_max_imbalance(cfg: SortConfig) -> float:
    """Paper §6.4: det ≈ 1/⌈lg lg n⌉, ran ≈ 1/sqrt(lg n) (≈20% at n=2^23)."""
    if cfg.algorithm == "det":
        return 1.0 / max(1, math.ceil(log2(log2(cfg.n))))
    return 1.0 / math.sqrt(log2(cfg.n))
