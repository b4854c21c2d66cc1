"""The BSP (p, L, g) cost model (``core/bsp.py``) against the JAX package.

Per-phase costs of SORT_DET_BSP, SORT_IRAN_BSP and SORT_RAN_BSP,
``predict`` on the Cray T3D machines and ``theoretical_max_imbalance``,
over a grid of configurations: every number within a relative 1e-12 of
the reference's. Then the paper's own checks (``tests/test_bsp_model.py``)
on the port's model.
"""
from __future__ import annotations

import dataclasses
import math

import pytest

from repro_torch.core import bsp
from repro_torch.core.types import SortConfig
from test_torch_harness import reference

GRID = [
    dict(p=p, n_per_proc=n // p, algorithm=algo, **extra)
    for p in (16, 32, 64, 128)
    for n in (1 << 20, 8 << 20)
    for algo in ("det", "iran", "ran")
    for extra in ({}, {"omega": 3.0, "capacity_factor": 1.5}, {"pair_capacity": "whp", "pad_align": 1})
]


def close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)


def machines():
    return {p: bsp.BSPMachine(p=p, L=L, g=g) for p, (L, g) in bsp.CRAY_T3D.items()}


@pytest.mark.parametrize("kw", GRID, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_costs_and_predictions_match_reference(kw):
    ref = reference()
    from repro.core import bsp as ref_bsp

    cfg, rcfg = SortConfig(**kw), ref.SortConfig(**kw)
    phase = {"det": bsp.phase_costs_det, "iran": bsp.phase_costs_iran, "ran": bsp.phase_costs_ran}
    rphase = {"det": ref_bsp.phase_costs_det, "iran": ref_bsp.phase_costs_iran, "ran": ref_bsp.phase_costs_ran}
    got, want = phase[cfg.algorithm](cfg), rphase[cfg.algorithm](rcfg)
    assert list(got) == list(want)
    m = machines()[cfg.p]
    rm = ref_bsp.BSPMachine(p=m.p, L=m.L, g=m.g)
    for name in want:
        g, w = dataclasses.asdict(got[name]), dataclasses.asdict(want[name])
        assert g.keys() == w.keys()
        for k in w:
            assert close(g[k], w[k]), (name, k, g[k], w[k])
        assert close(got[name].seconds(m), want[name].seconds(rm))
    pred, rpred = bsp.predict(cfg, m), ref_bsp.predict(rcfg, rm)
    for k in ("seconds_total", "seconds_comp", "seconds_comm", "pi", "mu", "efficiency", "speedup"):
        assert close(getattr(pred, k), getattr(rpred, k)), k
    assert pred.per_phase.keys() == rpred.per_phase.keys()
    assert all(close(pred.per_phase[k], rpred.per_phase[k]) for k in rpred.per_phase)
    assert close(bsp.theoretical_max_imbalance(cfg), ref_bsp.theoretical_max_imbalance(rcfg))
    assert close(m.superstep(1e6, 1e4), rm.superstep(1e6, 1e4))


def test_cray_t3d_constants_match_reference():
    reference()
    from repro.core import bsp as ref_bsp

    assert bsp.CRAY_T3D == ref_bsp.CRAY_T3D
    assert bsp.BSPMachine(p=16, L=1.0, g=1.0).t_comp == ref_bsp.BSPMachine(p=16, L=1.0, g=1.0).t_comp


@pytest.mark.parametrize("p", [16, 32, 64, 128])
def test_predictions_are_sane(p):
    pred = bsp.predict(SortConfig(p=p, n_per_proc=(8 << 20) // p, algorithm="det"), machines()[p])
    assert 0 < pred.efficiency <= 1.0
    assert pred.pi >= 1.0  # no sort beats the sequential comparison count
    assert pred.speedup <= p


def test_paper_efficiency_claim_8m_128():
    """§6.4: at n = 8M, p = 128 the det bound is about 66 %, and the
    randomized sort does at least about as well."""
    n = 8 << 20
    det = bsp.predict(SortConfig(p=128, n_per_proc=n // 128, algorithm="det"), machines()[128])
    assert 0.55 <= det.efficiency <= 0.85, det.efficiency
    ran = bsp.predict(SortConfig(p=128, n_per_proc=n // 128, algorithm="iran"), machines()[128])
    assert ran.efficiency >= det.efficiency * 0.9


def test_communication_efficiency_ordering():
    """The one-round sample sort routes far fewer words than [BSI]'s lg²p rounds."""
    p, n_p = 64, 1 << 17
    lgp = math.log2(p)
    bitonic_words = lgp * (lgp + 1) / 2 * n_p
    assert SortConfig(p=p, n_per_proc=n_p, algorithm="det").n_max < bitonic_words / 3


def test_seq_fraction_matches_paper():
    """§6.4: the sequential phases (sort + merge) are 80 %+ of the time."""
    pred = bsp.predict(SortConfig(p=64, n_per_proc=(32 << 20) // 64, algorithm="iran"), machines()[64])
    seq = pred.per_phase["SeqSort"] + pred.per_phase["Merging"]
    assert seq / pred.seconds_total >= 0.80


def test_nmax_formula_matches_lemma():
    cfg = SortConfig(p=8, n_per_proc=1024, algorithm="det", pad_align=1, capacity_factor=1.0)
    assert cfg.n_max == (cfg.s + cfg.p - 1) * cfg.segment_len  # the proof's exact bound
    assert cfg.n_max <= ((1 + 1 / cfg.r) * cfg.n_per_proc + cfg.r * cfg.p) * 1.3
