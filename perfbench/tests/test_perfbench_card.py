"""The harness on the card at a cut size: every cell correct, every
per-layer metric it lists read from a real device trace. Skips where no
card is found; the decision is made in the fixture, never at import.

    python -m pytest -m cuda perfbench/tests/test_perfbench_card.py
"""
from __future__ import annotations

import pytest

from perfbench import manifest, run

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
SIZES = {"p": 128, "n": 2**20}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_cut_cell_is_correct_on_the_card(card, cell):
    r = run.run_cell(cell, 2**31 + 21, 1.0, False, device=card, sizes=SIZES)
    assert r["correct"] and r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0
    assert set(r["metrics"]) == {m["name"] for m in manifest.end_to_end(BENCH, cell)}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cut_cell_reads_every_layer(card, cell):
    r = run.run_cell(cell, 2**31 + 22, 1.0, True, device=card, sizes=SIZES)
    assert r["correct"] and 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert set(r["metrics"]) == {m["name"] for m in manifest.per_layer(BENCH, cell)}
    for name, m in r["metrics"].items():
        if "_roofline" in name:
            assert 0 < m["value"] <= 100, (name, m)
    assert r["breakdown"]["device_ops"] and r["breakdown"]["idle_gaps"]
