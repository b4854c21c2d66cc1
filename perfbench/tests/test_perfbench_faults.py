"""A run with the timed path broken underneath comes out not correct, and
the control fails where the program passes. Every run here skips the
harness's look for a card and drives the rest of a run on the CPU, at a
cut size (p = 16, n = 4096)."""
from __future__ import annotations

import pytest
import torch

from perfbench import control, manifest, reference, run
from repro_torch import core
from repro_torch.core import merge, primitives

SIZES = {"p": 16, "n": 4096}
CELLS = [w["name"] for w in manifest.load()["workloads"]]
KV = [w["name"] for w in manifest.load()["workloads"]
      if manifest.config(manifest.load(), w["config"])["spec"]["payloads"]]


def run_once(cell, seed=2**31 + 11):
    return run.run_cell(cell, seed, 0.05, False, device="cpu", sizes=SIZES)


def unchanged(monkeypatch):
    """The sort returns its input as it came."""
    def sort(x, cfg, *, values=(), stats=None, device=None, **kw):
        p, n_p = x.shape
        res = core.SortResult(buf=x, count=torch.full((p,), n_p, dtype=torch.int32), overflow=torch.tensor(False))
        return res, list(values), stats
    monkeypatch.setattr(core, "bsp_sort_safe", sort)


def half_left_out(monkeypatch):
    """Half the processors' answers dropped."""
    real = core.bsp_sort_safe

    def sort(*args, **kw):
        res, vals, stats = real(*args, **kw)
        res.count = res.count.clone()
        res.count[res.count.numel() // 2:] = 0
        return res, vals, stats
    monkeypatch.setattr(core, "bsp_sort_safe", sort)


def no_exchange(monkeypatch):
    """Ph5's h-relation left out: every processor keeps its own buckets."""
    monkeypatch.setattr(primitives.LocalProcs, "all_to_all", lambda self, x: x.contiguous())


def key_altered(monkeypatch):
    """One key of the merged output changed where Ph6 produces it."""
    real = merge.merge_tree

    def tree(*args, **kw):
        runs, vals, counts = real(*args, **kw)
        runs = runs.clone()
        runs[0, 0] += 1
        return runs, vals, counts
    monkeypatch.setattr(merge, "merge_tree", tree)


def payload_moved(monkeypatch):
    """One processor's payloads moved one place off their keys in Ph6."""
    real = merge.merge_tree

    def tree(*args, **kw):
        runs, vals, counts = real(*args, **kw)
        vals = [v.clone() for v in vals]
        vals[0][0, : int(counts[0])] = torch.roll(vals[0][0, : int(counts[0])], 1)
        return runs, vals, counts
    monkeypatch.setattr(merge, "merge_tree", tree)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    r = run_once(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("fault", [unchanged, half_left_out, no_exchange, key_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run_once(cell)
    assert not r["correct"] and r["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("cell", KV)
def test_a_payload_off_its_key_is_not_correct(cell, monkeypatch):
    payload_moved(monkeypatch)
    r = run_once(cell)
    assert not r["correct"] and r["checks"]["payload_mismatches"]["value"] > 0
    assert r["checks"]["key_mismatches"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_where_the_program_passes(cell):
    """The reference at 16-bit key precision in the program's place, on
    three seeds: every input fails; the program's answers all pass."""
    rows = list(control.readings(cell, [1, 2, 2**31 + 1], True, ["int16"], device="cpu", sizes=SIZES))
    over = lambda r: any(r[k] > reference.LIMITS[k] for k in reference.LIMITS if k in r)  # noqa: E731
    assert rows and all(not over(r) for r in rows if r["side"] == "program")
    ctl = [r for r in rows if r["side"] == "control:int16"]
    assert len(ctl) == 3 * 4 and all(over(r) for r in ctl)
