"""BENCHMARK.json against the benchmark's contract, and every file it names."""
from __future__ import annotations

import json
import re

import pytest

from perfbench import manifest

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert manifest.MANIFEST.stat().st_size <= 64 * 1024
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)


def test_a_full_check_of_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_unique():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    assert len(set(c["name"] for c in BENCH["configs"])) == len(BENCH["configs"])
    assert len(set(CELLS)) == len(CELLS)
    assert len(set(m["name"] for m in METRICS)) == len(METRICS)
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in [w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]] + [
        c["source"] for c in BENCH["configs"]
    ] + [m["layer"] for m in BENCH["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file_resolves(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["file"].startswith("perfbench/configs/")
    spec = manifest.config(BENCH, conf["name"])["spec"]
    assert spec["name"] == conf["name"]
    assert manifest.entry(spec["entry"]).Cell
    assert conf["reduced"] == []
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4)
    manifest.config(BENCH, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    assert traffic["n"] > 0 and set(traffic) == {"keys", "n"}
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    e2e = [m["name"] for m in manifest.end_to_end(BENCH, cell["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert manifest.per_layer(BENCH, cell["name"])


def test_pairs_of_configuration_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    assert set(metric.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_reader_resolves(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert callable(manifest.reader(metric["name"]))
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    # every listed cell reports the end-to-end metric this one moves
    for cell in metric.get("workloads", CELLS):
        assert manifest.applies(moved, cell), (metric["name"], cell)


def test_setup_bound():
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        manifest.workload(BENCH, "no-such-cell")
    with pytest.raises(KeyError):
        manifest.reader("no_such_metric")


def test_manifest_is_plain_json():
    json.dumps(BENCH)
