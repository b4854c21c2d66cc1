"""The readers of the program's stage spans on synthetic span lists:
``ladder_waste_pct``, ``partition_host_ms``, ``exchange_ms`` and their
``.host_paced`` twins."""
from __future__ import annotations

import pytest

from perfbench import manifest
from perfbench.run import Context

READERS = ("ladder_waste_pct", "partition_host_ms", "exchange_ms")


def span(name, cat="sort", **args):
    return {"name": name, "cat": cat, "tid": "sort0", "t0": 0.0, "dur": 0.001, "args": args}


def rung(rung, tier, ok, route_ms, partition_ms, exchange_ms):
    stage = dict(parent="route", rung=rung, tier=tier)
    return [span("partition", "stage", host_ms=partition_ms, stream_ms=0.5, **stage),
            span("exchange", "stage", host_ms=0.1, stream_ms=exchange_ms, **stage),
            span("route", tier=tier, rung=rung, ok=ok, imbalance=1.0, stream_ms=route_ms)]


def call(*rungs):
    out = [span("local_sort", "stage", parent="prepare", rung=None, tier=None, host_ms=0.2, stream_ms=8.0),
           span("prepare", stream_ms=10.0)]
    for r in rungs:
        out += rung(*r)
    return out


def ctx(spans, traced_calls):
    return Context(calls=traced_calls, rung_attempts=0, profiled_calls=0, trace={}, traced_calls=traced_calls,
                   spans=spans)


LADDER = call((0, "whp", False, 5.0, 2.0, 1.0), (1, "whp2", False, 7.0, 3.0, 2.0), (2, "exact", True, 20.0, 4.0, 4.0))
CLEAN = call((0, "whp", True, 30.0, 1.5, 3.0)) + call((0, "whp", True, 34.0, 2.5, 5.0))


def read(name, c):
    return manifest.reader(name)(c)


def test_a_ladder_with_two_failed_rungs():
    c = ctx(LADDER, 1)
    assert read("ladder_waste_pct", c) == pytest.approx(100 * (5 + 7) / (10 + 5 + 7 + 20))
    assert read("partition_host_ms", c) == pytest.approx(2 + 3 + 4)
    assert read("exchange_ms", c) == pytest.approx(1 + 2 + 4)


def test_no_failed_rung_wastes_nothing():
    c = ctx(CLEAN, 2)
    assert read("ladder_waste_pct", c) == 0.0
    assert read("partition_host_ms", c) == pytest.approx((1.5 + 2.5) / 2)
    assert read("exchange_ms", c) == pytest.approx((3 + 5) / 2)


def test_a_program_without_stage_spans_reads_nothing():
    # the spans a program records without the stage hook: no stage, no stream time
    plain = [span("prepare"), span("route", tier="whp", rung=0, ok=False, imbalance=1.0),
             span("route", tier="whp2", rung=1, ok=True, imbalance=1.0)]
    for spans, calls in ((plain, 1), ([], 0), ([], 3)):
        for name in READERS:
            assert read(name, ctx(spans, calls)) is None, name


def test_stage_spans_off_the_card_give_no_stream_time():
    off = [dict(s, args=dict(s["args"], stream_ms=None)) for s in LADDER]
    c = ctx(off, 1)
    assert read("ladder_waste_pct", c) is None and read("exchange_ms", c) is None
    assert read("partition_host_ms", c) == pytest.approx(9.0)


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("spans,calls", [(LADDER, 1), (CLEAN, 2), ([], 0)], ids=["ladder", "clean", "none"])
def test_the_twin_reads_as_its_plain_name(name, spans, calls):
    assert read(name + ".host_paced", ctx(spans, calls)) == read(name, ctx(spans, calls))


def test_the_manifest_lists_each_reader_and_twin_in_its_cells():
    per_layer = {m["name"]: m for m in manifest.load()["per_layer"]}
    for name in READERS:
        assert per_layer[name]["workloads"] == ["det-keys-u-2e27"]
        assert per_layer[name + ".host_paced"]["workloads"] == ["det-kv-u-2e25", "det-keys-zipf-2e23"]
        assert per_layer[name]["source"] == per_layer[name + ".host_paced"]["source"] == "program_span"
