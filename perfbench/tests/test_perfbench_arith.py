"""The percentile, rate, roofline and trace arithmetic on synthetic records."""
from __future__ import annotations

import math

import pytest

from perfbench import devtrace, manifest, measure, roofline
from perfbench.run import Context


def test_keys_per_s_over_the_whole_window():
    recs = [(10.0, 10.5, 100), (10.6, 11.0, 100), (11.0, 12.0, 200)]
    assert measure.keys_per_s(recs) == pytest.approx(400 / 2.0)


def test_nearest_rank_percentile():
    vals = list(range(1, 201))  # 200 calls: 10 lie beyond the 95th
    assert measure.percentile(vals, 95) == 190
    assert measure.percentile([5.0], 95) == 5.0
    assert measure.percentile([3, 1, 2, 4], 50) == 2
    recs = [(0.0, v / 1e3, 1) for v in vals]
    assert measure.sort_p95_ms(recs) == pytest.approx(190.0)


def test_end_to_end_names_and_units_match_the_manifest():
    e2e = measure.end_to_end([(0.0, 1.0, 10), (1.0, 2.0, 10)], 2**31, 12.5)
    assert e2e["peak_mem_gib"] == (2.0, "GiB") and e2e["setup_s"] == (12.5, "s")
    for m in manifest.load()["end_to_end"]:
        assert e2e[m["name"]][1] == m["unit"]


def test_roofline_share():
    b = roofline.sort_stage_bytes(2**27, 4)  # 1 GiB in and out
    assert b == 2**30
    assert roofline.least_seconds(b) == pytest.approx(2**30 / 3.35e12)
    assert roofline.share_pct(b, 2 * 2**30 / 3.35e12) == pytest.approx(50.0)
    assert roofline.share_pct(b, 0.0) is None
    assert roofline.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert roofline.sort_stage_bytes(10, 4, 4) == 160


def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "pid": 1, "args": args}


def synthetic_trace():
    """A 100 µs window: a local_sort range launching two kernels, a merge
    range launching one, and the host reading a flag while the card idles."""
    return [
        _ev("user_annotation", "perfbench:window", 0, 100),
        _ev("user_annotation", "perfbench:local_sort", 5, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 6, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 8, 1, correlation=2),
        _ev("user_annotation", "perfbench:merge_tree", 20, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 21, 1, correlation=3),
        _ev("cpu_op", "aten::item", 40, 30),
        _ev("kernel", "k0", 0, 6),  # launched before the window's first range
        _ev("kernel", "k1", 10, 20, correlation=1),
        _ev("kernel", "k1", 30, 10, correlation=2),
        _ev("kernel", "k3", 35, 15, correlation=3),  # overlaps k1: counted once in busy
        _ev("gpu_memcpy", "Memcpy DtoH", 80, 5, correlation=99),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 6, "id": 1},
    ]


def test_trace_reduction():
    red = devtrace.reduce(synthetic_trace())
    assert red["window_s"] == pytest.approx(100e-6)
    assert red["busy_s"] == pytest.approx((6 + 50 - 10 + 5) * 1e-6)
    assert red["range_device_s"]["local_sort"] == pytest.approx(30e-6)
    assert red["range_device_s"]["merge_tree"] == pytest.approx(15e-6)
    assert red["n_device_ops"] == 5
    assert red["device_ops"][0] == ["k1", pytest.approx(30e-6)]
    gaps = dict((k, v) for k, v in red["idle_gaps"])
    # labelled halfway through: 6-10 while local_sort launches, 50-80 while
    # the host reads a flag, 85-100 in Python between host events
    assert gaps == {"local_sort/cudaLaunchKernel": pytest.approx(4e-6),
                    "harness/aten::item": pytest.approx(30e-6), "harness/python": pytest.approx(15e-6)}
    assert sum(gaps.values()) == pytest.approx(100e-6 - red["busy_s"])


def test_trace_without_a_window_is_refused():
    with pytest.raises(ValueError):
        devtrace.reduce([_ev("kernel", "k", 0, 1)])


def test_range_wrapper_restores_the_program():
    class Mod:
        @staticmethod
        def f(x):
            return x + 1

    plain = Mod.f
    with devtrace.ranges([(Mod, "f", "f")]):
        assert Mod.f(1) == 2 and Mod.f is not plain
    assert Mod.f is plain


def ctx(**kw):
    base = dict(calls=10, rung_attempts=13, profiled_calls=2, traced_calls=8,
                trace=devtrace.reduce(synthetic_trace()),
                spans=[{"name": "prepare", "dur": 0.002, "args": {}},
                       {"name": "route", "dur": 0.004, "args": {"ok": False, "imbalance": 9.0}},
                       {"name": "route", "dur": 0.004, "args": {"ok": True, "imbalance": 1.5}},
                       {"name": "route", "dur": 0.004, "args": {"ok": True, "imbalance": 1.1}}],
                stage_bytes={"local_sort": 3350, "merge_tree": 6700})
    base.update(kw)
    return Context(**base)


def test_readers_on_a_synthetic_context():
    c = ctx()
    read = lambda name: manifest.reader(name)(c)  # noqa: E731
    assert read("rungs_per_sort") == pytest.approx(1.3)
    assert read("recv_imbalance") == pytest.approx(1.3)
    assert read("prepare_ms") == pytest.approx(2.0 / 8)
    assert read("route_ms") == pytest.approx(12.0 / 8)
    # 2 calls x 3350 B = 2e-9 s at 3.35 TB/s, over 30 µs of local_sort kernels
    assert read("local_sort_roofline") == pytest.approx(100 * 2e-9 / 30e-6)
    assert read("merge_roofline") == pytest.approx(100 * 4e-9 / 15e-6)
    assert read("device_idle_pct") == pytest.approx(100 * (1 - 51 / 100))


@pytest.mark.parametrize("name", [m["name"] for m in manifest.load()["per_layer"] if "." in m["name"]])
def test_a_host_paced_reader_reads_as_its_base(name):
    assert manifest.reader(name)(ctx()) == manifest.reader(name.split(".")[0])(ctx())


def test_readers_find_nothing_and_say_so():
    empty = ctx(spans=[], traced_calls=0,
                trace={"busy_s": 0.0, "window_s": 1.0, "range_device_s": {}})
    for name in ("recv_imbalance", "prepare_ms", "route_ms", "local_sort_roofline",
                 "merge_roofline", "device_idle_pct"):
        assert manifest.reader(name)(empty) is None, name


def test_no_share_of_a_roofline_reads_zero():
    c = ctx(trace={"busy_s": 1.0, "window_s": 1.0, "range_device_s": {"local_sort": 1.0}})
    v = manifest.reader("local_sort_roofline")(c)
    assert v > 0 and not math.isnan(v)
