"""``repro_torch.obs`` and the drivers' tracing, against the JAX package.

The registry, the histogram, the tracer's span schema and Chrome trace,
the (g, L) fit and the cost report carry the invariants of the JAX
package's ``tests/test_obs.py``, held against ``repro.obs`` on the same
calls and span lists. Tracing changes no result: the ``obs`` field is
invisible to equality, hash and ``prepare_key``, a traced re-run builds no
new executor entry, and traced outputs equal untraced ones byte for byte,
for the sort and the segmented sort. The route spans' arguments (tier,
rung, ok, h_words, supersteps, recv_max, recv) and the distribution points
equal the reference's on det runs. Tolerance: exact, except the fit and
the cost report (rel 1e-12); timing fields are not compared.

The stage spans, which the reference cannot record (its stages run under
jit): one set a rung in launch order, on the sort's lane, inside their
driver span; K1's tiles and the rank merges inside ``local_sort``; no
clock, event or range on the untraced path; a ``bsp:`` range for every
span under the profiler, and the spans aligned onto its clock; the
distribution point searched on the device, copying only the boundaries;
and on the card, stream times within their host intervals.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import (
    SortConfig,
    SortExecutor,
    TierStats,
    bsp_sort_safe,
    config_from_reference,
    datagen,
    gathered_output,
    pack_segments,
    segmented_sort_safe,
    theoretical_max_imbalance,
)
from test_torch_harness import adversarial, config_fields, reference

P, N_P = 8, 512


def ref_obs():
    reference()
    import repro.obs

    return repro.obs


def registry_calls(mod):
    """The same registry calls on either package's registry class."""
    reg = mod.MetricsRegistry()
    c = reg.counter("sort.retries")
    c.inc()
    c.inc(2)
    g = reg.gauge("dispatch.in_flight_peak", svc="svc9")
    g.set(2)
    g.set_max(5)
    g.set_max(1)  # set_max never lowers
    h = reg.histogram("service.request_latency_s")
    for v in np.random.default_rng(7).exponential(0.01, 300):
        h.observe(float(v))
    reg.counter("sort.tier_attempts", tier="whp").inc()
    reg.counter("sort.tier_attempts", tier="exact").inc(4)
    return reg, c, g, h


# ----------------------------------------------------------- registry
def test_registry_snapshot_matches_reference_and_resets():
    reg, c, g, h = registry_calls(obs)
    rreg = registry_calls(ref_obs())[0]
    assert reg.snapshot() == rreg.snapshot()
    assert c.value == 3 and g.value == 5 and h.count == 300
    reg.reset()
    assert c.value == 0 and g.value == 0 and h.count == 0
    assert reg.counter("sort.retries") is c  # registrations survive reset


def test_registry_labels_collect_and_kind_clash():
    reg = registry_calls(obs)[0]
    got = {labels["tier"]: m.value for labels, m in reg.collect("sort.tier_attempts")}
    assert got == {"whp": 1, "exact": 4}
    assert obs.metric_key("a.b", {"z": 1, "a": 2}) == ref_obs().metric_key("a.b", {"z": 1, "a": 2}) == "a.b{a=2,z=1}"
    with pytest.raises(TypeError):
        reg.gauge("sort.tier_attempts", tier="whp")


def test_histogram_quantiles_match_numpy_and_reference():
    xs = np.random.default_rng(7).exponential(0.01, 500)
    h, rh = obs.Histogram(), ref_obs().Histogram()
    for v in xs:
        h.observe(float(v))
        rh.observe(float(v))
    s = h.summary()
    assert s == rh.summary()
    assert s["count"] == 500
    assert s["mean"] == pytest.approx(xs.mean(), rel=1e-12)
    assert s["p50"] == float(np.quantile(xs, 0.5)) and s["p99"] == float(np.quantile(xs, 0.99))
    assert h.quantiles([0.1, 0.9]) == rh.quantiles([0.1, 0.9])


def test_next_instance_labels_are_fresh():
    a, b = obs.next_instance("planner"), obs.next_instance("planner")
    assert a != b and a.startswith("planner") and obs.metrics() is obs.REGISTRY


def test_tierstats_mirrors_into_registry_once():
    reg = obs.metrics()
    before = [reg.counter("sort.tier_attempts", tier="whp").value, reg.counter("sort.tier_ok", tier="whp").value,
              reg.counter("sort.retries").value]
    st = TierStats()
    st.record("whp", ok=False)
    st.record("whp", ok=True)
    after = [reg.counter("sort.tier_attempts", tier="whp").value, reg.counter("sort.tier_ok", tier="whp").value,
             reg.counter("sort.retries").value]
    assert [a - b for a, b in zip(after, before)] == [2, 1, 1]
    acc = TierStats()
    acc.merge_from(st)  # must not mirror again
    acc.merge_from(st)
    assert reg.counter("sort.tier_attempts", tier="whp").value == after[0]
    assert (acc.attempts, acc.successes, acc.retries, acc.last_tier) == ({"whp": 4}, {"whp": 2}, 2, "whp")
    ref = reference()
    racc, rst = ref.TierStats(), ref.TierStats()
    rst.record("whp", ok=False)
    rst.record("whp", ok=True)
    racc.merge_from(rst)
    racc.merge_from(rst)
    assert racc.as_row() == acc.as_row()


# ------------------------------------------- tracing changes nothing
def test_obs_field_is_invisible_to_eq_hash_and_prepare_key():
    t = obs.Tracer()
    a = SortConfig(p=P, n_per_proc=N_P)
    b = SortConfig(p=P, n_per_proc=N_P, obs=t)
    assert a == b and hash(a) == hash(b)
    assert a.prepare_key() == b.prepare_key() and b.prepare_key().obs is None
    assert "obs" not in repr(b)


@pytest.mark.parametrize("kw", [dict(algorithm="det", pair_capacity="whp"), dict(algorithm="iran", omega=2.0),
                                dict(route="radix", merge="tree", pair_capacity="exact"),
                                dict(algorithm="det", omega=3.0, capacity_factor=2.0)],
                         ids=["det", "iran", "radix", "det omega"])
def test_prepare_key_matches_reference(kw):
    ref = reference()
    rcfg = ref.SortConfig(p=P, n_per_proc=N_P, **kw)
    want = config_fields(rcfg.prepare_key())  # every field, the chaos handle included
    got = config_fields(SortConfig(p=P, n_per_proc=N_P, **kw).prepare_key())
    assert got == want


def test_traced_rerun_builds_no_new_executor_entry():
    ex = SortExecutor()
    x = datagen.generate("DD", P, N_P, seed=3)
    cfg = dict(p=P, n_per_proc=N_P, pair_capacity="whp")
    res0, _, st0 = bsp_sort_safe(x, SortConfig(**cfg), executor=ex, device="cpu")
    counts = dict(ex.trace_counts)
    assert counts and all(v == 1 for v in counts.values())
    assert sum(k[0] == "prepare" for k in counts) == 1  # every rung shares one prepare
    assert sum(k[0] == "route" for k in counts) == len(st0.attempts)
    res1, _, _ = bsp_sort_safe(x, SortConfig(obs=obs.Tracer(), **cfg), executor=ex, device="cpu")
    assert dict(ex.trace_counts) == counts
    assert torch.equal(gathered_output(res1), torch.sort(torch.from_numpy(x).flatten()).values)


@pytest.mark.parametrize("kw", [dict(pair_capacity="whp"), dict(route="radix", pair_capacity="exact"),
                                dict(algorithm="iran", pair_capacity="whp", merge="tree", merge_backend="pallas")],
                         ids=["sample", "radix", "iran tree pallas"])
@pytest.mark.parametrize("resume", [True, False])
def test_traced_output_byte_identical(kw, resume):
    x = datagen.generate("U", P, N_P, seed=5)
    vals = [np.arange(x.size, dtype=np.int32).reshape(x.shape)]
    base = dict(p=P, n_per_proc=N_P, **kw)
    r0, v0, s0 = bsp_sort_safe(x, SortConfig(**base), values=vals, resume=resume, device="cpu")
    t = obs.Tracer()
    r1, v1, s1 = bsp_sort_safe(x, SortConfig(obs=t, **base), values=vals, resume=resume, device="cpu")
    assert torch.equal(r0.buf, r1.buf) and torch.equal(r0.count, r1.count) and torch.equal(v0[0], v1[0])
    assert s0.as_row() == s1.as_row()
    assert t.route_spans()
    assert any(s["name"] == "prepare" for s in t.spans) == resume


def test_traced_segmented_byte_identical():
    rng = np.random.default_rng(11)
    segs = [rng.integers(-1000, 1000, s).astype(np.int32) for s in (7, 300, 41)]
    packed = pack_segments(segs, 4)
    r0 = segmented_sort_safe(packed, device="cpu")
    t = obs.Tracer()
    r1 = segmented_sort_safe(packed, obs=t, device="cpu")
    for a, b in zip(r0.keys + r0.order, r1.keys + r1.order):
        assert torch.equal(a, b)
    (seg,) = [s for s in t.points if s["name"] == "segments"]
    assert seg["args"] == dict(n_segments=3, n_keys=348, layout="contiguous", sizes=[7, 300, 41], size_max=300)
    assert seg["tid"] == t.route_spans()[0]["tid"]


# ------------------------------------------------- span/trace schema
def traced_run(seed=5, dist="U", **kw):
    t = obs.Tracer()
    x = datagen.generate(dist, P, N_P, seed=seed)
    cfg = SortConfig(p=P, n_per_proc=N_P, pair_capacity="whp", obs=t, **kw)
    bsp_sort_safe(x, cfg, device="cpu")
    return t, cfg


def test_span_schema_and_chrome_trace_validate(tmp_path):
    t, _ = traced_run()
    assert obs.validate_spans(t) == [] and ref_obs().validate_spans(t) == []
    assert {"prepare", "route"} <= {s["name"] for s in t.spans}
    route = t.route_spans()[0]
    for key in ("tier", "rung", "ok", "h_words", "supersteps", "recv_max", "recv_mean", "imbalance", "sync_s",
                "recv"):
        assert key in route["args"], key
    data = json.loads(open(t.save(str(tmp_path / "trace.json"))).read())
    assert obs.validate_chrome_trace(data) == [] and ref_obs().validate_chrome_trace(data) == []
    assert {"X", "M", "i"} <= {e["ph"] for e in data["traceEvents"]}
    assert obs.validate_chrome_trace({}) == ref_obs().validate_chrome_trace({})


def test_imbalance_within_whp_bound_on_balanced_mix():
    t, cfg = traced_run()
    rep = t.cost_report()
    assert rep["max_imbalance"] <= 1.0 + theoretical_max_imbalance(cfg)
    assert all(r["h_words"] >= N_P for r in rep["supersteps"])


ROUTE_ARGS = ("tier", "rung", "ok", "h_words", "supersteps", "recv_max", "recv_mean", "imbalance", "recv")


@pytest.mark.parametrize("dist,kw", [("U", {}), ("DD", {}), ("B", dict(merge="tree", merge_backend="pallas")),
                                     ("U", dict(route="radix", pair_capacity="exact")),
                                     ("adversarial", dict(capacity_factor=1.0))],
                         ids=["U", "DD ladder", "B tree pallas", "radix", "adversarial"])
def test_route_spans_and_distribution_match_reference(dist, kw):
    """Per-rung route-span args and the prepared distribution point, det."""
    import jax.numpy as jnp

    ref = reference()
    robs = ref_obs()
    x = adversarial(P, N_P) if dist == "adversarial" else datagen.generate(dist, P, N_P, seed=8)
    vals = [np.arange(x.size, dtype=np.int32).reshape(x.shape)]
    rt, t = robs.Tracer(), obs.Tracer()
    fields = dict(dict(p=P, n_per_proc=N_P, algorithm="det", pair_capacity="whp"), **kw)
    ref.bsp_sort_safe(jnp.asarray(x), ref.SortConfig(obs=rt, **fields), values=[jnp.asarray(v) for v in vals])
    cfg = config_from_reference(fields)
    bsp_sort_safe(x, SortConfig(**{**config_fields(cfg), "obs": t}), values=vals, device="cpu")
    want = [{k: s["args"][k] for k in ROUTE_ARGS} for s in rt.route_spans()]
    got = [{k: s["args"][k] for k in ROUTE_ARGS} for s in t.route_spans()]
    assert got == want and len(got) >= 1
    # the reference's categories: its stages run under jit, where no span can sit
    assert [s["name"] for s in t.spans if s["cat"] != "stage"] == [s["name"] for s in rt.spans]
    pts = lambda tr: [(p_["name"], p_["args"]) for p_ in tr.points]  # noqa: E731
    assert pts(t) == pts(rt)


# --------------------------------------------------------- (g, L) fit
def synthetic_spans():
    g, L = 2e-9, 5e-4
    rng = np.random.default_rng(3)
    return [{"name": "route", "tid": f"sort{i}", "args": {"h_words": h, "supersteps": s, "tier": "whp",
                                                         "rung": 0, "imbalance": 1.0 + 0.1 * i},
             "dur": g * h + L * s + float(rng.normal(0, 1e-6))}
            for i, (h, s) in enumerate([(1_000, 2), (10_000, 2), (100_000, 2), (50_000, 3), (7, 127)])]


def test_fit_gl_and_cost_report_match_reference():
    spans = synthetic_spans()
    fit, rfit = obs.fit_gl(spans), ref_obs().fit_gl(spans)
    assert fit.ok and rfit.ok and fit.n_samples == rfit.n_samples == 5
    for a, b in ((fit.g_s_per_word, rfit.g_s_per_word), (fit.l_s, rfit.l_s), (fit.r2, rfit.r2)):
        assert a == pytest.approx(b, rel=1e-12)
    exact = [dict(s, dur=2e-9 * s["args"]["h_words"] + 5e-4 * s["args"]["supersteps"]) for s in spans]
    ex = obs.fit_gl(exact)
    assert ex.g_s_per_word == pytest.approx(2e-9, rel=1e-6) and ex.l_s == pytest.approx(5e-4, rel=1e-6)
    t, rt = obs.Tracer(), ref_obs().Tracer()
    t.spans, rt.spans = list(spans), list(spans)
    rep, rrep = t.cost_report(), rt.cost_report()
    assert rep["max_imbalance"] == rrep["max_imbalance"]
    for k in ("g_s_per_word", "l_s", "r2"):
        assert rep["fit"][k] == pytest.approx(rrep["fit"][k], rel=1e-12)
    assert len(rep["supersteps"]) == len(rrep["supersteps"]) == 5
    for a, b in zip(rep["supersteps"], rrep["supersteps"]):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(b[k], float):
                assert a[k] == pytest.approx(b[k], rel=1e-12, abs=1e-15), k
            else:
                assert a[k] == b[k], k


def test_fit_gl_degenerate_inputs():
    one = [{"name": "route", "args": {"h_words": 5, "supersteps": 2}, "dur": 0.1}]
    for spans in ([], one, one * 3):  # none, one, constant h
        assert not obs.fit_gl(spans).ok and not ref_obs().fit_gl(spans).ok
    assert obs.resolve_tracer(None) is None and obs.resolve_tracer(object()) is None
    t = obs.Tracer()
    assert obs.resolve_tracer(t) is t


# ------------------------------------------------ executor and phases
def test_scope_is_entered_around_every_launch():
    import contextlib

    entered = []

    @contextlib.contextmanager
    def scope():
        entered.append(1)
        yield

    x = adversarial(P, 64)
    _, _, st = bsp_sort_safe(x, SortConfig(p=P, n_per_proc=64, pair_capacity="whp"), scope=scope, device="cpu")
    assert len(st.attempts) >= 2 and len(entered) == 1 + len(st.attempts)  # the prepare, then each rung
    entered.clear()
    _, _, st = bsp_sort_safe(x, SortConfig(p=P, n_per_proc=64, pair_capacity="whp"), scope=scope, resume=False,
                             device="cpu")
    assert len(entered) == len(st.attempts)


def test_default_executor_and_sort_entries():
    from repro_torch.core import default_executor

    assert default_executor() is default_executor()
    ex = SortExecutor()
    x = datagen.generate("DD", P, N_P, seed=1)
    _, _, st = bsp_sort_safe(x, SortConfig(p=P, n_per_proc=N_P, pair_capacity="whp"), executor=ex, resume=False,
                             device="cpu")
    assert sorted(k[0] for k in ex.trace_counts) == ["sort"] * len(st.attempts)
    assert all(k[1] == "vmap" and k[3] == 0 for k in ex.trace_counts)


@pytest.mark.parametrize("kw", [dict(algorithm="det"), dict(algorithm="det", sample_sort="bitonic"),
                                dict(algorithm="det", local_sort="bitonic", routing="allgather")],
                         ids=["det", "det bitonic sample", "det allgather"])
def test_phase_fns_match_reference(kw):
    """The paper's Ph2..Ph6 as separate callables, phase by phase."""
    import jax.numpy as jnp

    ref = reference()
    from repro.core.api import phase_fns as ref_phase_fns

    from repro_torch.core import phase_fns

    x = datagen.generate("G", P, N_P, seed=2)
    rcfg = ref.SortConfig(p=P, n_per_proc=N_P, **kw)
    rf, f = ref_phase_fns(rcfg), phase_fns(config_from_reference(config_fields(rcfg)))
    assert list(f) == list(rf) == ["SeqSort", "Sampling", "Prefix", "Routing", "Merging"]
    rxs, xs = rf["SeqSort"](jnp.asarray(x)), f["SeqSort"](torch.from_numpy(x))
    assert np.array_equal(np.asarray(rxs), xs.numpy())
    rsp, sp = rf["Sampling"](rxs), f["Sampling"](xs)
    for a, b in zip(rsp, sp):
        assert np.array_equal(np.asarray(a), b.numpy())
    rb, b = rf["Prefix"](rxs, rsp), f["Prefix"](xs, sp)
    assert np.array_equal(np.asarray(rb), b.numpy())
    rr, r = rf["Routing"](rxs, rb), f["Routing"](xs, b)
    for a, c in zip(rr, r):
        assert np.array_equal(np.asarray(a).reshape(np.asarray(c.numpy()).shape), c.numpy())
    assert np.array_equal(np.asarray(rf["Merging"](rr[0])), f["Merging"](r[0]).numpy())


def test_escalate_walks_the_ladder_as_the_driver():
    from repro_torch.core.api import _escalate, _positions

    ex = SortExecutor()
    x = torch.from_numpy(adversarial(P, 64))
    cfg = SortConfig(p=P, n_per_proc=64, pair_capacity="whp")
    prep = ex.prepare_vmap(cfg, 0)(x)
    t = obs.Tracer()

    def run_tier(tier_cfg, rung):
        buf, vbufs, count, overflow = ex.route_vmap(tier_cfg, 0)(prep, _positions(tier_cfg, rung, None, x.device))
        return port_result(buf, count, overflow), list(vbufs)

    res, _, st = _escalate(cfg.tier_ladder(), TierStats(), run_tier, tracer=t,
                           trace_meta={"tid": "sort9", "row_bytes": 4})
    want, _, wst = bsp_sort_safe(x, cfg, device="cpu")
    assert torch.equal(res.buf, want.buf) and st.as_row() == wst.as_row()
    assert [s["args"]["tier"] for s in t.route_spans()] == list(st.attempts)


def port_result(buf, count, overflow):
    from repro_torch.core import SortResult

    return SortResult(buf=buf, count=count, overflow=overflow.any())


# ------------------------------------------------------- stage spans
STAGE_KW = dict(p=P, n_per_proc=N_P, pair_capacity="whp", merge="tree")


def span_end(s):
    return s["t0"] + s["dur"]


def test_stage_spans_one_set_per_rung_in_launch_order():
    ex = SortExecutor()
    x = datagen.generate("DD", P, N_P, seed=3)
    r0, _, _ = bsp_sort_safe(x, SortConfig(**STAGE_KW), executor=ex, device="cpu")
    counts = dict(ex.trace_counts)
    t = obs.Tracer()
    r1, _, st = bsp_sort_safe(x, SortConfig(obs=t, **STAGE_KW), executor=ex, device="cpu")
    assert dict(ex.trace_counts) == counts  # the stage hook builds no entry
    assert torch.equal(r0.buf, r1.buf) and torch.equal(r0.count, r1.count)
    assert obs.validate_spans(t) == []
    routes = t.route_spans()
    assert len(routes) == sum(st.attempts.values()) >= 3  # the DD ladder climbs
    want = [("local_sort", "prepare", None, None), ("splitters", "prepare", None, None)]
    for r in routes:
        want += [(n, "route", r["args"]["rung"], r["args"]["tier"]) for n in ("partition", "exchange", "merge_tree")]
    stages = sorted((s for s in t.spans if s["cat"] == "stage"), key=lambda s: s["t0"])
    assert [(s["name"], s["args"]["parent"], s["args"]["rung"], s["args"]["tier"]) for s in stages] == want
    (prep,) = [s for s in t.spans if s["name"] == "prepare"]
    for s in stages:
        assert s["tid"] == prep["tid"] == routes[0]["tid"]
        assert s["args"]["host_ms"] == s["dur"] * 1e3 and s["args"]["stream_ms"] is None  # no stream off the card
        outer = prep if s["args"]["parent"] == "prepare" else routes[s["args"]["rung"]]
        assert outer["t0"] <= s["t0"] and span_end(s) <= span_end(outer)
    for s in [prep] + routes:
        assert "stream_ms" in s["args"] and s["args"]["stream_ms"] is None
    # Ph5's receive slots: rows x p x the rung's pair capacity
    ladder = SortConfig(**STAGE_KW).tier_ladder()
    assert [s["args"]["slots"] for s in stages if s["name"] == "exchange"] == [
        P * P * c.pair_cap for _, c in ladder[:len(routes)]]
    assert all(s["args"]["keys"] == P * N_P for s in stages if s["name"] != "merge_tree")


def test_tiles_and_rank_merge_lie_inside_local_sort():
    from repro_torch.kernels.bitonic.ops import MAX_WIDTH

    p, n_p = 2, 2 * MAX_WIDTH  # two K1 tiles a row, then one rank-merge round
    x = datagen.generate("U", p, n_p, seed=4)
    kw = dict(p=p, n_per_proc=n_p, local_sort="bitonic", merge="tree", pair_capacity="whp")
    r0, _, _ = bsp_sort_safe(x, SortConfig(**kw), device="cpu")
    t = obs.Tracer()
    r1, _, _ = bsp_sort_safe(x, SortConfig(obs=t, **kw), device="cpu")
    assert torch.equal(r0.buf, r1.buf) and torch.equal(r0.count, r1.count)
    (ls,) = [s for s in t.spans if s["name"] == "local_sort"]
    kids = sorted((s for s in t.spans if s["name"].startswith("local_sort.")), key=lambda s: s["t0"])
    assert [s["name"] for s in kids] == ["local_sort.tiles", "local_sort.rank_merge"]
    for s in kids:
        assert ls["t0"] <= s["t0"] and span_end(s) <= span_end(ls)
        assert s["args"]["parent"] == "prepare" and s["tid"] == ls["tid"] and s["args"]["keys"] == p * n_p
    assert span_end(kids[0]) <= kids[1]["t0"]


def test_untraced_stages_read_no_clock_record_no_event_open_no_range(monkeypatch):
    import time

    from repro_torch.obs import trace

    seen = {"clock": 0, "event": 0, "range": 0}
    real_clock = time.perf_counter

    def clock():
        seen["clock"] += 1
        return real_clock()

    class Fake:
        def __init__(self, what):
            seen[what] += 1

    monkeypatch.setattr(time, "perf_counter", clock)
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: Fake("event"))
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a, **k: Fake("range"))
    x = datagen.generate("DD", P, N_P, seed=3)
    bsp_sort_safe(x, SortConfig(**STAGE_KW), device="cpu")
    assert seen == {"clock": 0, "event": 0, "range": 0}
    assert trace.stage("partition", keys=1) is trace.lane(None, None, "prepare") is trace._NULL
    assert not trace.stage("exchange")
    t = obs.Tracer(clock=clock)
    bsp_sort_safe(x, SortConfig(obs=t, **STAGE_KW), device="cpu")
    assert seen["clock"] > 0 and seen["event"] == seen["range"] == 0  # traced on the CPU: clocks only


def test_profiled_spans_have_ranges_and_align_to_the_trace(tmp_path):
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.trace import range_name

    t = obs.Tracer()
    x = datagen.generate("DD", P, N_P, seed=3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bsp_sort_safe(x, SortConfig(obs=t, **STAGE_KW), device="cpu")
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("bsp:"):
            ranges[e["name"]].append(float(e["ts"]))
    names = [range_name(s) for s in t.spans]
    assert None not in names and set(names) == set(ranges)  # every span has its range, and no range is spare
    assert "bsp:rung.whp" in ranges and "bsp:local_sort" in ranges
    aligned = t.chrome_trace(align_to=events)
    assert obs.validate_chrome_trace(aligned) == []
    starts = defaultdict(list)
    for name, e in zip(names, [e for e in aligned["traceEvents"] if e["ph"] == "X"]):
        starts[name].append(e["ts"])
    for name, ts in starts.items():
        got = sorted(ranges[name])
        assert len(got) == len(ts), name
        for a, b in zip(sorted(ts), got):
            assert abs(a - b) < 1000.0, (name, a - b)  # µs
    with pytest.raises(ValueError):
        t.chrome_trace(align_to=[])


@pytest.mark.parametrize("kind", ["int32 DD", "float32 with NaNs and zeros"])
def test_traced_prepare_copies_only_the_boundaries(kind, monkeypatch):
    """The distribution point searches the runs on the device; the host
    gets the (rows, p+1) boundaries and nothing larger, and the point is
    the one a host search of the copied runs gives."""
    from repro_torch.core import api

    rng = np.random.default_rng(6)
    if kind == "int32 DD":
        x = torch.from_numpy(datagen.generate("DD", P, N_P, seed=6))
    else:
        v = rng.choice(np.array([np.nan, -0.0, 0.0, -1.5, 2.0, np.inf], np.float32), (P, N_P))
        x = torch.from_numpy(np.where(rng.random((P, N_P)) < 0.5, rng.normal(size=(P, N_P)), v).astype(np.float32))
    cfg = SortConfig(p=P, n_per_proc=N_P, pair_capacity="whp")
    prep = SortExecutor().prepare_vmap(cfg, 0)(x)
    t = obs.Tracer()
    meta = api._trace_meta_for(t, x, [])
    copies = []
    for name in ("cpu", "numpy", "tolist", "item"):
        real = getattr(torch.Tensor, name)

        def spy(self, *a, _real=real, **k):
            copies.append(self.numel())
            return _real(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, spy)
    api._trace_prepared(t, meta, cfg, prep)
    monkeypatch.undo()
    assert copies and max(copies) <= P * (P + 1)
    (pt,) = [p_["args"] for p_ in t.points if p_["name"] == "distribution"]
    # the host search the point was made by before: np.searchsorted of the copied runs
    xs, keys = prep.xs.numpy(), prep.splits[0][0].numpy()
    bounds = np.stack([np.searchsorted(row, keys) for row in xs])
    bounds = np.concatenate([np.zeros((P, 1), np.int64), bounds, np.full((P, 1), N_P, np.int64)], axis=1)
    sendc = np.diff(bounds, axis=1)
    recv = sendc.sum(axis=0)
    assert pt["pair_max"] == int(sendc.max()) and pt["recv_max"] == int(recv.max())
    assert pt["skew"] == float(recv.max() / recv.mean()) and pt["send_bytes"] == (sendc * 4).tolist()


@pytest.mark.cuda
def test_card_stream_times_fit_their_host_intervals():
    """On the card every span's stream time is positive and no longer than
    its host interval from launch to the sync that read it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    from repro_torch.kernels.bitonic.ops import MAX_WIDTH

    n_p = 2 * MAX_WIDTH
    x = torch.from_numpy(datagen.generate("DD", P, n_p, seed=3)).cuda()
    t = obs.Tracer()
    cfg = SortConfig(p=P, n_per_proc=n_p, pair_capacity="whp", local_sort="bitonic", merge="tree",
                     merge_backend="pallas", obs=t)
    res, _, st = bsp_sort_safe(x, cfg)
    assert torch.equal(gathered_output(res).cpu(), torch.sort(x.flatten().cpu()).values)
    (prep,) = [s for s in t.spans if s["name"] == "prepare"]
    routes = t.route_spans()
    assert st.retries >= 1 and {s["name"] for s in t.spans if s["cat"] == "stage"} >= {
        "local_sort", "local_sort.tiles", "local_sort.rank_merge", "splitters", "partition", "exchange", "merge_tree"}
    timed = [s for s in t.spans if "stream_ms" in s["args"]]
    assert len(timed) == len(t.spans)
    for s in timed:
        ms = s["args"]["stream_ms"]
        if s["cat"] == "stage":
            outer = prep if s["args"]["parent"] == "prepare" else routes[s["args"]["rung"]]
        else:
            outer = s
        assert ms is not None and 0 < ms <= (span_end(outer) - s["t0"]) * 1e3 + 1e-3, (s["name"], ms)
