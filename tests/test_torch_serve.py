"""The port's ``serve`` (sampling, ``ServeEngine``) and ``data`` (synthetic
batches, length bucketing) against the JAX package's.

Greedy ``serve()`` streams are held equal to the reference engine's on the
same weights (float32, carried by ``params_from_reference``): continuous
batching with refills, prefetched admissions, zero and one-token budgets,
EOS retirement and arrivals folded into the admission view. Sampling draws
from a ``torch.Generator`` and is held to its properties.
"""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import batches_for_run, length_bucketed_order, synthetic_batch
from repro_torch.serve import ServeConfig, ServeEngine, sample, top_k_logits
from repro_torch.serve.engine import _mesh_sort_p
from repro_torch.service import SortServiceError
from test_torch_harness import lm_pair, ref_lm


def test_greedy_sampling_is_argmax():
    logits = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 100)).astype(np.float32))
    toks = sample(logits, torch.Generator().manual_seed(0), temperature=0.0)
    assert toks.dtype == torch.int32
    assert np.array_equal(toks.numpy(), np.argmax(logits.numpy(), -1))


@pytest.mark.parametrize("top_p", [0.0, 0.5])
def test_topk_sampling_stays_in_topk(top_p):
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((8, 100)).astype(np.float32))
    k = 5
    topk = np.argsort(-logits.numpy(), -1, kind="stable")[:, :k]
    gen = torch.Generator().manual_seed(1)
    seen = set()
    for _ in range(20):
        toks = sample(logits, gen, top_k=k, top_p=top_p).numpy()
        for b in range(8):
            assert toks[b] in topk[b]
            seen.add((b, int(toks[b])))
    assert len(seen) > 8  # it does draw, not only take the first


def test_top_k_logits_order_equals_reference():
    """Ties come out lower index first, as ``lax.top_k`` gives them."""
    r = ref_lm().serve
    logits = np.round(np.random.default_rng(2).standard_normal((6, 50)), 1).astype(np.float32)
    rv, ri = r.top_k_logits(logits, 12)
    v, i = top_k_logits(torch.from_numpy(logits), 12)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


@pytest.mark.parametrize("kind", ["random", "all_equal"])
def test_length_bucketed_order_equals_reference(kind):
    r = ref_lm().data
    if kind == "random":
        lens = np.random.default_rng(0).integers(1, 5000, 999).astype(np.int32)
    else:  # every key in one bucket: the capacity ladder must keep every id
        lens = np.full(777, 2048, np.int32)
    order = length_bucketed_order(lens, p=8, device="cpu")
    np.testing.assert_array_equal(order, np.asarray(r.length_bucketed_order(lens, p=8)))
    np.testing.assert_array_equal(order, np.argsort(lens, kind="stable"))


def test_length_bucketed_order_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        length_bucketed_order(np.arange(10, dtype=np.int32), p=8)


def test_mesh_sort_p_equals_reference():
    r = ref_lm().engine
    for devices in (None, (2, 4), (4, 4), (6,), (1,), (3, 5)):
        mesh = None if devices is None else types.SimpleNamespace(devices=np.zeros(devices))
        assert _mesh_sort_p(mesh) == r._mesh_sort_p(mesh)


def test_synthetic_batch_is_stateless_seeded():
    cfg = get_arch("internvl2-76b").reduced()
    shape = ShapeConfig("t", 16, 2, "train")
    b1, b2 = synthetic_batch(cfg, shape, 7, device="cpu"), synthetic_batch(cfg, shape, 7, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])  # restart-exact
    assert not torch.equal(b1["tokens"], synthetic_batch(cfg, shape, 8, device="cpu")["tokens"])
    assert torch.equal(b1["labels"], torch.roll(b1["tokens"], -1, 1))
    assert b1["tokens"].dtype == torch.int32 and int(b1["tokens"].max()) < cfg.vocab
    assert tuple(b1["patch_embeds"].shape) == (2, cfg.vision_tokens, cfg.d_model)
    steps = [s for s, _ in batches_for_run(cfg, shape, 3, 2, device="cpu")]
    assert steps == [3, 4]


# ------------------------------------------------------------------ the engine
@pytest.fixture(scope="module", params=["tinyllama-1.1b", "granite-moe-1b-a400m"])
def engines(request):
    """(reference engine, port engine) on one reduced float32 model with the
    same weights, greedy, budget 6, EOS id 1."""
    r = ref_lm().serve
    rmodel, rparams, model = lm_pair(request.param, "float32")
    kw = dict(max_new_tokens=6, temperature=0.0, eos_id=1)
    return r.ServeEngine(rmodel, rparams, r.ServeConfig(**kw)), ServeEngine(model, ServeConfig(**kw))


def counters(eng):
    return eng.refills, eng.admission_prefetches, eng.admission_fallbacks


def serve_both(engines, prompts, **kw):
    """Serve in both engines; the streams and the counters' increments."""
    out = []
    for eng in engines:
        before = counters(eng)
        streams = eng.serve(prompts, **kw)
        out.append(([s.tolist() for s in streams], tuple(a - b for a, b in zip(counters(eng), before))))
    assert out[1] == out[0]
    return out[1]


def test_serve_streams_equal_reference(engines):
    """A queue of mixed lengths and budgets (one of 1 token, one of 0)
    through 2 slots, with arrivals folded in at steps 1 and 4; the streams
    also equal the port's lockstep ``generate`` row by row."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(5, 50, n).astype(np.int32) for n in (8, 12, 8, 12, 8)]
    arrive = {1: [rng.integers(5, 50, 12).astype(np.int32)], 4: [rng.integers(5, 50, 8).astype(np.int32)] * 2}
    streams, (refills, prefetches, _) = serve_both(
        engines, prompts, slots=2, max_new=[2, 6, 1, 0, 6], arrivals=lambda s: arrive.get(s))
    assert [len(s) for s in streams[:5]] == [2, 6, 1, 0, 6] and len(streams) == 8
    assert refills >= 1 and prefetches >= refills
    eights = [i for i, p in enumerate(prompts) if len(p) == 8]
    rows = engines[1].generate(np.stack([prompts[i] for i in eights])).numpy()
    for row, i in zip(rows, eights):
        assert streams[i] == row[: len(streams[i])].tolist(), i


def test_serve_edge_budgets_and_eos_retirement(engines):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(5, 50, 8).astype(np.int32) for _ in range(4)]
    assert serve_both(engines, [])[0] == []
    streams, _ = serve_both(engines, prompts, slots=2, max_new=[0, 3, 0, 3])
    assert [len(s) for s in streams] == [0, 3, 0, 3]
    streams, (refills, _, _) = serve_both(engines, prompts, slots=2, max_new=[0, 0, 0, 0])
    assert streams == [[]] * 4 and refills == 0
    # EOS: make the third greedy token of request 0 the EOS id, in both engines
    eos = int(engines[1].generate(prompts[0][None]).numpy()[0, 2])
    for eng in engines:
        eng.scfg.eos_id = eos
    try:
        streams, (refills, _, _) = serve_both(engines, prompts[:3], slots=1, max_new=[6, 1, 6])
    finally:
        for eng in engines:
            eng.scfg.eos_id = 1
    assert refills == 2  # a serial slot: two backfills
    assert streams[0][-1] == eos and len(streams[0]) <= 3
    for s in streams:
        assert eos not in s[:-1]


def test_admission_order_and_its_fallback(engines, monkeypatch):
    lens = np.random.default_rng(3).integers(1, 4096, 333).astype(np.int32)
    rorder, order = (np.asarray(eng.admission_order(lens)) for eng in engines)
    np.testing.assert_array_equal(order, rorder)
    np.testing.assert_array_equal(order, np.argsort(lens, kind="stable"))
    assert sum(engines[1].capacity_stats.attempts.values()) >= 1
    np.testing.assert_array_equal(engines[1].admission_order(lens, p=4), order)  # a one-off service

    ref_service_error = ref_lm().engine.SortServiceError
    for eng, err in zip(engines, (ref_service_error, SortServiceError)):
        def fail(keys, err=err):
            raise err("injected", rids=(0,))
        monkeypatch.setattr(eng.sort_service, "sort_one", fail)
    befores = [counters(eng) for eng in engines]
    orders = [np.asarray(eng.admission_order(np.full(64, 7, np.int32))) for eng in engines]
    np.testing.assert_array_equal(orders[1], orders[0])
    assert sorted(orders[1].tolist()) == list(range(64))
    for eng, before in zip(engines, befores):
        assert counters(eng)[2] - before[2] == 1
