"""The port's ``optim/`` against the JAX package's ``repro.optim``.

Tolerances:

* ``schedule``: 2 ulp of float32 (``rtol`` 2.4e-7). Both compute in float32
  from the int32 step, but ``cos`` is XLA's on one side and torch's on the
  other.
* ``global_norm``: ``rtol`` 1e-6. The reference reduces each stacked
  (L, ...) leaf at once; the port adds its per-layer sums in the
  reference's tree order, so the last bits may differ.
* ``apply_updates``, three steps: the float32 step math is the
  reference's op for op; ``pow`` (the bias corrections) and ``cos`` are two
  libraries', a few ulp apart, and the clip scale divides by the global
  norm above. Each leaf is held against its largest magnitude: float32
  parameters and moments at 1e-5 of it; a bfloat16 result (parameters or
  moments) may round the other way at a tie of those ulps, so it is held
  at one bfloat16 ulp of it (2**-7).
* int8 compression under round to nearest: the reference's bytes (codes
  and float32 scales).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.optim import OptConfig, apply_updates, compress, global_norm, init_state, schedule
from test_torch_harness import inputs, ref_lm, to_numpy, to_torch


def ref_optim():
    import importlib

    ref_lm()  # the reference importable (the enable_x64 alias)
    return importlib.import_module("repro.optim"), importlib.import_module("repro.optim.compress")


@pytest.mark.parametrize("step", [0, 1, 50, 100, 5000, 10_000, 12_000])
def test_schedule_equals_reference(step):
    import jax.numpy as jnp

    ropt, _ = ref_optim()
    for cfg in (OptConfig(), OptConfig(lr=1e-3, warmup_steps=1, total_steps=30, min_lr_frac=0.05)):
        rcfg = ropt.OptConfig(**cfg.__dict__)
        want = np.asarray(ropt.schedule(rcfg, jnp.asarray(step, jnp.int32)))
        got = schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=2.4e-7, atol=0)


def layered_tree(rng, dtype, scale=1.0):
    """A reference-shaped tree (top-level leaves and stacked layers) and the
    port's dict of the same values by state-dict name."""
    shapes = {"embed": (17, 8), "final_norm": (8,), "lm_head": (8, 17)}
    layer_shapes = {"wq": (8, 8), "attn_norm": (8,), "w_down": (3, 12, 8)}
    rtree, port = {}, {}
    for k, s in shapes.items():
        rtree[k], port[k] = inputs(rng, s, dtype, scale)
    rtree["layers"] = {}
    for k, s in layer_shapes.items():
        r, t = inputs(rng, (3,) + s, dtype, scale)
        rtree["layers"][k] = r
        port.update({f"layers.{i}.{k}": t[i].clone() for i in range(3)})
    return rtree, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_norm_equals_reference(dtype):
    ropt, _ = ref_optim()
    rtree, port = layered_tree(np.random.default_rng(1), dtype, scale=3.0)
    np.testing.assert_allclose(float(global_norm(port)), float(ropt.global_norm(rtree)), rtol=1e-6)


def assert_close_tree(port, rtree, rel, what):
    """Each leaf within ``rel`` of its largest magnitude in the reference."""
    from repro_torch.core import tree_to_reference

    got = tree_to_reference(port)
    pairs = [(k, got[k], rtree[k]) for k in rtree if k != "layers"]
    pairs += [(sub, got["layers"][sub], r) for sub, r in rtree.get("layers", {}).items()]
    for k, g, r in pairs:
        r = to_numpy(r)
        np.testing.assert_allclose(g, r, rtol=0, atol=rel * np.abs(r).max(), err_msg=f"{what} {k}")


def tol(dtype):
    return 2.0**-7 if dtype == "bfloat16" else 1e-5


@pytest.mark.parametrize("param_dtype,state_dtype,clip", [
    ("float32", "float32", False), ("float32", "bfloat16", False), ("bfloat16", "float32", False),
    ("bfloat16", "bfloat16", False), ("float32", "float32", True), ("bfloat16", "bfloat16", True),
])
def test_apply_updates_three_steps_equal_reference(param_dtype, state_dtype, clip):
    """Three AdamW steps on the same parameters and gradients; with
    ``clip`` the gradients' global norm is about 200 against a clip norm of
    0.5, so the clip scale is active on every step."""
    ropt, _ = ref_optim()
    cfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=10, state_dtype=state_dtype,
                    clip_norm=0.5 if clip else 1.0)
    rcfg = ropt.OptConfig(**cfg.__dict__)
    rng = np.random.default_rng(2)
    rparams, params = layered_tree(rng, param_dtype)
    rstate, state = ropt.init_state(rcfg, rparams), init_state(cfg, params)
    for _ in range(3):
        rgrads, grads = layered_tree(rng, param_dtype, scale=30.0 if clip else 0.1)
        rparams, rstate, rmet = ropt.apply_updates(rcfg, rparams, rgrads, rstate)
        before = {k: id(p) for k, p in params.items()}
        state, met = apply_updates(cfg, params, grads, state)
        assert {k: id(p) for k, p in params.items()} == before  # in place
        if clip:
            assert float(rmet["grad_norm"]) > 100
        np.testing.assert_allclose(float(met["grad_norm"]), float(rmet["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(met["lr"]), float(rmet["lr"]), rtol=2.4e-7)
    assert int(state["step"]) == int(rstate["step"]) == 3 and state["step"].dtype == torch.int32
    assert all(p.dtype == getattr(torch, param_dtype) for p in params.values())
    assert all(m.dtype == getattr(torch, state_dtype) for m in state["m"].values())
    assert_close_tree(params, rparams, tol(param_dtype), "params")
    assert_close_tree(state["m"], rstate["m"], tol(state_dtype), "m")
    assert_close_tree(state["v"], rstate["v"], tol(state_dtype), "v")


def test_adamw_clip_and_schedule():
    """The reference's ``test_adamw_clip_and_schedule``: gradient norm 200."""
    oc = OptConfig(lr=1.0, clip_norm=0.5, warmup_steps=0, total_steps=100)
    params = {"w": torch.ones(4)}
    st = init_state(oc, params)
    st2, metrics = apply_updates(oc, params, {"w": torch.full((4,), 100.0)}, st)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    assert int(st2["step"]) == 1


# ------------------------------------------------------------------ compress
@pytest.mark.parametrize("n", [1, 255, 256, 768, 1000])
def test_quantize_int8_bytes_equal_reference(n):
    import jax.numpy as jnp

    _, rc = ref_optim()
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32) * 3
    x[n // 2] = 0.0
    rq, rs = rc.quantize_int8(jnp.asarray(x))
    q, s = compress.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.asarray(rq).tobytes() == q.numpy().tobytes()
    assert np.asarray(rs).tobytes() == s.numpy().tobytes()
    deq = compress.dequantize_int8(q, s, (n,))
    assert np.asarray(rc.dequantize_int8(rq, rs, (n,))).tobytes() == deq.numpy().tobytes()


def test_compress_tree_error_feedback_equals_reference():
    """Two steps of error feedback: the codes, the scales, the residuals and
    the decompressed tree are the reference's bytes."""
    import jax

    _, rc = ref_optim()
    rng = np.random.default_rng(5)
    rtree, tree = layered_tree(rng, "float32")
    rflat = {k: v for k, v in rtree.items() if k != "layers"}
    flat = {k: tree[k] for k in rflat}
    rerr, err = rc.init_errors(rflat), compress.init_errors(flat)
    for _ in range(2):
        rq, rerr = rc.compress_tree(rflat, rerr, jax.random.key(0))
        q, err = compress.compress_tree(flat, err)
        for k in flat:
            assert np.asarray(rq[k][0]).tobytes() == q[k][0].numpy().tobytes(), k
            assert np.asarray(rq[k][1]).tobytes() == q[k][1].numpy().tobytes(), k
            assert np.asarray(rerr[k]).tobytes() == err[k].numpy().tobytes(), k
        assert any(float(e.abs().max()) > 0 for e in err.values())
        deq, rdeq = compress.decompress_tree(q, flat), rc.decompress_tree(rq, rflat)
        for k in flat:
            assert np.asarray(rdeq[k]).tobytes() == deq[k].numpy().tobytes(), k


def test_stochastic_rounding_unbiased_and_within_one_code():
    """With a generator the codes average to the input (the draws cannot be
    ``jax.random``'s: the contract is tested, not the bytes). Over 4000
    draws of one block the mean code of every element is within 0.05 of
    its scaled value (the mean of a rounding error of at most one code has
    a standard deviation of at most 0.5 / sqrt(4000) = 0.008), and every
    code is the floor or the ceiling of it."""
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(256).astype(np.float32))
    q0, s = compress.quantize_int8(x)
    y = x / s[0]
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([compress.quantize_int8(x, gen)[0][0].float() for _ in range(4000)])
    assert bool(((draws == torch.floor(y)) | (draws == torch.ceil(y))).all())
    assert float((draws.mean(0) - y).abs().max()) < 0.05
    assert float((draws.mean(0) - y).abs().max()) < float((q0[0].float() - y).abs().max())
