"""The port's single-device MoE (``models.moe``) against the JAX package's:
the router's expert choices exactly, its aux terms, and the grouped-GEMM
dispatch's output and overflow flag, below and above the n = 512 capacity
threshold; then the per-lane capacity rule against the reference called
lane by lane (its engine's vmapped slot decode)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.models import moe
from test_torch_harness import inputs, port_config, ref_lm, to_numpy, to_torch

DTYPES = ("float32", "bfloat16")


def moe_setup(dtype, experts=4, top_k=2, seed=0):
    """A reduced granite MoE layer in both packages: (reference cfg, port
    cfg, reference params, port params)."""
    import jax

    r = ref_lm()
    cfg = dataclasses.replace(r.configs.get_arch("granite-moe-1b-a400m").reduced(), dtype=dtype,
                              moe_experts=experts, moe_top_k=top_k)
    tree = {k: np.asarray(v)[0] for k, v in r.moe.init_moe(jax.random.key(seed), cfg, 1).items()}
    return cfg, port_config(cfg), {k: jax.numpy.asarray(v) for k, v in tree.items()}, {
        k: to_torch(v) for k, v in tree.items()}


@pytest.mark.parametrize("dtype", DTYPES)
def test_router_choices_and_aux(dtype):
    r = ref_lm().moe
    cfg, _, rp, pp = moe_setup(dtype, experts=8, top_k=3)
    x, xt = inputs(np.random.default_rng(3), (64, 128), dtype)
    rprobs, rexp, raux = r._router(x, rp["router"], 3)
    probs, exp, aux = moe._router(xt, pp["router"], 3)
    np.testing.assert_array_equal(exp.numpy(), np.asarray(rexp))
    assert exp.dtype == torch.int32
    np.testing.assert_allclose(probs.numpy(), np.asarray(rprobs), rtol=1e-6, atol=1e-7)
    for key in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[key]), float(raux[key]), rtol=1e-6, err_msg=key)


def test_router_ties_take_the_lower_index_first():
    """Equal router columns give exactly equal probabilities: the lower
    expert id comes first, as ``lax.top_k`` orders them."""
    r = ref_lm().moe
    rng = np.random.default_rng(4)
    w = rng.standard_normal((128, 6)).astype(np.float32)
    w[:, 4] = w[:, 1]
    w[:, 5] = w[:, 1]
    x = rng.standard_normal((32, 128)).astype(np.float32)
    _, rexp, _ = r._router(x, w, 4)
    _, exp, _ = moe._router(torch.from_numpy(x), torch.from_numpy(w), 4)
    np.testing.assert_array_equal(exp.numpy(), np.asarray(rexp))
    assert (np.diff(np.sort(exp.numpy(), 1)) > 0).all()  # no expert twice


# (tokens, top_k, capacity_factor): n = 80 and 512 take full capacity; the
# others go over 512 records, with drops at the smaller factors
GROUPED = [(40, 2, 1.25), (256, 2, 1.25), (400, 2, 1.25), (400, 2, 0.5), (300, 4, 0.75)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("t,k,cf", GROUPED)
def test_grouped_gemm_moe(t, k, cf, dtype):
    """Against the reference's ``_grouped_gemm_moe``: the same overflow flag,
    outputs within one rounding (the CPU GEMMs of the two libraries sum in
    different orders)."""
    r = ref_lm().moe
    cfg, pcfg, rp, pp = moe_setup(dtype, top_k=k, seed=t)
    x, xt = inputs(np.random.default_rng(t + k), (t, 128), dtype)
    ry, raux = r._grouped_gemm_moe(rp, x, cfg, cf)
    y, aux = moe._grouped_gemm_moe(pp, xt, pcfg, cf)
    assert bool(aux["overflow"]) == bool(raux["overflow"])
    if t * k > 512 and cf < 1:
        assert bool(aux["overflow"]), "the case was meant to drop records"
    assert y.dtype == xt.dtype
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(to_numpy(y), to_numpy(ry), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [2, 8])
def test_combine_reproduces_the_reference_scatter_add_bytes(k, dtype):
    """The combine alone, on the same records: the bytes of the reference's
    ``jnp.zeros((T, D)).at[order // k].add(rec)`` (``moe.py``'s combine),
    both as it runs op by op and under ``jax.jit``."""
    import jax
    import jax.numpy as jnp

    t = 64
    rng = np.random.default_rng(k)
    rec, rect = inputs(rng, (t * k, 128), dtype)
    order = rng.permutation(t * k)

    def scatter(r, o):
        return jnp.zeros((t, 128), r.dtype).at[o // k].add(r)

    got = to_numpy(moe._combine(rect, torch.from_numpy(order), t, k))
    np.testing.assert_array_equal(got, to_numpy(scatter(rec, jnp.asarray(order))))
    np.testing.assert_array_equal(got, to_numpy(jax.jit(scatter)(rec, jnp.asarray(order))))


@pytest.mark.parametrize("lanes,t_lane,cf", [(6, 1, 1.25), (3, 8, 1.25), (2, 300, 0.5)])
def test_lanes_keep_the_per_lane_capacity_rule(lanes, t_lane, cf):
    """``lanes`` independent lanes equal the reference's MoE called on each
    lane alone: one token a lane never drops; 300 tokens a lane at cf 0.5
    drop within each lane by that lane's capacity."""
    import jax.numpy as jnp

    r = ref_lm().moe
    cfg, pcfg, rp, pp = moe_setup("float32", seed=lanes)
    x, xt = inputs(np.random.default_rng(lanes), (lanes, t_lane, 128), "float32")
    y, aux = moe.moe_tp(pp, xt, pcfg, cf, lanes=lanes)
    flags = []
    for i in range(lanes):
        ry, raux = r.moe_tp(rp, x[i:i + 1], cfg, cf)
        flags.append(bool(raux["overflow"]))
        np.testing.assert_allclose(y[i:i + 1].numpy(), np.asarray(ry), rtol=1e-5, atol=1e-6, err_msg=f"lane {i}")
    assert bool(aux["overflow"]) == any(flags)
    assert any(flags) == (t_lane * 2 > 512 and cf < 1)
    if lanes > 1 and t_lane == 1:  # the whole batch at once would use one rule for all
        _, whole = r.moe_tp(rp, jnp.asarray(x).reshape(1, lanes, 128), cfg, cf)
        assert not bool(whole["overflow"])


def test_mesh_info_without_a_mesh_only():
    """Without a mesh the layer sees one device; a mesh must be a
    ``DeviceMesh`` (the mesh paths: ``tests/test_torch_moe_ep.py``)."""
    info = moe.MoEMeshInfo()
    assert (info.model_size, info.data_size, info.axis_procs()) == (1, 1, [])
    with pytest.raises(TypeError, match="DeviceMesh"):
        moe.MoEMeshInfo(mesh=object())
