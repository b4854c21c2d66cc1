"""The port's recurrent cores (``models.ssm``: the Mamba S6 block, the
mLSTM and sLSTM cores, the xLSTM up/down projection) against the JAX
package's, jitted, on one layer's weights from the reference's ``init_*``
and numpy inputs from a seed.

Tolerances: float32 within 1e-5 of the largest output magnitude (the port
runs each recurrence as a Python loop in the reference's order of
operations; XLA sums the state's contractions in another order, and the
port's ``F.softplus`` is x above 20 where the reference's is
log1p(exp(x)): under 3e-9 apart there). bfloat16 at the harness's 6e-2 of
the largest output (``test_torch_lm.py``'s note: the jitted reference
keeps float32 inside its fusions where the port rounds). The carried
state: one pass over S + k positions equals a pass over S followed by k
single steps from the carried state, in both packages, within 1e-5.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro_torch.models import ssm
from test_torch_harness import inputs, port_config, ref_lm, to_numpy, to_torch

S, K = 12, 3  # positions of the pass, and single steps after it


def ref_ssm():
    import importlib

    ref_lm()
    return importlib.import_module("repro.models.ssm")


def config(family: str, dtype: str, **kw):
    arch = "jamba-1.5-large-398b" if family == "mamba" else "xlstm-350m"
    return dataclasses.replace(ref_lm().configs.get_arch(arch).reduced(), dtype=dtype, **kw)


def layer_params(init, cfg, seed=0):
    """One layer of the reference's ``init`` (its stacked leaves at index 0),
    as (reference dict, port dict)."""
    import jax

    rp = jax.tree.map(lambda a: a[0], init(jax.random.key(seed), cfg, 1))
    return rp, {k: to_torch(np.asarray(v)) for k, v in rp.items()}


CORES = {
    "mamba": ("init_mamba", "mamba_block"),
    "mlstm": ("init_mlstm", "mlstm_core"),
    "slstm": ("init_slstm", "slstm_core"),
}


def core_pair(name, dtype, **cfg_kw):
    """(reference core, port core, reference params, port params, cfg):
    each core ``(p, x, state) -> (y, state)``, the reference's jitted."""
    import jax

    rs = ref_ssm()
    init, fn = CORES[name]
    cfg = config("mamba" if name == "mamba" else "xlstm", dtype, **cfg_kw)
    rp, p = layer_params(getattr(rs, init), cfg)
    rfn = jax.jit(lambda p_, x_, st: getattr(rs, fn)(p_, x_, cfg, st))
    pcfg = port_config(cfg)
    return rfn, (lambda p_, x_, st: getattr(ssm, fn)(p_, x_, pcfg, st)), rp, p, cfg


def assert_close(port, ref, dtype, what):
    p, r = to_numpy(port), to_numpy(ref)
    assert p.shape == r.shape, (what, p.shape, r.shape)
    if not p.size:
        return
    tol = 1e-5 if dtype == "float32" else 6e-2
    err, scale = float(np.abs(p - r).max()), float(np.abs(r).max())
    assert err <= tol * scale, f"{what}: max error {err} against {tol} x {scale}"


CASES = [("mamba", {}), ("mamba", {"mamba_d_conv": 1}), ("mlstm", {}), ("slstm", {})]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,cfg_kw", CASES, ids=["mamba", "mamba_dconv1", "mlstm", "slstm"])
def test_core_equals_reference(name, cfg_kw, dtype):
    """Output and final state from a zero state, then a second pass from
    that state (the decode path's carried state)."""
    rfn, fn, rp, p, cfg = core_pair(name, dtype, **cfg_kw)
    rng = np.random.default_rng(len(name))
    rx, x = inputs(rng, (2, S, cfg.d_model), dtype)
    ry, rst = rfn(rp, rx, None)
    y, st = fn(p, x, None)
    assert y.dtype == x.dtype
    assert_close(y, ry, dtype, "output")
    for i, (a, b) in enumerate(zip(st, rst)):
        assert a.dtype == to_torch(np.asarray(b)).dtype, i
        assert_close(a, b, "float32" if a.dtype != x.dtype else dtype, f"state {i}")
    if name == "mamba" and cfg.mamba_d_conv == 1:
        assert tuple(st[1].shape) == (2, 0, 2 * cfg.d_model)  # no left context to carry
    rx2, x2 = inputs(rng, (2, K, cfg.d_model), dtype)
    ry2, _ = rfn(rp, rx2, rst)
    y2, _ = fn(p, x2, tuple(to_torch(np.asarray(a)) for a in rst))
    assert_close(y2, ry2, dtype, "output from a carried state")


@pytest.mark.parametrize("name,cfg_kw", CASES, ids=["mamba", "mamba_dconv1", "mlstm", "slstm"])
def test_carried_state_equals_one_pass(name, cfg_kw):
    """float32: a pass over S + K positions against a pass over S and K
    single steps carrying the state, in the port and in the reference."""
    import jax.numpy as jnp

    rfn, fn, rp, p, cfg = core_pair(name, "float32", **cfg_kw)
    rx, x = inputs(np.random.default_rng(7), (2, S + K, cfg.d_model), "float32")
    for run, params, xs, cat in ((fn, p, x, lambda ys: np.concatenate([to_numpy(y) for y in ys], 1)),
                                 (rfn, rp, rx, lambda ys: np.asarray(jnp.concatenate(ys, 1)))):
        full, st_full = run(params, xs, None)
        ys, st = [], None
        for lo, hi in [(0, S)] + [(S + j, S + j + 1) for j in range(K)]:
            y, st = run(params, xs[:, lo:hi], st)
            ys.append(y)
        assert_close(cat(ys), full, "float32", "stepped output")
        for a, b in zip(st, st_full):
            assert_close(a, b, "float32", "stepped state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_proj_equals_reference(dtype):
    """The up/down projection with the tanh-form GELU (``jax.nn.gelu``'s
    default)."""
    import jax

    rs = ref_ssm()
    cfg = config("xlstm", dtype)
    rp, p = layer_params(rs.init_mlstm, cfg, seed=3)
    rproj = {k: rp[k] for k in ("up", "down")}
    proj = {k: p[k] for k in ("up", "down")}
    rx, x = inputs(np.random.default_rng(5), (2, S, cfg.d_model), dtype, scale=3.0)
    assert_close(ssm.xlstm_proj(proj, x), jax.jit(rs.xlstm_proj)(rproj, rx), dtype, "xlstm_proj")


def test_mamba_dims_and_state_shape_equal_reference():
    rs = ref_ssm()
    for kw in ({}, {"mamba_d_conv": 1}, {"d_model": 8}):
        cfg = config("mamba", "float32", **kw)
        assert ssm.mamba_dims(port_config(cfg)) == rs.mamba_dims(cfg)
        assert ssm.mamba_state_shape(port_config(cfg), 3) == rs.mamba_state_shape(cfg, 3)


def test_stabiliser_starts_without_nan():
    """The first step's forget term is exp(-1e30 - ...) = 0, not NaN, also
    where the input gate is large."""
    import torch

    _, fn, _, p, cfg = core_pair("mlstm", "float32")
    x = torch.full((1, 2, cfg.d_model), 40.0)
    y, (C, n, m) = fn(p, x, None)
    assert torch.isfinite(y).all() and torch.isfinite(C).all() and torch.isfinite(m).all()
