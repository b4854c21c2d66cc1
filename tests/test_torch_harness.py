"""Parity harness between the JAX package (the reference) and the PyTorch port.

:func:`reference` imports the JAX package lazily, inside a test, never at
collection: the installed jax no longer has ``jax.experimental.enable_x64``,
which ``repro/core/segmented.py`` imports, so the loader first points that
name at ``jax.enable_x64``. Collection of every other test module is
unchanged. Inputs are made with numpy from a seed and handed to both.
"""
from __future__ import annotations

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def reference():
    """The JAX package's ``repro.core`` (imported on first call)."""
    import jax
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    import repro.core

    return repro.core


def x64(on: bool = True):
    """The JAX package's 64-bit scope (int64 keys, the segmented sort's
    composites); a no-op scope when ``on`` is false."""
    import contextlib

    reference()
    import jax

    return jax.experimental.enable_x64() if on else contextlib.nullcontext()


def reference_draws(monkeypatch, scope_x64=None):
    """Make the port's randomized sorts draw the reference's sample: rung r
    takes the positions ``random_sample`` draws under ``fold_in(key(seed), r)``
    (the draw depends on the shape, the key and the 64-bit scope only).

    ``scope_x64=None`` takes the scope from the keys being sorted, as the
    JAX package enters it: int64 keys (the segmented sort's composites, the
    delta route's lifted keys) draw under it, int32 keys outside it. The
    keys are the ``x`` of the frame that asks for the positions (the
    launch driver's ``run_tier``).
    """
    import jax
    import jax.numpy as jnp

    from repro_torch.core import api as port_api

    ref = reference()
    from repro.core import splitters
    from repro.core.types import AXIS

    def positions(cfg, rung, generator, device):
        if cfg.algorithm not in ("iran", "ran") or cfg.route == "radix":
            return None
        on = scope_x64
        if on is None:
            x = sys._getframe(1).f_locals.get("x")
            on = x is not None and x.dtype == torch.int64
        fields = {k: v for k, v in config_fields(cfg).items() if k not in ("obs", "chaos")}
        rcfg = ref.SortConfig(**fields)
        with x64(on):
            rng = jax.random.fold_in(jax.random.key(cfg.seed), rung)
            xs = jnp.zeros((cfg.p, cfg.n_per_proc), jnp.int32)
            pos = jax.vmap(lambda r: splitters.random_sample(r, rcfg, AXIS, rng)[2], axis_name=AXIS)(xs)
            return torch.from_numpy(np.array(pos)).to(device)

    monkeypatch.setattr(port_api, "_positions", positions)


def config_fields(cfg) -> dict:
    """A reference ``SortConfig``'s fields as a plain dict."""
    import dataclasses

    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def assert_same(ref, port, what: str = "") -> None:
    """Byte-identical: same dtype, same shape, same values."""
    r = np.asarray(ref)
    t = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert r.dtype == t.dtype, f"{what}: dtype {t.dtype} != reference {r.dtype}"
    assert r.shape == t.shape, f"{what}: shape {t.shape} != reference {r.shape}"
    assert r.tobytes() == t.tobytes(), f"{what}: values differ"


def adversarial(p: int, n_p: int) -> np.ndarray:
    """Every run constant but distinct: each aims at one bucket."""
    return np.repeat((np.arange(p, dtype=np.int32) * 1000)[:, None], n_p, axis=1)


# Imports ``repro_torch`` first, so a module that imports only after the
# package has (a circular import) passes here; tests/test_torch_imports.py
# is the check that each module imports on its own.
_IMPORT_CHECK = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_CHECK], env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_have_no_jax_or_reference_import():
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    files = list((SRC / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [str(f) for f in files if pat.search(f.read_text())]
    assert not hits, hits


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the script would run")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_ptxas_report_reads_every_kernel():
    """The build phase's register / spill / shared-memory summary, from a
    ``-Xptxas -v`` log in nvcc's layout (demangled or not)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cta = ("_ZN48_GLOBAL__N__2790624d_15_bitonic_sort_cu_98d02c6013sort_rows_ctaINS_8CodecIntE"
           "NS_7NoValueELi14EEEvPKNT_1TEPKT0_PS4_PS7_j")
    log = "\n".join([
        "== bitonic_sort.cu",
        "ptxas info    : 0 bytes gmem",
        f"ptxas info    : Compiling entry function '{cta}' for 'sm_90a'",
        f"ptxas info    : Function properties for {cta}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
        "== merge_path.cu",
        "ptxas info    : Compiling entry function '_Z3fooi' for 'sm_90a'",
        "    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 40 registers, 1024 bytes smem, 380 bytes cmem[0]",
    ])
    rows = smoke.ptxas_report(log)
    assert len(rows) == 2
    assert rows[0].startswith("bitonic_sort.cu ") and "sort_rows_cta" in rows[0]
    assert rows[0].endswith(": 64 registers, 0/0 B spilled/reloaded, 0 B static smem")
    assert rows[1].startswith("merge_path.cu ")
    assert rows[1].endswith(": 40 registers, 12/16 B spilled/reloaded, 1024 B static smem")


def test_chip_smoke_idle_share_is_not_clamped():
    """The idle share of a profiled run is 1 - busy / that run's own wall:
    a busy time above the wall gives a negative share, printed as it is."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.idle_share(250.0, 1000.0) == 0.75
    assert smoke.idle_share(0.0, 3.5) == 1.0
    assert smoke.idle_share(1200.0, 1000.0) == pytest.approx(-0.2)
    assert smoke.idle_share(2.241, 2.318) == pytest.approx(1 - 2.241 / 2.318)


def test_default_device_without_card_raises():
    from repro_torch.core import SortConfig, bsp_sort_safe, prepared_from_reference

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    x = adversarial(4, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bsp_sort_safe(x, SortConfig(p=4, n_per_proc=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepared_from_reference(x, [], None)


def test_reference_loader_imports_the_jax_package():
    ref = reference()
    assert hasattr(ref, "bsp_sort_safe") and hasattr(ref, "SortConfig")


# ------------------------------------------------ the sort service, both packages
def ref_service():
    """The JAX package's ``repro.service``, ``repro.chaos``, ``repro.delta``,
    ``repro.obs`` and ``repro.train.elastic`` (imported on first call)."""
    import types

    reference()
    import repro.chaos
    import repro.delta
    import repro.obs
    import repro.service
    import repro.train.elastic

    return types.SimpleNamespace(service=repro.service, chaos=repro.chaos, delta=repro.delta, obs=repro.obs,
                                 elastic=repro.train.elastic)


def service_pair(rex, ex, *, chaos=None, **cfg_kw):
    """One ``ServiceConfig`` in both packages: the reference's, and the
    port's converted from it (``service_config_from_reference``), with the
    fault plan ``chaos`` (keyword arguments of ``FaultPlan``) in each.
    Returns ``(reference service, port service on the CPU)``."""
    from repro_torch.core import service_config_from_reference
    from repro_torch.service import SortService

    r = ref_service()
    plan = r.chaos.FaultPlan(**chaos) if chaos is not None else None
    rcfg = r.service.ServiceConfig(chaos=plan, **cfg_kw)
    return (r.service.SortService(rcfg, executor=rex),
            SortService(service_config_from_reference(rcfg), executor=ex, device="cpu"))


def outcome(fut) -> tuple:
    """A future's outcome as plain data: a failure's class, message and
    rids, or a result's keys and order (dtype and bytes), tier, bucket
    and failsink mark."""
    exc = fut.exception()
    if exc is not None:
        return ("error", fut.rid, type(exc).__name__, str(exc), tuple(getattr(exc, "rids", ())), fut.failsink)
    res = fut.result()
    keys, order = np.asarray(res.keys), np.asarray(res.order)
    return ("ok", res.rid, keys.dtype.str, keys.tobytes(), order.dtype.str, order.tobytes(), res.tier,
            res.n_per_proc, res.failsink)


def assert_same_outcomes(rfuts, futs) -> None:
    assert len(rfuts) == len(futs)
    for rf, f in zip(rfuts, futs):
        assert outcome(f) == outcome(rf), f.rid


#: telemetry keys read off host clocks, which the two runs cannot share
CLOCK_KEYS = ("lat_mean_ms", "lat_p50_ms", "lat_p99_ms")


def counters(svc) -> dict:
    """A service's telemetry without the clock-read entries: every counter
    (dispatcher, planner, tiers, buckets, triggers). ``straggler_flights``
    compares flight walls with their running mean, so it goes too."""
    tele = {k: v for k, v in svc.telemetry().items() if k not in CLOCK_KEYS}
    tele["dispatch"] = {k: v for k, v in tele["dispatch"].items() if k != "straggler_flights"}
    return tele


def assert_same_counters(rsvc, svc) -> None:
    assert counters(svc) == counters(rsvc)


def patch_launch(monkeypatch, wrap) -> None:
    """Wrap ``segmented_sort_launch`` in both dispatch namespaces:
    ``wrap(orig)`` returns the replacement."""
    import repro_torch.service.dispatch as port_dispatch

    ref_service()
    import repro.service.dispatch as ref_dispatch

    for mod in (ref_dispatch, port_dispatch):
        monkeypatch.setattr(mod, "segmented_sort_launch", wrap(mod.segmented_sort_launch))


def request_arrays(sizes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(-(2**31), 2**31, s).astype(np.int32) for s in sizes]


# ------------------------------------------------------------ the LM stack, both packages
def ref_lm():
    """The JAX package's ``repro.configs``, ``repro.models`` (with its
    ``layers``, ``attention``, ``moe``, ``transformer``, ``ssm``, ``hybrid``,
    ``xlstm`` and ``encdec`` modules),
    ``repro.serve`` (and ``repro.serve.engine``) and ``repro.data``
    (imported on first call).

    The modules come from ``sys.modules``, not as attributes of their
    packages: where a JAX test module failed at collection on the
    ``enable_x64`` import, its package was dropped while the submodules it
    had imported stayed, and the package imported again lacks them as
    attributes."""
    import importlib
    import types

    reference()
    names = dict(configs="repro.configs", models="repro.models", layers="repro.models.layers",
                 attention="repro.models.attention", moe="repro.models.moe",
                 transformer="repro.models.transformer", ssm="repro.models.ssm", hybrid="repro.models.hybrid",
                 xlstm="repro.models.xlstm", encdec="repro.models.encdec", serve="repro.serve",
                 engine="repro.serve.engine", data="repro.data")
    return types.SimpleNamespace(**{k: importlib.import_module(m) for k, m in names.items()})


def lm_pair(arch: str, dtype: str = "bfloat16", seed: int = 0, **overrides):
    """The reduced ``arch`` in ``dtype`` (with any other config fields in
    ``overrides``) in both packages with the same weights: ``(reference
    Model, its params, port Model on the CPU)``, the reference's
    ``init(key(seed))`` carried across by ``params_from_reference``. The
    reference's half is drawn once per argument set (its op-by-op init
    takes seconds); the port's model is new on every call."""
    from repro_torch.core import params_from_reference
    from repro_torch.models import Model

    rmodel, rparams, tree = _ref_init(arch, dtype, seed, tuple(sorted(overrides.items())))
    return rmodel, rparams, Model(port_config(rmodel.cfg), device="cpu",
                                  params=params_from_reference(tree, device="cpu"))


@functools.lru_cache(maxsize=None)
def _ref_init(arch: str, dtype: str, seed: int, overrides: tuple):
    """(reference Model, its params, the params as numpy): immutable, so
    shared between calls."""
    import dataclasses

    import jax

    r = ref_lm()
    cfg = dataclasses.replace(r.configs.get_arch(arch).reduced(), dtype=dtype, **dict(overrides))
    rmodel = r.models.Model(cfg)
    rparams = rmodel.init(jax.random.key(seed))
    return rmodel, rparams, jax.tree.map(np.asarray, rparams)


def port_config(rcfg):
    """The port's ``ArchConfig`` with every field of the reference's."""
    import dataclasses

    from repro_torch.configs.base import ArchConfig

    return ArchConfig(**{f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)})


def to_numpy(a) -> np.ndarray:
    """A port tensor or a reference array as float32 numpy (bf16 widened)."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy() if a.is_floating_point() else a.detach().cpu().numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.kind == "V" or a.dtype.name == "bfloat16" else a


def to_torch(a) -> torch.Tensor:
    """A numpy array (``ml_dtypes.bfloat16`` included) as a CPU tensor."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def inputs(rng, shape, dtype: str, scale: float = 1.0):
    """One seeded normal array in ``dtype`` as ``(jax array, port tensor)``."""
    import jax.numpy as jnp
    import ml_dtypes

    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    a = a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a
    return jnp.asarray(a), to_torch(a)


# ------------------------------------------------ the recurrent families, both packages
def flat_tree(tree, prefix: str = "") -> dict:
    """A nested tree of arrays (dicts and tuples, either package's form) as
    ``{path: float32 numpy}``; zero-size leaves (a stack of length 0) left
    out."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, tuple, list)):
            out.update(flat_tree(v, name))
        elif np.size(v):
            out[name] = to_numpy(v)
    return out


def leaf_errors(port_named, ref_tree) -> dict:
    """Each leaf's largest error over its largest magnitude in the
    reference, port tensors by state-dict name against the reference's
    tree; that magnitude floored at 1e-3 of the largest over all leaves.

    The floor is for a leaf whose reference value is rounding noise:
    mLSTM's ``b_i`` shifts every input gate of a head alike, and the
    normalised read ``C q / max(|n . q|, 1)`` does not change under that
    shift, so its gradient is 0 in exact arithmetic (~1e-8 on the reduced
    xlstm, where the reference's own jitted and op-by-op gradients differ
    by 1.4 times it) against ~1e-2 on the other leaves."""
    from repro_torch.core import tree_to_reference

    got, want = flat_tree(tree_to_reference(port_named)), flat_tree(ref_tree)
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    floor = 1e-3 * max(float(np.abs(a).max()) for a in want.values())
    return {k: float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), floor)) for k in want}


def assert_logits_close(port, ref, dtype: str, what: str, own=None) -> None:
    """float32 within 1e-4 of the largest magnitude, bfloat16 within 6e-2
    (``test_torch_lm.py``'s tolerances) or within twice the reference's
    own spread where that is larger: ``own`` is the reference's op-by-op
    result (``jax.disable_jit``) beside its jitted ``ref``."""
    p, r = to_numpy(port), to_numpy(ref)
    assert p.shape == r.shape, what
    if not p.size:
        return
    scale = float(np.abs(r).max())
    tol = 1e-4 * scale if dtype == "float32" else 6e-2 * scale
    if own is not None:
        tol = max(tol, 2 * float(np.abs(to_numpy(own) - r).max()))
    err = float(np.abs(p - r).max())
    assert err <= tol, f"{what}: max error {err} against {tol} (largest {scale})"


def _leaf(tree, path: str):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, tuple) else tree[key]
    return tree


def extras_for(cfg, rng, b: int):
    """The family's extra inputs for ``b`` rows from ``rng``, in the model
    dtype, as ``(port's, reference's)`` dicts of the same bytes: audio
    ``frames`` (B, enc_positions, D), vlm ``patch_embeds`` (B,
    vision_tokens, D); none for the other families (nothing drawn)."""
    import jax.numpy as jnp
    import ml_dtypes

    dims = {"audio": ("frames", cfg.enc_positions), "vlm": ("patch_embeds", cfg.vision_tokens)}
    if cfg.family not in dims:
        return {}, {}
    key, n = dims[cfg.family]
    a = rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)
    a = a.astype(ml_dtypes.bfloat16) if cfg.dtype == "bfloat16" else a
    return {key: to_torch(a)}, {key: jnp.asarray(a)}


def check_forward(arch: str, dtype: str, s: int = 20, **overrides) -> None:
    """Loss and aux of ``train_loss``; the prefill's last logits and cache
    at ``cache_len`` > ``s`` and three decode steps after it; against the
    jitted reference on the same weights, tokens and extra inputs
    (``extras_for``: whisper's frames). bfloat16 logits and
    states are held within twice the reference's own spread (its path
    jitted against the same path op by op) where that exceeds 6e-2 of the
    largest: on the two-block jamba that spread reaches 0.29 of logits up
    to 3.5 (the port: 0.23), where bfloat16 Mamba activations feed 16
    sub-layers and a rounding moves MoE routing."""
    import functools

    import jax
    import jax.numpy as jnp

    rmodel, rparams, model = lm_pair(arch, dtype, **overrides)
    rng = np.random.default_rng(s)
    toks = rng.integers(0, model.cfg.vocab, (2, s)).astype(np.int32)
    labels = np.roll(toks, -1, 1)
    extras, rextras = extras_for(model.cfg, rng, 2)
    rloss, raux = jax.jit(rmodel.train_loss)(rparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
                                                       **rextras})
    loss, aux = model.train_loss({"tokens": toks, "labels": labels, **extras})
    tol = 1e-4 if dtype == "float32" else 6e-2
    np.testing.assert_allclose(float(loss), float(rloss), rtol=tol, atol=tol)
    assert sorted(aux) == sorted(raux)
    for key in aux:
        if key == "overflow":
            assert bool(aux[key]) == bool(raux[key])
        else:
            np.testing.assert_allclose(float(aux[key]), float(raux[key]), rtol=tol, atol=1e-6, err_msg=key)

    # the reference's path jitted, and (bfloat16) op by op: its own spread
    prefill = functools.partial(rmodel.prefill, cache_len=s + 8)
    nxts = [jnp.asarray(rng.integers(0, model.cfg.vocab, (2,)).astype(np.int32)) for _ in range(3)]
    runs = [[jax.jit(prefill), jax.jit(rmodel.decode_step)]]
    if dtype != "float32":
        runs.append([prefill, rmodel.decode_step])
    paths = []
    for run_prefill, run_decode in runs:
        with jax.disable_jit(run_prefill is prefill):
            out = [run_prefill(rparams, {"tokens": jnp.asarray(toks), **rextras})]
            for nxt in nxts:
                out.append(run_decode(rparams, out[-1][0], nxt)[::-1])
        paths.append(out)
    ref, own = paths[0], (paths[1] if len(paths) > 1 else [None] * 4)

    cache, logits = model.prefill({"tokens": toks, **extras}, cache_len=s + 8)
    assert logits.dtype == getattr(torch, dtype)
    rcache, rlogits = ref[0]
    assert_logits_close(logits, rlogits, dtype, "prefill", own[0] and own[0][1])
    assert int(cache["pos"]) == int(rcache["pos"]) == s - 1
    for name, value in flat_tree(rcache).items():
        got = _leaf(cache, name)
        assert tuple(got.shape) == value.shape and got.dtype == to_torch(np.asarray(_leaf(rcache, name))).dtype, name
        if name != "pos":
            assert_logits_close(got, value, dtype, f"cache {name}", own[0] and _leaf(own[0][0], name))
    for i, nxt in enumerate(nxts):
        logits, cache = model.decode_step(cache, np.array(nxt))
        assert_logits_close(logits, ref[i + 1][1], dtype, f"decode step {i}", own[i + 1] and own[i + 1][1])
        assert int(cache["pos"]) == int(ref[i + 1][0]["pos"]) == s + i


def check_gradients(arch: str, s: int = 24, **overrides) -> None:
    """float32: every gradient leaf of ``train_loss`` within 1e-4 of its
    largest magnitude in the jitted ``jax.grad``'s (the family's extra
    inputs from ``extras_for``)."""
    import jax
    import jax.numpy as jnp

    from repro_torch.optim import OptConfig
    from repro_torch.train import init_all

    rmodel, rparams, model = lm_pair(arch, "float32", **overrides)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, model.cfg.vocab, (2, s)).astype(np.int32)
    extras, rextras = extras_for(model.cfg, rng, 2)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    rbatch = {**{k: jnp.asarray(v) for k, v in batch.items()}, **rextras}
    batch.update(extras)
    (rloss, _), rgrads = jax.jit(jax.value_and_grad(lambda p: rmodel.train_loss(p, rbatch), has_aux=True))(rparams)
    params, _ = init_all(model, OptConfig())
    loss, _ = model.train_loss(batch)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    errs = leaf_errors(grads, rgrads)
    assert max(errs.values()) <= 1e-4, {k: e for k, e in errs.items() if e > 1e-4}
    np.testing.assert_allclose(loss.item(), float(rloss), rtol=1e-5)


def check_train_steps(arch: str, steps: int = 3, s: int = 16, **overrides) -> None:
    """``steps`` float32 train steps in both packages from one state (the
    reference's init and fresh AdamW state carried across), held at
    ``test_torch_train.py``'s three-step tolerances: losses and gradient
    norms at rtol 1e-5, the learning rate at 2 float32 ulps, every
    parameter within twice the steps' learning-rate sum and 999 in 1000 of
    each leaf's within 1e-5 of its largest, or 1e-3 of the learning-rate
    sum where that is larger (a leaf that starts at zero, as Mamba's
    ``conv_b``, is itself of the learning rate's size). An element whose
    first gradient is rounding noise (below 1e-3 of the largest, as
    ``leaf_errors`` floors it: mLSTM's ``b_i``, the input-gate quarter of
    sLSTM's ``b_zifo``, whose normalised read ``c / max(n, 1)`` is as
    blind to a common gate shift) takes Adam steps of about the learning
    rate in a random direction, and is held by the first bound only. The
    moments: within 1e-4 of
    each leaf's largest after the first step, 2e-4 after the last. Adam's
    first update moves each element by about the learning rate whatever
    its gradient, so elements whose gradient is rounding noise part by up
    to 2e-3, and the later gradients with them: on the two-block jamba the
    reference's own jitted and op-by-op runs of these three steps differ
    by up to 8.5e-5 of a leaf's largest first moment (MoE ``w_gate``),
    the port by up to 1.3e-4."""
    import importlib

    import jax
    import jax.numpy as jnp

    from repro_torch.core import opt_state_from_reference, tree_to_reference
    from repro_torch.optim import OptConfig
    from repro_torch.train import init_all, make_train_step

    rmodel, rparams, model = lm_pair(arch, "float32", **overrides)
    rts, ropt = importlib.import_module("repro.train.train_step"), importlib.import_module("repro.optim")
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    roc = ropt.OptConfig(**oc.__dict__)
    rstate = ropt.init_state(roc, rparams)
    params, _ = init_all(model, oc)
    state = opt_state_from_reference(jax.tree.map(np.asarray, rstate), device="cpu")
    rstep, step = rts.make_train_step(rmodel, roc, None), make_train_step(model, oc)
    rlrs = []
    for i in range(steps):
        rng = np.random.default_rng(10 + i)
        toks = rng.integers(0, model.cfg.vocab, (4, s)).astype(np.int32)
        extras, rextras = extras_for(model.cfg, rng, 4)
        batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
        rparams, rstate, rm = rstep(rparams, rstate, {**{k: jnp.asarray(v) for k, v in batch.items()}, **rextras})
        params, state, m = step(params, state, {**batch, **extras})
        assert sorted(m) == sorted(rm)
        for k in m:
            if k == "aux_overflow":
                assert bool(m[k]) == bool(rm[k])
            elif k == "lr":
                np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=2.4e-7)
            else:
                np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
        rlrs.append(float(rm["lr"]))
        if i == 0:
            first = flat_tree(rstate["m"])
            top = max(float(np.abs(a).max()) for a in first.values())
            signal = {k: np.abs(a) >= 1e-3 * top for k, a in first.items()}
        for name in ("m", "v"):
            errs = leaf_errors(state[name], rstate[name])
            tol = 1e-4 if i == 0 else 2e-4
            assert max(errs.values()) <= tol, (i, name, {k: e for k, e in errs.items() if e > tol})
    assert int(state["step"]) == steps
    bound = 2 * sum(rlrs)
    got, want = flat_tree(tree_to_reference(params)), flat_tree(rparams)
    for k in want:
        d = np.abs(got[k] - want[k])
        assert d.max() <= bound, (k, d.max())
        if signal[k].any():
            assert np.quantile(d[signal[k]], 0.999) <= max(1e-5 * np.abs(want[k]).max(), 1e-3 * sum(rlrs)), k


def check_serve(arch: str, **overrides) -> None:
    """Greedy ``serve()`` streams (float32) equal the reference engine's:
    prompts of three lengths on 2 slots, so the lanes decode at different
    depths, with budgets of 0, 1 and more, refills and an arrival."""
    r = ref_lm().serve
    from repro_torch.serve import ServeConfig, ServeEngine

    rmodel, rparams, model = lm_pair(arch, "float32", **overrides)
    kw = dict(max_new_tokens=5, temperature=0.0, eos_id=1)
    engines = (r.ServeEngine(rmodel, rparams, r.ServeConfig(**kw)), ServeEngine(model, ServeConfig(**kw)))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(5, 50, n).astype(np.int32) for n in (8, 12, 8, 16, 12)]
    late = {2: [rng.integers(5, 50, 8).astype(np.int32)]}
    outs = [[t.tolist() for t in eng.serve(prompts, slots=2, max_new=[3, 5, 1, 0, 5], arrivals=late.get)]
            for eng in engines]
    assert outs[1] == outs[0]
    assert [len(t) for t in outs[1][:5]] == [3, 5, 1, 0, 5] and len(outs[1]) == 6
    assert engines[1].refills >= 1


def check_generate(arch: str, **overrides) -> None:
    """Greedy ``generate()`` streams (float32) of one batch of prompts, with
    the family's extra inputs (``extras_for``: whisper's frames), equal the
    reference engine's."""
    import jax.numpy as jnp

    r = ref_lm().serve
    from repro_torch.serve import ServeConfig, ServeEngine

    rmodel, rparams, model = lm_pair(arch, "float32", **overrides)
    kw = dict(max_new_tokens=6, temperature=0.0, eos_id=1)
    rng = np.random.default_rng(5)
    prompts = rng.integers(5, model.cfg.vocab, (3, 10)).astype(np.int32)
    extras, rextras = extras_for(model.cfg, rng, 3)
    want = r.ServeEngine(rmodel, rparams, r.ServeConfig(**kw)).generate(jnp.asarray(prompts), extras=rextras)
    got = ServeEngine(model, ServeConfig(**kw)).generate(prompts, extras=extras)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 6)
    assert got.numpy().tolist() == np.asarray(want).tolist()


def check_resume(tmp_path, cfg) -> None:
    """``launch.train.train`` on the CPU: 3 steps with a checkpoint, then a
    resumed run to step 5, give the last two losses, the parameters and the
    optimizer state of one uninterrupted 5-step run, bit for bit."""
    from repro_torch.launch.train import train
    from repro_torch.optim import OptConfig

    kw = dict(batch=2, seq=16, opt_cfg=OptConfig(total_steps=10), device="cpu", log_every=1)
    p_full, o_full, losses = train(cfg, steps=5, ckpt_dir=None, **kw)
    train(cfg, steps=3, ckpt_dir=str(tmp_path), **kw)
    p_res, o_res, tail = train(cfg, steps=5, ckpt_dir=str(tmp_path), resume=True, **kw)
    assert tail == losses[3:]
    for k in p_full:
        assert torch.equal(p_full[k], p_res[k]), k
        assert torch.equal(o_full["m"][k], o_res["m"][k]) and torch.equal(o_full["v"][k], o_res["v"][k]), k
    assert int(o_res["step"]) == 5


def check_convert_round_trip(arch: str, **overrides) -> None:
    """``params_from_reference`` then ``tree_to_reference`` gives back the
    reference's tree, leaf for leaf and byte for byte (float32)."""
    import jax

    from repro_torch.core import tree_to_reference

    _, rparams, model = lm_pair(arch, "float32", **overrides)
    want = flat_tree(jax.tree.map(np.asarray, rparams))
    got = flat_tree(tree_to_reference(dict(model.named_parameters())))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k
