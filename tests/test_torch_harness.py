"""Parity harness between the JAX package (the reference) and the PyTorch port.

:func:`reference` imports the JAX package lazily, inside a test, never at
collection: the installed jax no longer has ``jax.experimental.enable_x64``,
which ``repro/core/segmented.py`` imports, so the loader first points that
name at ``jax.enable_x64``. Collection of every other test module is
unchanged. Inputs are made with numpy from a seed and handed to both.
"""
from __future__ import annotations

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
    ``layers``, ``attention``, ``moe`` and ``transformer`` modules),
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
                 transformer="repro.models.transformer", serve="repro.serve", engine="repro.serve.engine",
                 data="repro.data")
    return types.SimpleNamespace(**{k: importlib.import_module(m) for k, m in names.items()})


def lm_pair(arch: str, dtype: str = "bfloat16", seed: int = 0):
    """The reduced ``arch`` in ``dtype`` in both packages with the same
    weights: ``(reference Model, its params, port Model on the CPU)``, the
    reference's ``init(key(seed))`` carried across by
    ``params_from_reference``."""
    import dataclasses

    import jax

    from repro_torch.core import params_from_reference
    from repro_torch.models import Model

    r = ref_lm()
    cfg = dataclasses.replace(r.configs.get_arch(arch).reduced(), dtype=dtype)
    rmodel = r.models.Model(cfg)
    rparams = rmodel.init(jax.random.key(seed))
    tree = jax.tree.map(np.asarray, rparams)
    return rmodel, rparams, Model(port_config(cfg), device="cpu", params=params_from_reference(tree, device="cpu"))


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
