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
