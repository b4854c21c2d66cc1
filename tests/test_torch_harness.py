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
