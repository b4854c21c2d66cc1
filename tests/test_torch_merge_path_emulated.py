"""K3's CUDA source, run on the CPU, against the plain window merge.

``csrc/merge_path.cu`` is compiled by the host C++ compiler against
``tests/cuda_emu/cuda_runtime.h`` (every CUDA thread a fiber of one OS thread; barriers
for ``__syncthreads`` and the warp ballots; ``cp.async`` as a plain copy),
and its C entry point is called through ``ctypes`` on CPU tensors. So both
float routes — the merge route with its network pass over the reference
spans whose windows hold -0.0 and +0.0, and the network route with the
replayed diagonals — and the integer route are held bit for bit against
``kernels/merge_path/ref.py::merge_windows`` (the JAX package's
``merge_partitioned``): ±0.0 bands that straddle a 1024 boundary, also
across two merge CTAs; NaNs of both signs in order and out of order; +inf
tails; clipped widths no multiple of a span; W = 1. The NaN flag is a byte
the kernels read: 0 takes the merge route, 1 the network route. Tolerance:
exact bytes.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.merge_path import ops as mops
from repro_torch.kernels.merge_path import ref as mref

EMU = Path(__file__).resolve().parent / "cuda_emu"
CP_ASYNC = 'asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(s), "l"(gmem) : "memory");'
CP_WAIT = 'asm volatile("cp.async.commit_group;\\ncp.async.wait_group 0;\\n" ::: "memory");'
FLOATS = (torch.float32, torch.bfloat16)
#: the NaN flag: merge route, network route
FLAGS = (0, 1)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    out = tmp_path_factory.mktemp("emu_merge")
    cuh = (_build.CSRC / "merge_path.cuh").read_text()
    assert cuh.count(CP_ASYNC) == 1 and cuh.count(CP_WAIT) == 1, "cp.async changed: update the rewrite"
    cuh = cuh.replace(CP_ASYNC, "emu_cp_async16(s, gmem);").replace(CP_WAIT, "emu_cp_async_wait();")
    (out / "merge_path.cuh").write_text(cuh)
    shutil.copy(_build.CSRC / "keys.cuh", out / "keys.cuh")
    src = (_build.CSRC / "merge_path.cu").read_text()
    src, n_smem = re.subn(r"extern __shared__ __align__\(16\) unsigned char smem\[\];",
                          "unsigned char* smem = emu_smem;", src)
    src, n_launch = re.subn(r"(\w+<[^;<>]*>)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", src, flags=re.S)
    assert (n_smem, n_launch) == (2, 4), "the kernels' launch sites changed: update the rewrite"
    (out / "merge_path.cpp").write_text(src)
    so = out / "libmerge_path_emu.so"
    build = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-Wno-unknown-pragmas",
         f"-I{out}", f"-I{EMU}", str(out / "merge_path.cpp"), "-o", str(so)],
        capture_output=True, text=True, timeout=600,
    )
    assert build.returncode == 0, build.stderr[-4000:]
    cdll = ctypes.CDLL(str(so))
    cdll.repro_merge_path.argtypes = _build.SIGNATURES["repro_merge_path"]
    cdll.repro_merge_path.restype = ctypes.c_int
    return cdll


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _merge(lib, a: torch.Tensor, b: torch.Tensor, out_w: int, flag) -> torch.Tensor:
    """The C entry point as ``merge_partitioned`` calls it, on CPU tensors;
    the output starts as a pattern no kernel writes."""
    rows, w = a.shape
    tile = min(mops.TILE, mops._pow2_at_least(w))
    span = mops.int_span(out_w)
    scratch = torch.full((max(rows * (-(-out_w // span) + 1), rows * -(-out_w // tile), 1),), -7,
                         dtype=torch.int32)
    out = _bits(torch.empty((rows, out_w), dtype=a.dtype)).fill_(0x5A5A).view(a.dtype)
    nan = None if flag is None else torch.tensor(bool(flag))
    rc = lib.repro_merge_path(a.data_ptr(), b.data_ptr(), out.data_ptr(), scratch.data_ptr(), rows, w,
                              out_w, span, tile, None if nan is None else nan.data_ptr(),
                              _build.DTYPE_CODES[a.dtype], None)
    assert rc == 0
    return out


def _check(lib, a, b, widths, flags=FLAGS):
    a, b = a.contiguous(), b.contiguous()
    tile = min(mops.TILE, mops._pow2_at_least(a.shape[1]))
    for out_w in widths:
        want = mref.merge_windows(a, b, tile, out_w)
        for flag in flags:
            got = _merge(lib, a, b, out_w, flag)
            assert torch.equal(_bits(got), _bits(want)), (a.dtype, out_w, flag)


def _stable(a: torch.Tensor, b: torch.Tensor, out_w: int) -> torch.Tensor:
    c = torch.cat([a, b], dim=1)
    return c.gather(1, torch.sort(c, dim=1, stable=True).indices)[:, :out_w]


def _zero_rows(rng, w: int, negatives, band: int, p_neg: float) -> np.ndarray:
    """Sorted NaN-free rows: ``negatives[r]`` negative keys, then a band of
    zeros whose signs are drawn (-0.0 with probability ``p_neg``), then
    positives (small integers, exact in bfloat16)."""
    x = np.empty((len(negatives), w), np.float32)
    for r, n in enumerate(negatives):
        x[r] = np.arange(w) % 200 + 1
        x[r, :n] = -(np.arange(n, 0, -1) % 200 + 1)
        x[r, n:n + band] = np.where(rng.random(band) < p_neg, -0.0, 0.0)
        x[r, n + band:] = np.sort(x[r, n + band:])
        x[r, :n] = np.sort(x[r, :n])
    return x


@pytest.mark.parametrize("dtype", FLOATS)
def test_emulated_zero_band_straddles_a_span(lib, dtype):
    """A ±0.0 band across output column 1024: a's zeros, mostly past the
    first span, of both signs; b's negatives fill the first span. The
    network's bytes differ from a stable merge here, so the merge route
    must merge those reference spans again."""
    rng = np.random.default_rng(40)
    w = 1500
    a = _zero_rows(rng, w, [30, 10, 2], 40, 0.5)
    b = _zero_rows(rng, w, [990, 1010, 1020], 0, 0.0)
    ta, tb = torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype)
    want = mref.merge_windows(ta, tb, 1024, 2 * w)
    assert not torch.equal(_bits(want), _bits(_stable(ta, tb, 2 * w))), "the case no longer needs the network"
    _check(lib, ta, tb, (2 * w, 1030, 2000))


@pytest.mark.parametrize("dtype", FLOATS)
def test_emulated_zero_past_the_span_end(lib, dtype):
    """+0.0 keys through the end of span 0's a-slice and a -0.0 right after
    it (outside the span, inside its window), in a and then in b."""
    w = 1500
    a = np.arange(w, dtype=np.float32) % 200 + 10
    a[:20] = -3.0
    a[20:30] = 0.0
    a[30] = -0.0
    a[31:] = np.sort(a[31:])
    b = np.arange(w, dtype=np.float32) % 200 + 7
    b[:1000] = -(np.arange(1000, 0, -1) % 200) - 1
    b = np.sort(b)
    for x, y in ((a, b), (b, a)):
        _check(lib, torch.from_numpy(x[None]).to(dtype), torch.from_numpy(y[None]).to(dtype),
               (2 * w, 1025))


@pytest.mark.parametrize("dtype", FLOATS)
def test_emulated_zero_window_across_two_ctas(lib, dtype):
    """Rows of 3000 merged to 6000 columns take two merge CTAs of 3328
    outputs; the reference span [3072, 4096) meets both, and its window
    holds both zeros. Each CTA writes only its own columns of it."""
    rng = np.random.default_rng(41)
    w = 3000
    assert mops.int_span(2 * w) == 3328
    a = _zero_rows(rng, w, [1500, 1450, 1600], 120, 0.5)
    b = _zero_rows(rng, w, [1580, 1700, 1400], 90, 0.3)
    _check(lib, torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype), (2 * w, 5001, 3400))


@pytest.mark.parametrize("dtype", FLOATS)
def test_emulated_random_zero_bands(lib, dtype):
    """Zero bands of random length and sign mix at random places, both sides."""
    rng = np.random.default_rng(42)
    w = 2000
    a = _zero_rows(rng, w, rng.integers(0, 1900, 3), 90, 0.6)
    b = _zero_rows(rng, w, rng.integers(0, 1900, 3), 45, 0.4)
    _check(lib, torch.from_numpy(a).to(dtype), torch.from_numpy(b).to(dtype), (2 * w, 2500, 3333))


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("order", ["in order", "out of order"])
def test_emulated_nan_rows(lib, dtype, order):
    """NaNs of both signs: sorted rows with NaN tails (in order), and NaNs
    dropped at random places into sorted rows (the bitonic tile sort can
    leave runs so). Only the network route applies: flag 1."""
    rng = np.random.default_rng(43 if order == "in order" else 44)
    w = 1300
    choice = np.asarray([-0.0, 0.0, 1.0, -1.0, 2.5, np.inf], np.float32)
    x = np.sort(choice[rng.integers(0, 6, (6, w))], axis=-1)
    if order == "in order":
        for r in range(6):
            x[r, w - 1 - r * 37:] = np.nan if r % 2 else -np.nan
    else:
        for r in range(6):
            at = rng.choice(w, 40, replace=False)
            x[r, at] = np.where(rng.random(40) < 0.5, np.nan, -np.nan)
    a, b = torch.from_numpy(x[:3]).to(dtype), torch.from_numpy(x[3:]).to(dtype)
    _check(lib, a, b, (2 * w, 1999), flags=(1,))


@pytest.mark.parametrize("dtype", FLOATS)
def test_emulated_inf_tails_and_clipped_widths(lib, dtype):
    """NaN-free sorted rows with +inf tails of random length (as the merge
    tree pads them), widths around the merge route's spans of 2816/3840."""
    rng = np.random.default_rng(45)
    w = 1921
    x = np.sort(rng.integers(-5000, 5000, (4, w)).astype(np.float32), axis=-1)
    for r, keep in enumerate(rng.integers(0, w + 1, 4)):
        x[r, keep:] = np.inf
    x[1, :] = np.inf
    a, b = torch.from_numpy(x[:2]).to(dtype), torch.from_numpy(x[2:]).to(dtype)
    _check(lib, a, b, (2815, 2817, 3841, 2 * w))


@pytest.mark.parametrize("dtype", FLOATS + (torch.int32, torch.int64))
def test_emulated_one_key_rows(lib, dtype):
    rng = np.random.default_rng(46)
    x = rng.integers(-3, 3, (6, 1))
    t = torch.from_numpy(x).to(dtype)
    if dtype.is_floating_point:
        t[0, 0], t[1, 0] = -0.0, 0.0
    _check(lib, t[:3], t[3:], (1, 2), flags=FLAGS if dtype.is_floating_point else (None,))


@pytest.mark.parametrize("dtype", (torch.int32, torch.int64))
def test_emulated_int_route(lib, dtype):
    """Integer keys with ties and sentinel tails; widths within and past one span."""
    rng = np.random.default_rng(47)
    w = 3000
    x = np.sort(rng.integers(0, 300, (4, w)), axis=-1)
    big = np.iinfo(np.int32 if dtype == torch.int32 else np.int64).max
    for r, keep in enumerate(rng.integers(0, w + 1, 4)):
        x[r, keep:] = big
    t = torch.from_numpy(x).to(dtype)
    _check(lib, t[:2], t[2:], (2 * w, 5001, 2000), flags=(None,))


def test_emulated_entry_point_rejects_bad_spans(lib):
    a = torch.zeros((2, 100), dtype=torch.float32)
    out = torch.empty((2, 200), dtype=torch.float32)
    scratch = torch.empty(16, dtype=torch.int32)

    nan = torch.tensor(False)

    def call(span, tile, dtype_code, flag=nan.data_ptr()):
        return lib.repro_merge_path(a.data_ptr(), a.data_ptr(), out.data_ptr(), scratch.data_ptr(), 2, 100,
                                    200, span, tile, flag, dtype_code, None)

    assert call(256, 128, 1) == 0
    assert call(256, 128, 1, None) != 0  # float keys need the NaN flag
    assert call(300, 128, 1) != 0  # no multiple of 256
    assert call(256 * 16, 128, 0, None) != 0  # more items than a thread merges
    assert call(256, 100, 1) != 0  # float window no power of two
    assert call(256, 64, 3) != 0  # float window below 128
    assert call(256, 64, 0, None) == 0  # integer keys have no window and no flag
