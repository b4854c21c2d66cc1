"""K1 and K4's CUDA source, run on the CPU, against the plain networks.

``csrc/bitonic_sort.cu`` is compiled by the host C++ compiler against
``tests/cuda_emu/cuda_runtime.h``, which runs every CUDA thread as an OS
thread (barriers for ``__syncthreads`` and the warp shuffles), and its C
entry points are called through ``ctypes`` on CPU tensors. So the kernels'
schedule — registers, lane shuffles, the shared-memory layouts and their
barriers, the direction flips, the integer and float key codecs — is held
here bit for bit against ``kernels/bitonic/ref.py`` (the TPU network stage
by stage) at every schedule the widths up to 4096 take: one warp or less
per row (128 .. 1024), and one CTA per row with one and two wide stages
(2048, 4096). The card runs the same checks at every width up to 16384
(``test_torch_kernels.py::test_kernels_match_plain_on_card``,
``chip_smoke.py``). Tolerance: exact bytes.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitonic import ops as bops  # noqa: F401  (imports the core first)
from repro_torch.kernels.bitonic import ref as bref

EMU = Path(__file__).resolve().parent / "cuda_emu"
WIDTHS = (128, 256, 512, 1024, 2048, 4096)
KEY_DTYPES = (torch.int32, torch.uint32, torch.float32, torch.bfloat16)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the emulated kernels")
    src = (_build.CSRC / "bitonic_sort.cu").read_text()
    src, n_smem = re.subn(r"extern __shared__ __align__\(16\) unsigned char smem_raw\[\];",
                          "unsigned char* smem_raw = emu_smem;", src)
    src, n_launch = re.subn(r"(\w+<[^;<>]*>)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", src)
    assert (n_smem, n_launch) == (2, 2), "the kernels' launch sites changed: update the rewrite"
    out = tmp_path_factory.mktemp("emu")
    (out / "bitonic_sort.cpp").write_text(src)
    so = out / "libbitonic_emu.so"
    build = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-Wno-unknown-pragmas",
         f"-I{EMU}", str(out / "bitonic_sort.cpp"), "-o", str(so)],
        capture_output=True, text=True, timeout=600,
    )
    assert build.returncode == 0, build.stderr[-4000:]
    cdll = ctypes.CDLL(str(so))
    for name in ("repro_bitonic_sort_rows", "repro_bitonic_sort_kv_rows"):
        fn = getattr(cdll, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return cdll


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _keys(dtype, rows: int, w: int, seed: int, ties: bool) -> torch.Tensor:
    """Wide keys, or heavy ties; float keys with -0.0/+0.0 runs and NaNs of
    both signs; uint32 keys above 2^31 and the sentinel."""
    g = torch.Generator().manual_seed(seed)
    if ties:
        x = torch.randint(0, 50, (rows, w), generator=g)
        if dtype.is_floating_point:
            return torch.tensor([-0.0, 0.0, 1.5, -2.0, float("nan")])[x % 5].to(dtype)
        return (x.int() * 100_000_000).view(torch.uint32) if dtype == torch.uint32 else x.int()
    x = torch.randint(-(2**30), 2**30, (rows, w), generator=g)
    if dtype == torch.uint32:
        x = x.int() * 2
        x[0, :5] = -1
        return x.view(torch.uint32)
    if not dtype.is_floating_point:
        return x.int()
    x = x.float()
    x[0, : w // 3] = -0.0
    x[0, w // 6 : w // 2] = 0.0
    x[1, ::7] = float("nan")
    x[1, 3::11] = -float("nan")
    return x.to(dtype)


def _sort_rows(lib, x: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    rc = lib.repro_bitonic_sort_rows(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                                     _build.DTYPE_CODES[x.dtype], None)
    assert rc == 0
    return out


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("dtype", KEY_DTYPES)
def test_emulated_k1_matches_network(lib, dtype, width):
    rows = 3 if width <= 1024 else 2
    x = _keys(dtype, rows, width, width, ties=False)
    assert torch.equal(_bits(_sort_rows(lib, x)), _bits(bref.sort_tiles(x)))


@pytest.mark.parametrize("width", (128, 1024, 4096))
@pytest.mark.parametrize("value_dtype", (torch.int16, torch.int32, torch.int64))
@pytest.mark.parametrize("dtype", KEY_DTYPES)
def test_emulated_k4_matches_network(lib, dtype, value_dtype, width):
    rows = 3 if width <= 1024 else 2
    keys = _keys(dtype, rows, width, width + 1, ties=True)
    g = torch.Generator().manual_seed(width)
    vals = torch.randperm(rows * width, generator=g).reshape(rows, width).to(value_dtype)
    ko, vo = torch.empty_like(keys), torch.empty_like(vals)
    rc = lib.repro_bitonic_sort_kv_rows(keys.data_ptr(), vals.data_ptr(), ko.data_ptr(),
                                        vo.data_ptr(), rows, width, _build.DTYPE_CODES[keys.dtype],
                                        vals.element_size(), None)
    assert rc == 0
    rk, rv = bref.sort_kv_tiles(keys, vals)
    assert torch.equal(_bits(ko), _bits(rk)) and torch.equal(_bits(vo), _bits(rv))


@pytest.mark.parametrize("rows,width", [(65, 128), (9, 1024), (17, 512)])
def test_emulated_k1_rows_past_a_block(lib, rows, width):
    """The one-warp kernel's last CTA holds fewer rows than it has room for."""
    for dtype in (torch.int32, torch.float32):
        x = _keys(dtype, rows, width, rows, ties=False)
        assert torch.equal(_bits(_sort_rows(lib, x)), _bits(bref.sort_tiles(x)))


def test_emulated_entry_points_reject_bad_tiles(lib):
    x = torch.zeros((2, 100), dtype=torch.int32)
    out = torch.empty_like(x)
    assert lib.repro_bitonic_sort_rows(x.data_ptr(), out.data_ptr(), 2, 100, 0, None) != 0
    assert lib.repro_bitonic_sort_rows(x.data_ptr(), out.data_ptr(), 1, 32768, 0, None) != 0
    assert lib.repro_bitonic_sort_kv_rows(x.data_ptr(), x.data_ptr(), out.data_ptr(), out.data_ptr(),
                                          1, 128, 0, 3, None) != 0
