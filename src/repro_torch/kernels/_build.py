"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` source is compiled for ``sm_90a`` (one ``nvcc`` process
per source, all started together) and linked into one shared library with
a plain C interface under ``build/repro_torch/`` at the repository root.
The library's name carries a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is loaded as it is. Nothing is
built at import: the first wrapper that receives a CUDA tensor calls
:func:`load`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: key dtype codes shared with the C entry points (``csrc/*.cu``).
DTYPE_CODES = {torch.int32: 0, torch.float32: 1, torch.uint32: 2, torch.bfloat16: 3, torch.int64: 4}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: C entry point -> argument types; every entry returns a cudaError_t as int.
SIGNATURES = {
    # in, out, rows, width, dtype, stream
    "repro_bitonic_sort_rows": [_P, _P, _I64, _I, _I, _P],
    # keys in, values in, keys out, values out, rows, width, key dtype,
    # value bytes, stream
    "repro_bitonic_sort_kv_rows": [_P, _P, _P, _P, _I64, _I, _I, _I, _P],
    # data, n, queries, query procs|NULL, proc tag, query idxs|NULL, query
    # row stride (S, or 0 for one row broadcast), row procs|NULL, S, B, row
    # flags (B int32 scratch), out, dtype, stream
    "repro_splitter_ranks": [_P, _I64, _P, _P, _I, _P, _I64, _P, _I64, _I64, _P, _P, _I, _P],
    # a, b, out, int32 scratch (splits | diagonals), rows, width, a's row
    # stride, b's row stride (in keys), out_width, span, tile, NaN flag
    # (device byte)|NULL, dtype, stream
    "repro_merge_path": [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I, _I, _P, _I, _P],
}

_lock = threading.Lock()
_lib = None


class LaunchCounter:
    """Launches of one kernel, counted by its wrapper where it launches."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.n = 0


#: kernel name -> its wrapper's launch counter
COUNTERS: Dict[str, LaunchCounter] = {}


def counter(name: str) -> LaunchCounter:
    return COUNTERS.setdefault(name, LaunchCounter(name))


def reset_counts() -> None:
    for c in COUNTERS.values():
        c.n = 0


def counts() -> Dict[str, int]:
    return {name: c.n for name, c in COUNTERS.items()}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not nvcc or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return nvcc


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_{_digest()}.so"


def build() -> Path:
    """Compile every source in parallel and link one library (cached)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}_{out.stem}"
    jobs = []
    for src in sources():
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        log = BUILD_DIR / f"{src.stem}_{tag}.log"
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=fh, stderr=subprocess.STDOUT,
            )
        jobs.append((src, obj, log, proc))
    failed = []
    for src, _, log, proc in jobs:
        if proc.wait() != 0:
            failed.append(f"{src.name}:\n{log.read_text()}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    with open(BUILD_DIR / f"build_{out.stem}.log", "w") as fh:
        for src, _, log, _ in jobs:
            fh.write(f"== {src.name}\n{log.read_text()}")
    tmp = BUILD_DIR / f"{out.stem}_{tag}.so.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *[str(o) for _, o, _, _ in jobs]],
        capture_output=True, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)
    for _, obj, log, _ in jobs:
        obj.unlink(missing_ok=True)
        log.unlink(missing_ok=True)
    return out


def build_log() -> str:
    """The compiler's ``-Xptxas -v`` report of the current build."""
    path = BUILD_DIR / f"build_{library_path().stem}.log"
    return path.read_text() if path.exists() else ""


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use, with typed entry points."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def dtype_code(t, allowed=tuple(DTYPE_CODES)) -> int:
    """The C code of a key tensor's dtype; raises for one the kernel lacks."""
    if t.dtype not in allowed:
        names = ", ".join(str(d).replace("torch.", "") for d in allowed)
        raise TypeError(f"no kernel for dtype {t.dtype} (this kernel takes {names})")
    return DTYPE_CODES[t.dtype]


def check_cuda(t, name: str) -> None:
    """A tensor a kernel may take: on a CUDA device and contiguous."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_rows(t, name: str) -> int:
    """A (rows, W) tensor a row-strided kernel may take: on a CUDA device,
    each row's keys adjacent, rows apart by at least W. Returns the row
    stride in elements."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    rows, width = t.shape
    stride = t.stride(0) if rows > 1 else width
    if (width > 1 and t.stride(1) != 1) or stride < width:
        raise ValueError(f"{name} must hold each row's keys adjacent, rows at least a row apart; "
                         f"got strides {t.stride()} for shape {tuple(t.shape)}")
    return stride


def check_launch(lib: ctypes.CDLL, rc: int, kernel: str) -> None:
    """Raise if the C entry point reported a CUDA error for its launch."""
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed ({rc}: {msg})")


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream
