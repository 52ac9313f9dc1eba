"""Build, load and count the hand-written CUDA kernels in ``csrc/``.

The kernels are plain CUDA C++ behind a C interface: each ``csrc/*.cu`` is
compiled by its own ``nvcc`` (all started together) for ``sm_90a`` and the
objects are linked into one shared library, loaded with ``ctypes``.  The
build happens at first use, from the sources in this package only, into
``build/repro_torch_kernels/<digest>/`` at the repository root (listed in
``.gitignore``); the digest covers the sources and the flags, so an edited
source rebuilds and an unchanged one loads the existing library.

Nothing here runs at import: the CPU-only test host has no ``nvcc``.

Every wrapper counts its launches in :data:`LAUNCHES` (one per call that
launches its kernel, nowhere else), so a run can show that its main path
went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path

import torch

__all__ = ["LAUNCHES", "library", "build", "check", "stream_ptr",
           "BUILD_ROOT", "SOURCES"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = sorted(CSRC.glob("*.cu"))
HEADERS = sorted(CSRC.glob("*.cuh"))
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# no --use_fast_math; -Xptxas -v writes each kernel's registers, shared
# memory and spills into the build log
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "libcoconut_kernels.so"

LAUNCHES: Counter = Counter()

_LOCK = threading.Lock()
_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "coconut_mindist_batch": [_P] * 5 + [_I, _LL, _I, _I, _F] + [_I] * 3
    + [_P],
    "coconut_euclid_cross": [_P, _P, _P] + [_I] * 8 + [_P],
    "coconut_euclid_gather": [_P, _P, _P, _P, _I, _LL, _I, _P],
    "coconut_scan_verify": [_P] * 14 + [_I] * 6 + [_F] + [_I] * 4 + [_P, _P],
    "coconut_fused_build": [_P] * 5 + [_LL, _I, _I, _I, _I, _I, _P],
    "coconut_sax_summarize": [_P] * 4 + [_LL, _I, _I, _I, _I, _P],
    "coconut_zorder": [_P, _P, _LL] + [_I] * 5 + [_P],
    "coconut_unpack_mindist": [_P] * 5 + [_I, _LL, _I, _I, _I, _I, _F]
    + [_I] * 3 + [_P],
    "coconut_pool_merge": [_P] * 11 + [_I] * 5 + [_P],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit (CUDA_HOME or /usr/local/cuda)")


def _digest() -> str:
    h = hashlib.sha256()
    for p in SOURCES + HEADERS:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH + FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every source (one ``nvcc`` each, run in parallel) and link
    the shared library; returns its path.  A library already built from
    the same sources and flags is reused."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    nvcc = _nvcc()
    tmp = out_dir.with_name(f"{out_dir.name}.tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in SOURCES:
        obj = tmp / f"{src.stem}.o"
        cmd = [nvcc, *ARCH, *FLAGS, "-c", str(src), "-o", str(obj)]
        log = open(tmp / f"{src.stem}.log", "w")
        procs.append((src, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(src.name)
    if failed:
        logs = "\n".join((tmp / f"{Path(n).stem}.log").read_text()
                         for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    objs = [str(tmp / f"{s.stem}.o") for s in SOURCES]
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp / LIB_NAME),
                           *objs], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}"
                           f"{link.stderr}")
    try:
        tmp.rename(out_dir)
    except OSError:           # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.coconut_error_string.argtypes = [ctypes.c_int]
            lib.coconut_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(name: str, rc: int) -> None:
    """Raise when a C entry point returned a non-zero ``cudaError_t``."""
    if rc != 0:
        msg = library().coconut_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """The common CUDA device of ``tensors``; raises when one is elsewhere."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


def require(name: str, t: torch.Tensor, dtype: torch.dtype, ndim: int) -> None:
    """Type, rank and contiguity check before a pointer goes to a kernel."""
    if t.dtype != dtype or t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {ndim}-d {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")
