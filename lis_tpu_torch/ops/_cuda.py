"""Build and bind the port's hand-written CUDA kernels.

Every ``lis_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, which is
loaded with ctypes.  The build happens at first use, into
``build/lis_tpu_torch/`` at the repository root, and again whenever a
source is newer than the library.  Nothing here runs at import time: the
CPU test tier imports every module on a machine without nvcc.

Calling convention of every C entry point: device pointers and the CUDA
stream (``torch.cuda.current_stream().cuda_stream``) travel as
``c_void_p``; sizes as ``c_int64``; flags as ``c_int``.  The entry returns
``cudaGetLastError()`` after its launch and ``launch`` raises when that is
not ``cudaSuccess`` — a refused launch (too much shared memory, a bad
grid) never runs, and a later synchronize would not report it.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CSRC = os.path.join(_ROOT, "lis_tpu_torch", "csrc")
_BUILD = os.path.join(_ROOT, "build", "lis_tpu_torch")
_SO = os.path.join(_BUILD, "liblis_tpu_torch_kernels.so")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int

# C entry point -> argument types (all return int: a cudaError_t)
_SIGNATURES = {
    "lis_cst_front": [_INT, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P],
    "lis_benes_pass": [_INT, _P, _P, _P, _I64, _I64, _P],
    "lis_benes_pass_rowsum": [_INT, _P, _P, _P, _I64, _I64, _I64, _P],
    "lis_benes_small_run": [_INT, _P, _P, _P, _INT, _P, _I64, _INT, _P],
}

_lib = None
build_seconds = None        # wall time of the last nvcc run in this process
build_log = ""              # nvcc's output (ptxas register/smem report)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "lis_tpu_torch build only where the CUDA "
                           "toolkit is installed")
    return path


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(_CSRC, "*.cu"))
                  + glob.glob(os.path.join(_CSRC, "*.cuh")))


def _stale() -> bool:
    if not os.path.exists(_SO):
        return True
    built = os.path.getmtime(_SO)
    return any(os.path.getmtime(s) > built for s in _sources())


def build() -> str:
    """Compile the kernels if the library is missing or stale; return its
    path.  Raises on a compiler error, with nvcc's output."""
    global build_seconds, build_log
    if not _stale():
        return _SO
    import time
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-I", _CSRC, "-o", tmp,
           *[s for s in _sources() if s.endswith(".cu")]]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{build_log}")
    os.replace(tmp, _SO)
    return _SO


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        so = build()
        handle = ctypes.CDLL(so)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.lis_cuda_error_string.argtypes = [ctypes.c_int]
        handle.lis_cuda_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def launch(name: str, *args) -> None:
    """Call C entry ``name`` and raise if its launch failed."""
    handle = lib()
    rc = getattr(handle, name)(*args)
    if rc != 0:
        msg = handle.lis_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def check(t: torch.Tensor, name: str, dtype=None, numel=None) -> None:
    """Validate a kernel operand: CUDA, contiguous, dtype, size, aligned."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if dtype is not None and t.dtype not in (
            dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name}: dtype {t.dtype} not supported "
                         f"(expected {dtype})")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name}: {t.numel()} elements, expected {numel}")
    if t.data_ptr() % 16:          # the kernels load 16 B vectors
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
