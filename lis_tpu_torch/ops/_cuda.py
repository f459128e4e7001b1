"""Build and bind the port's hand-written CUDA kernels.

Every ``lis_tpu_torch/csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, which is
loaded with ctypes.  The build happens at first use, into
``build/lis_tpu_torch/`` at the repository root, and again whenever a
source is newer than the library.  Nothing here runs at import time: the
CPU test tier imports every module on a machine without nvcc.

Calling convention of every C entry point: device pointers and the CUDA
stream (``torch.cuda.current_stream().cuda_stream``) travel as
``c_void_p``; sizes as ``c_int64``; flags as ``c_int``.  The entry
returns ``cudaGetLastError()`` after its launch and ``launch`` raises when
that is not ``cudaSuccess`` — a refused launch (too much shared memory, a
bad grid) never runs, and a later synchronize would not report it.

While a ``torch.profiler`` records, ``launch`` counts ``launch.calls`` and
both ``check`` and ``launch`` add their host time to ``launch.host_ns``
(``utils/trace.py``'s counters); otherwise they read one flag.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import time

import torch
from torch.autograd import profiler as _profiler

from lis_tpu_torch.utils import trace as _trace

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
    "lis_lane_shuffle": [_INT, _P, _P, _P, _I64, _I64, _P],
    "lis_dia_spmv": [_INT, _INT, _P, _P, _P, _P, _I64, _I64, _I64, _P],
    "lis_dia_spmvh": [_INT, _INT, _P, _P, _P, _P, _I64, _I64, _I64, _P],
    "lis_krylov_dot": [_INT, _P, _P, _P, _I64, _P, _INT, _P, _P],
    "lis_cg_direction": [_INT, _P, _P, _P, _P, _I64, _P, _INT, _P, _P, _P],
    "lis_cg_update": [_INT, _P, _P, _P, _P, _P, _I64, _P, _P, _P, _INT, _P,
                      _P, _INT, _P],
    "lis_cg_finish": [_INT, _P, _INT, _P, _P, _P, _INT, _P],
    "lis_dia_relax": [_INT, _INT, _INT, _INT, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I64, _I64, _P],
    "lis_trisolve_levels": [_INT, _INT, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I64, _I64, _I64, _P, _P],
    "lis_lattice_prolong": [_INT, _INT, _P, _P, _P, _P, _P, _P, _I64, _I64,
                            _I64, _P],
    "lis_lattice_restrict": [_INT, _INT, _P, _P, _P, _P, _P, _I64, _I64,
                             _I64, _P],
    "lis_dd_dia_spmv": [_INT, _INT, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                        _I64, _P],
    "lis_dd_ell_spmv": [_INT, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                        _I64, _I64, _P],
    "lis_dd_reduce": [_INT, _INT, _P, _P, _P, _P, _I64, _I64, _I64, _I64,
                      _P, _P],
    "lis_dd_update": [_INT, _INT, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P],
    "lis_ddcg_direction": [_INT, _P, _P, _P, _P, _P, _I64, _P, _P, _P],
    "lis_ddcg_pq": [_INT, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _P, _P,
                    _P, _P],
    "lis_ddcg_update": [_INT, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64,
                        _I64, _I64, _I64, _P, _P, _P, _P, _P, _INT, _P],
    "lis_ddcg_resident": [_INT, _P],
    "lis_bes_spmv": [_INT, _INT, _INT, _P, _P, _P, _P, _P, _P, _P, _I64,
                     _I64, _I64, _I64, _I64, _I64, _I64, _P],
    "lis_bes_spmvh": [_INT, _INT, _INT, _P, _P, _P, _P, _P, _P, _P, _I64,
                      _I64, _I64, _I64, _I64, _I64, _I64, _P],
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
    os.makedirs(_BUILD, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    tmp = f"{_SO}.{pid}.tmp"
    t0 = time.perf_counter()
    # one nvcc per source, all started together, then one link
    jobs = []
    for src in [s for s in _sources() if s.endswith(".cu")]:
        obj = os.path.join(_BUILD, f"{os.path.basename(src)}.{pid}.o")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
               "-I", _CSRC, "-c", src, "-o", obj]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    logs, failed = [], []
    for obj, p in jobs:
        logs.append(p.communicate()[0])
        if p.returncode != 0:
            failed.append(p.returncode)
    objs = [obj for obj, _ in jobs]
    if not failed:
        r = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True)
        logs.append(r.stdout + r.stderr)
        if r.returncode != 0:
            failed.append(r.returncode)
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{build_log}")
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
    t0 = time.perf_counter_ns() if _profiler._is_profiler_enabled else None
    handle = lib()
    rc = getattr(handle, name)(*args)
    if t0 is not None:
        _trace.count("launch.host_ns", time.perf_counter_ns() - t0)
        _trace.count("launch.calls")
    if rc != 0:
        msg = handle.lis_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# the complex codes serve lane_shuffle, which moves whole elements, the DIA
# and BES products, the DIA sweeps and the triangular solve
DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.complex64: 2,
              torch.complex128: 3}


def check(t: torch.Tensor, name: str, dtype=None, numel=None,
          aligned: bool = True) -> None:
    """Validate a kernel operand: CUDA, contiguous, dtype, size and, for
    the kernels that load 16 B vectors, ``aligned``."""
    t0 = time.perf_counter_ns() if _profiler._is_profiler_enabled else None
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.is_conj() or t.is_neg():
        # a lazy view: the data pointer holds the values before it
        raise ValueError(f"{name}: resolve the conj/neg view first")
    if dtype is not None and t.dtype not in (
            dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name}: dtype {t.dtype} not supported "
                         f"(expected {dtype})")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name}: {t.numel()} elements, expected {numel}")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
    if t0 is not None:
        _trace.count("launch.host_ns", time.perf_counter_ns() - t0)
