"""Host C++ routing helpers, loaded with ctypes.

Port of ``lis_tpu/_native/__init__.py`` for the three functions the Benes
shuffle routing needs (``euler_split``, ``greedy_color``, ``pass_idx``).
There is one copy of the C++ source: ``lis_tpu/_native/lis_native.cpp``
is read by path (never imported — importing ``lis_tpu`` pulls in JAX) and
compiled with g++ into ``build/lis_tpu_torch/`` at the repository root on
first use, and again whenever the source is newer than the library.
Without a compiler every function returns None and the caller takes its
pure-Python fallback, as in lis_tpu.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "lis_tpu", "_native", "lis_native.cpp")
_BUILD = os.path.join(_ROOT, "build", "lis_tpu_torch")
_SO = os.path.join(_BUILD, f"lis_native_{sys.implementation.cache_tag}.so")

_lib = None


def _build() -> bool:
    os.makedirs(_BUILD, exist_ok=True)
    # build under a private name, then rename: concurrent test workers
    # never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           _SRC, "-o", tmp]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if r.returncode != 0:
        return False
    os.replace(tmp, _SO)
    return True


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_SRC):
        return None
    if (not os.path.exists(_SO)
            or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.euler_split.restype = ctypes.c_int
    lib.euler_split.argtypes = [ctypes.c_int64, i64p, i64p, ctypes.c_int64,
                                ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]
    lib.greedy_color.restype = ctypes.c_int64
    lib.greedy_color.argtypes = [ctypes.c_int64, i64p, i64p, ctypes.c_int64,
                                 ctypes.c_int32, i32p]
    lib.pass_idx.restype = ctypes.c_int
    lib.pass_idx.argtypes = [ctypes.c_int64, i64p, i64p, ctypes.c_int64,
                             ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                             i32p]
    _lib = lib
    return lib


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def euler_split(u, v, nu: int, nv: int):
    """One Euler-orientation split of an even-regular bipartite multigraph
    (edges u[i]->v[i]): a 0/1 bit per edge such that every node's incident
    edges split exactly in half.  None without the native library."""
    lib = _load()
    if lib is None:
        return None
    u = np.ascontiguousarray(u, dtype=np.int64)
    v = np.ascontiguousarray(v, dtype=np.int64)
    bit = np.empty(len(u), dtype=np.uint8)
    lib.euler_split(len(u), _i64p(u), _i64p(v), nu, nv,
                    bit.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return bit


def greedy_color(left, right, n_nodes: int, d: int):
    """Sequential greedy proper edge coloring with d <= 128 colors.
    Returns (fails, color) or None without the native library."""
    lib = _load()
    if lib is None:
        return None
    left = np.ascontiguousarray(left, dtype=np.int64)
    right = np.ascontiguousarray(right, dtype=np.int64)
    color = np.empty(len(left), dtype=np.int32)
    fails = lib.greedy_color(len(left), _i64p(left), _i64p(right), n_nodes,
                             d, _i32p(color))
    return int(fails), color


def pass_idx(pos_before, pos_after, d: int, s: int, M: int,
             exact_holes: bool):
    """Lane gather table of one Benes pass, (M/128, 128) int32, or None
    without the native library (numpy fallback in the caller)."""
    lib = _load()
    if lib is None:
        return None
    pb = np.ascontiguousarray(pos_before, dtype=np.int64)
    pa = np.ascontiguousarray(pos_after, dtype=np.int64)
    idx = np.empty(M, dtype=np.int32)
    rc = lib.pass_idx(len(pb), _i64p(pb), _i64p(pa), d, s, M,
                      1 if exact_holes else 0, _i32p(idx))
    return idx.reshape(M // 128, 128) if rc == 0 else None
