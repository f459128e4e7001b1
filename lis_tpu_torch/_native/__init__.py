"""Host C++ routing helpers, loaded with ctypes.

Port of ``lis_tpu/_native/__init__.py`` for the functions the port uses so
far: the three of the Benes shuffle routing (``euler_split``,
``greedy_color``, ``pass_idx``), the MatrixMarket coordinate parser
(``mm_parse_coords``), the level schedule of a triangular solve
(``level_schedule``), the factorisations of the preconditioners
(``iluk_factor``: CSR, level of fill k; ``ilu0_dia``: ILU(0) on the DIA
diagonals; ``ilut_factor`` and ``iluc_factor``: dual-threshold and Crout
ILU; ``sainv_factor``: the sparse A-biconjugation of SAINV) and SA-AMG's
aggregation of a strength graph (``amg_aggregate``).  The C++ source is
the port's own copy of lis_tpu's, ``lis_tpu_torch/_native/lis_native.cpp``
beside this file; it is compiled with g++ into ``build/lis_tpu_torch/`` at
the repository root on first use, and again whenever the source is newer
than the library.
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
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "lis_native.cpp")
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
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.level_schedule.restype = ctypes.c_int32
    lib.level_schedule.argtypes = [ctypes.c_int32, i32p, i32p,
                                   ctypes.c_int32, i32p]
    lib.iluk_factor.restype = ctypes.c_int
    lib.iluk_factor.argtypes = [
        ctypes.c_int32, i32p, i32p, f64p, ctypes.c_int32,
        ctypes.POINTER(i32p), ctypes.POINTER(i32p), ctypes.POINTER(f64p),
        ctypes.POINTER(ctypes.c_int64)]
    for name in ("ilut_factor", "iluc_factor"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_int32, i32p, i32p, f64p, ctypes.c_double,
            ctypes.c_double, ctypes.POINTER(i32p), ctypes.POINTER(i32p),
            ctypes.POINTER(f64p), ctypes.POINTER(ctypes.c_int64)]
    lib.sainv_factor.restype = ctypes.c_int
    lib.sainv_factor.argtypes = [
        ctypes.c_int32, i32p, i32p, f64p, ctypes.c_double,
        ctypes.POINTER(i32p), ctypes.POINTER(i32p), ctypes.POINTER(f64p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(i32p), ctypes.POINTER(i32p), ctypes.POINTER(f64p),
        ctypes.POINTER(ctypes.c_int64), f64p]
    lib.amg_aggregate.restype = ctypes.c_int32
    lib.amg_aggregate.argtypes = [ctypes.c_int32, i32p, i32p, i32p]
    lib.ilu0_dia.restype = ctypes.c_int
    lib.ilu0_dia.argtypes = [ctypes.c_int64, ctypes.c_int32, i64p, f64p]
    lib.lis_native_free.restype = None
    lib.lis_native_free.argtypes = [ctypes.c_void_p]
    lib.mm_parse_coords.restype = ctypes.c_int64
    lib.mm_parse_coords.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_int32, i32p,
                                    i32p, ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return lib


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


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


def mm_parse_coords(path: str, skip_lines: int, nnz: int, pattern: bool):
    """Parse ``nnz`` coordinate lines of a MatrixMarket file after
    ``skip_lines`` header lines: (rows, cols, vals) with 0-based int32
    indices and float64 values (ones for a pattern file), or None without
    the native library or when the file holds fewer well-formed lines."""
    lib = _load()
    if lib is None:
        return None
    rows = np.empty(nnz, dtype=np.int32)
    cols = np.empty(nnz, dtype=np.int32)
    vals = np.empty(nnz, dtype=np.float64)
    got = lib.mm_parse_coords(
        path.encode(), skip_lines, nnz, 1 if pattern else 0, _i32p(rows),
        _i32p(cols), _f64p(vals))
    if got != nnz:
        return None
    return rows, cols, vals


def level_schedule(ptr, index, lower: bool):
    """Levels of a strictly triangular CSR (lower: rows ascending, else
    descending): (nlev, lev) with lev[i] = 1 + max(lev[deps of i]), or None
    without the native library."""
    lib = _load()
    if lib is None:
        return None
    n = len(ptr) - 1
    ptr = np.ascontiguousarray(ptr, dtype=np.int32)
    index = np.ascontiguousarray(index, dtype=np.int32)
    lev = np.zeros(n, dtype=np.int32)
    nlev = lib.level_schedule(n, _i32p(ptr), _i32p(index),
                              1 if lower else 0, _i32p(lev))
    return int(nlev), lev


def _csr_in(ptr, index, value):
    """Contiguous int32 / float64 copies (where needed) of CSR arrays."""
    return (np.ascontiguousarray(ptr, dtype=np.int32),
            np.ascontiguousarray(index, dtype=np.int32),
            np.ascontiguousarray(value, dtype=np.float64))


def _take_csr(lib, n, optr, oidx, oval, nnz):
    """Copy a CSR that the library allocated into numpy, then free it."""
    out = (np.ctypeslib.as_array(optr, shape=(n + 1,)).copy(),
           np.ctypeslib.as_array(oidx, shape=(nnz,)).copy(),
           np.ctypeslib.as_array(oval, shape=(nnz,)).copy())
    for p in (optr, oidx, oval):
        lib.lis_native_free(p)
    return out


def _factor(name, ptr, index, value, *params):
    """Run one of the combined-LU factorisations: its CSR arrays, or None
    without the native library or on failure."""
    lib = _load()
    if lib is None:
        return None
    n = len(ptr) - 1
    ptr, index, value = _csr_in(ptr, index, value)
    i32p = ctypes.POINTER(ctypes.c_int32)
    optr, oidx, oval = i32p(), i32p(), ctypes.POINTER(ctypes.c_double)()
    nnz = ctypes.c_int64()
    rc = getattr(lib, name)(n, _i32p(ptr), _i32p(index), _f64p(value),
                            *params, ctypes.byref(optr), ctypes.byref(oidx),
                            ctypes.byref(oval), ctypes.byref(nnz))
    if rc != 0:
        return None
    return _take_csr(lib, n, optr, oidx, oval, nnz.value)


def iluk_factor(ptr, index, value, fill: int):
    """ILU(k) of a real CSR: combined-LU CSR arrays (L strictly lower with
    the factors, U upper with its diagonal), or None without the native
    library or on failure."""
    return _factor("iluk_factor", ptr, index, value, int(fill))


def ilut_factor(ptr, index, value, drop: float, rate: float):
    """Dual-threshold ILUT of a real CSR (reference lis_precon_ilut.c:67):
    combined-LU CSR arrays, or None."""
    return _factor("ilut_factor", ptr, index, value, float(drop),
                   float(rate))


def iluc_factor(ptr, index, value, drop: float, rate: float):
    """Crout ILU of a real CSR (reference lis_precon_iluc.c:67):
    combined-LU CSR arrays, or None."""
    return _factor("iluc_factor", ptr, index, value, float(drop),
                   float(rate))


def sainv_factor(ptr, index, value, tol: float):
    """Sparse stabilised A-biconjugation of a real CSR (reference
    lis_precon_create_sainv_csr, lis_precon_sainv.c:59):
    ((zptr, zidx, zval), (wptr, widx, wval), dinv) with Z and W as
    row-wise CSR, or None."""
    lib = _load()
    if lib is None:
        return None
    n = len(ptr) - 1
    ptr, index, value = _csr_in(ptr, index, value)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    zp, zi, zv = i32p(), i32p(), f64p()
    wp, wi, wv = i32p(), i32p(), f64p()
    znnz, wnnz = ctypes.c_int64(), ctypes.c_int64()
    dinv = np.zeros(n, dtype=np.float64)
    rc = lib.sainv_factor(n, _i32p(ptr), _i32p(index), _f64p(value),
                          float(tol), ctypes.byref(zp), ctypes.byref(zi),
                          ctypes.byref(zv), ctypes.byref(znnz),
                          ctypes.byref(wp), ctypes.byref(wi),
                          ctypes.byref(wv), ctypes.byref(wnnz), _f64p(dinv))
    if rc != 0:
        return None
    return (_take_csr(lib, n, zp, zi, zv, znnz.value),
            _take_csr(lib, n, wp, wi, wv, wnnz.value), dinv)


def amg_aggregate(ptr, index):
    """Greedy independent-set aggregation of a strength graph (SA-AMG
    set-up; reference lis_m_aggregate_mod.F90:45): (nagg, agg), or None
    without the native library."""
    lib = _load()
    if lib is None:
        return None
    n = len(ptr) - 1
    ptr = np.ascontiguousarray(ptr, dtype=np.int32)
    index = np.ascontiguousarray(index, dtype=np.int32)
    agg = np.empty(n, dtype=np.int32)
    nagg = lib.amg_aggregate(n, _i32p(ptr), _i32p(index), _i32p(agg))
    return int(nagg), agg


def ilu0_dia(offsets, diags):
    """ILU(0) on DIA storage: a float64 copy of the (nnd, n) diagonals,
    factored in place into combined LU (the L factors at negative offsets,
    U with its diagonal at the others).  None without the native library
    or without a main diagonal."""
    lib = _load()
    if lib is None:
        return None
    d = np.array(diags, dtype=np.float64, order="C", copy=True)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    rc = lib.ilu0_dia(d.shape[1], d.shape[0], _i64p(offs), _f64p(d))
    return d if rc == 0 else None
