"""Handle-based flat API backing the Fortran/C binding shim.

Port of ``lis_tpu/interop/fapi.py``.  Reference: the Fortran 77/90
interface is a layer of C wrappers (src/fortran/lisf_*.c, e.g.
lisf_solver.c, lisf_init.F:1-51) converting pass-by-reference arguments
and integer handles onto the C API.  Here the same role is played by this module (integer handles onto
``lis_tpu_torch.compat`` objects) plus ``_native/lisf_tpu.c`` (a C shim
with Fortran calling conventions — trailing-underscore symbols, all
arguments by reference, hidden string lengths — that embeds the
interpreter; ``lis_tpu_torch._native.lisf`` builds it).

A C caller cannot pass ``device="cpu"``: ``initialize`` reads the
environment variable ``LIS_TPU_TORCH_DEVICE`` and, where it is set, makes
that device the default (``set_default_device``).  Unset, the device is
the card, with no fallback.

Indices are 0-based like the reference's Fortran interface.
"""

from __future__ import annotations

import numpy as np

from lis_tpu_torch import compat as c

_handles: dict[int, object] = {}
_next_handle = [1]


def _put(obj) -> int:
    h = _next_handle[0]
    _next_handle[0] += 1
    _handles[h] = obj
    return h


def _get(h: int):
    return _handles[int(h)]


def _drop(h: int):
    _handles.pop(int(h), None)


# ---- lifecycle --------------------------------------------------------------

def initialize() -> int:
    """lis_initialize for an embedding host process: capture the host's
    command line (the Fortran side has no argc/argv to pass — the
    reference's lisf_init.F rebuilds it from iargc/getarg; here we read
    /proc/self/cmdline) so *_set_optionC sees the program's options.
    ``LIS_TPU_TORCH_DEVICE``, where set, names the default device."""
    import os
    from lis_tpu_torch import config
    argv: list[str] = []
    try:
        with open("/proc/self/cmdline", "rb") as f:
            argv = [a.decode() for a in f.read().split(b"\0") if a][1:]
    except OSError:
        pass
    device = os.environ.get("LIS_TPU_TORCH_DEVICE")
    if device:
        config.set_default_device(device)
    config.initialize(argv)
    return 0


def finalize() -> int:
    from lis_tpu_torch import config
    config.finalize()
    _handles.clear()
    return 0


# ---- matrix -----------------------------------------------------------------

def matrix_create(comm: int) -> int:
    return _put(c.lis_matrix_create(comm))


def matrix_destroy(h: int) -> int:
    _drop(h)
    return 0


def matrix_set_size(h: int, local_n: int, global_n: int) -> int:
    return c.lis_matrix_set_size(_get(h), local_n, global_n)


def matrix_set_type(h: int, mtype: int) -> int:
    return c.lis_matrix_set_type(_get(h), mtype)


def matrix_set_value(flag: int, i: int, j: int, value: float, h: int) -> int:
    return c.lis_matrix_set_value(flag, i, j, value, _get(h))


def matrix_assemble(h: int) -> int:
    return c.lis_matrix_assemble(_get(h))


# ---- vector -----------------------------------------------------------------

def vector_create(comm: int) -> int:
    return _put(c.lis_vector_create(comm))


def vector_destroy(h: int) -> int:
    _drop(h)
    return 0


def vector_set_size(h: int, local_n: int, global_n: int) -> int:
    return c.lis_vector_set_size(_get(h), local_n, global_n)


def vector_set_all(alpha: float, h: int) -> int:
    return c.lis_vector_set_all(alpha, _get(h))


def vector_set_value(flag: int, i: int, value: float, h: int) -> int:
    return c.lis_vector_set_value(flag, i, value, _get(h))


def vector_get_value(h: int, i: int) -> float:
    return float(c.lis_vector_get_value(_get(h), i))


def vector_nrm2(h: int) -> float:
    return float(c.lis_vector_nrm2(_get(h)))


# ---- solver -----------------------------------------------------------------

def solver_create() -> int:
    return _put(c.lis_solver_create())


def solver_destroy(h: int) -> int:
    _drop(h)
    return 0


def solver_set_option(text: str, h: int) -> int:
    return c.lis_solver_set_option(text, _get(h))


def solve(ha: int, hb: int, hx: int, hs: int) -> int:
    return int(c.lis_solve(_get(ha), _get(hb), _get(hx), _get(hs)))


def solver_get_iter(h: int) -> int:
    return int(c.lis_solver_get_iter(_get(h)))


def solver_get_residualnorm(h: int) -> float:
    return float(c.lis_solver_get_residualnorm(_get(h)))


def solver_get_status(h: int) -> int:
    return int(c.lis_solver_get_status(_get(h)))


# ---- eigensolver ------------------------------------------------------------

def esolver_create() -> int:
    return _put(c.lis_esolver_create())


def esolver_destroy(h: int) -> int:
    _drop(h)
    return 0


def esolver_set_option(text: str, h: int) -> int:
    return c.lis_esolver_set_option(text, _get(h))


def esolve(ha: int, hx: int, he: int) -> float:
    """Runs the eigensolve and returns the principal eigenvalue."""
    status, evalue = c.lis_esolve(_get(ha), _get(hx), _get(he))
    return float(evalue)


def esolver_get_iter(h: int) -> int:
    return int(c.lis_esolver_get_iter(_get(h)))


# ---- file I/O -----------------------------------------------------------------

def input(ha: int, hb: int, hx: int, filename: str) -> int:
    """lis_input: read matrix (+ optional b/x) from file; hb/hx may be 0."""
    return c.lis_input(_get(ha),
                       None if hb == 0 else _get(hb),
                       None if hx == 0 else _get(hx), filename)


def input_matrix(ha: int, filename: str) -> int:
    return c.lis_input_matrix(_get(ha), filename)


def input_vector(hv: int, filename: str) -> int:
    return c.lis_input_vector(_get(hv), filename)


def output_vector(hv: int, fmt: int, filename: str) -> int:
    return c.lis_output_vector(_get(hv), fmt, filename)


def solver_output_rhistory(hs: int, filename: str) -> int:
    return c.lis_solver_output_rhistory(_get(hs), filename)


def esolver_output_rhistory(he: int, filename: str) -> int:
    return c.lis_esolver_output_rhistory(_get(he), filename)


# ---- matrix extras ------------------------------------------------------------

def matrix_get_n(h: int) -> int:
    return int(c.lis_matrix_get_size(_get(h))[0])


def matrix_get_gn(h: int) -> int:
    return int(c.lis_matrix_get_size(_get(h))[1])


def matrix_get_range_is(h: int) -> int:
    # Fortran binding semantics: 1-based (lisf_matrix.c shifts +1)
    return int(c.lis_matrix_get_range(_get(h))[0]) + 1


def matrix_get_range_ie(h: int) -> int:
    return int(c.lis_matrix_get_range(_get(h))[1]) + 1


def matrix_get_nnz(h: int) -> int:
    return int(c.lis_matrix_get_nnz(_get(h)))


def matrix_duplicate(h: int) -> int:
    return _put(c.lis_matrix_duplicate(_get(h)))


def matrix_convert(hin: int, hout: int) -> int:
    return c.lis_matrix_convert(_get(hin), _get(hout))


def matrix_set_csr(nnz: int, ptr_addr: int, index_addr: int, value_addr: int,
                   h: int) -> int:
    """lis_matrix_set_csr from raw Fortran arrays: addresses of the
    caller-owned LIS_INTEGER ptr/index and LIS_SCALAR value buffers."""
    import ctypes
    A = _get(h)
    n = A.n
    ptr = np.ctypeslib.as_array(
        ctypes.cast(ptr_addr, ctypes.POINTER(ctypes.c_long)), (n + 1,))
    index = np.ctypeslib.as_array(
        ctypes.cast(index_addr, ctypes.POINTER(ctypes.c_long)), (int(nnz),))
    value = np.ctypeslib.as_array(
        ctypes.cast(value_addr, ctypes.POINTER(ctypes.c_double)), (int(nnz),))
    return c.lis_matrix_set_csr(int(nnz), ptr.copy(), index.copy(),
                                value.copy(), A)


def matvec(ha: int, hx: int, hy: int) -> int:
    return c.lis_matvec(_get(ha), _get(hx), _get(hy))


# ---- vector extras ------------------------------------------------------------

def vector_duplicate(h: int) -> int:
    """Duplicate from a vector handle OR a matrix handle (the reference
    accepts both; lis_vector_duplicate on a matrix sizes by its rows)."""
    obj = _get(h)
    if hasattr(obj, "matrix_type"):          # matrix handle: size from rows
        v = c.lis_vector_create(obj.comm)
        c.lis_vector_set_size(v, 0, obj.n)
        return _put(v)
    return _put(c.lis_vector_duplicate(obj))


def vector_is_null(h: int) -> int:
    return c.lis_vector_is_null(_get(h))


def vector_dot(hu: int, hv: int) -> float:
    return float(c.lis_vector_dot(_get(hu), _get(hv)))


def vector_print(h: int) -> int:
    return c.lis_vector_print(_get(h))


def vector_conjugate(h: int) -> int:
    return c.lis_vector_conjugate(_get(h))


# ---- solver extras ------------------------------------------------------------

def solver_set_optionC(h: int) -> int:
    return c.lis_solver_set_optionC(_get(h))


def solver_get_iter_double(h: int) -> int:
    return int(c.lis_solver_get_iterex(_get(h))[1])


def solver_get_iter_quad(h: int) -> int:
    return int(c.lis_solver_get_iterex(_get(h))[2])


def solver_get_time(h: int) -> float:
    return float(c.lis_solver_get_timeex(_get(h))[0])


def solver_get_itime(h: int) -> float:
    return float(c.lis_solver_get_timeex(_get(h))[1])


def solver_get_ptime(h: int) -> float:
    return float(c.lis_solver_get_timeex(_get(h))[2])


def solver_get_solver(h: int) -> int:
    return int(c.lis_solver_get_solver(_get(h)))


def solver_get_solvername(nsol: int) -> str:
    return str(c.lis_solver_get_solvername(nsol))


# ---- esolver extras -----------------------------------------------------------

def esolver_set_optionC(h: int) -> int:
    return c.lis_esolver_set_optionC(_get(h))


def esolver_get_residualnorm(h: int) -> float:
    return float(c.lis_esolver_get_residualnorm(_get(h)))


def esolver_get_time(h: int) -> float:
    return float(c.lis_esolver_get_timeex(_get(h))[0])


def esolver_get_esolver(h: int) -> int:
    return int(c.lis_esolver_get_esolver(_get(h)))


def esolver_get_esolvername(nsol: int) -> str:
    return str(c.lis_esolver_get_esolvername(nsol))


# ---- dense array ops on raw Fortran buffers ------------------------------------

def _dbuf(addr: int, n: int):
    import ctypes
    return np.ctypeslib.as_array(
        ctypes.cast(int(addr), ctypes.POINTER(ctypes.c_double)), (int(n),))


def array_set_all(n: int, alpha: float, a_addr: int) -> int:
    return c.lis_array_set_all(n, alpha, _dbuf(a_addr, n))


def array_matvec(n: int, a_addr: int, x_addr: int, y_addr: int,
                 flag: int) -> int:
    return c.lis_array_matvec(n, _dbuf(a_addr, n * n), _dbuf(x_addr, n),
                              _dbuf(y_addr, n), flag)


def array_solve(n: int, a_addr: int, b_addr: int, x_addr: int,
                w_addr: int) -> int:
    return c.lis_array_solve(n, _dbuf(a_addr, n * n), _dbuf(b_addr, n),
                             _dbuf(x_addr, n), _dbuf(w_addr, n * n))


def array_xpay(n: int, x_addr: int, alpha: float, y_addr: int) -> int:
    return c.lis_array_xpay(n, _dbuf(x_addr, n), alpha, _dbuf(y_addr, n))


def array_nrm2(n: int, x_addr: int) -> float:
    return float(c.lis_array_nrm2(n, _dbuf(x_addr, n)))


# ---- PSD: decoupled precon/solver (test8f.F90; src/fortran/lisf_precon.c) ---

def solver_set_matrix(ha: int, hs: int) -> int:
    return c.lis_solver_set_matrix(_get(ha), _get(hs))


def precon_create(hs: int) -> int:
    """lis_precon_psd_create → new precon handle (0 on failure)."""
    try:
        return _put(c.lis_precon_psd_create(_get(hs)))
    except Exception:
        return 0


def precon_psd_update(hs: int, hp: int) -> int:
    return c.lis_precon_psd_update(_get(hs), _get(hp))


def precon_destroy(hp: int) -> int:
    _drop(hp)
    return 0


def solve_kernel(ha: int, hb: int, hx: int, hs: int, hp: int) -> int:
    return c.lis_solve_kernel(_get(ha), _get(hb), _get(hx), _get(hs),
                              _get(hp))


def matrix_psd_set_value(flag: int, i: int, j: int, value: float,
                         ha: int) -> int:
    return c.lis_matrix_psd_set_value(flag, i, j, value, _get(ha))


def matrix_psd_reset_scale(ha: int) -> int:
    return c.lis_matrix_psd_reset_scale(_get(ha))


def vector_psd_reset_scale(hv: int) -> int:
    return c.lis_vector_psd_reset_scale(_get(hv))
