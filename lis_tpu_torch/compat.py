"""Classic Lis-style imperative API (lis.h compatibility layer).

Port of ``lis_tpu/compat.py``.  Mirrors the reference's C calling
convention (include/lis.h: vector ops :824-859, matrix ops :865-914,
solvers :961-984, eigensolvers :990-1013) so code written against Lis
ports line by line:

    import lis_tpu_torch.compat as lis
    lis.lis_initialize([])
    A = lis.lis_matrix_create(0)
    lis.lis_matrix_set_size(A, 0, n)
    for i, j, v in entries:
        lis.lis_matrix_set_value(lis.LIS_INS_VALUE, i, j, v, A)
    lis.lis_matrix_set_type(A, lis.LIS_MATRIX_CSR)
    lis.lis_matrix_assemble(A)
    b, x = lis.lis_vector_create(0), lis.lis_vector_create(0)
    lis.lis_vector_set_size(b, 0, n); lis.lis_vector_set_all(1.0, b)
    lis.lis_vector_set_size(x, 0, n)
    solver = lis.lis_solver_create()
    lis.lis_solver_set_option("-i cg -p jacobi -tol 1e-12", solver)
    lis.lis_solve(A, b, x, solver)
    iters = lis.lis_solver_get_iter(solver)

Handles are thin mutable wrappers over the functional core; "destroy"
calls are no-ops kept for source compatibility (memory is managed).

Matrices and vectors live on the default device, the card, unless
``set_default_device`` names another: ``lis_vector_set_size`` allocates
float64 zeros there and ``lis_matrix_assemble`` builds there.  A vector's
tensor is never written in place (``lis_vector_copy`` and
``lis_matrix_copy`` share storage, as lis_tpu's immutable arrays do).
Per-element writes (``lis_vector_set_value``) go to a host copy of the
vector, made at the first write, so a loop over n entries costs no launch
and no host-to-device copy per call; the next device read of the vector
copies it to the device once.  Reads of single entries see the host copy.
"""

from __future__ import annotations

import numpy as np
import torch

from lis_tpu_torch.config import (LIS_SUCCESS, LIS_FAILS, LIS_ILL_OPTION,
                                  LIS_BREAKDOWN, LIS_OUT_OF_MEMORY,
                                  LIS_MAXITER, LIS_ERR_NOT_IMPLEMENTED,
                                  LIS_ERR_FILE_IO, LIS_ERR_ILL_ARG,
                                  default_device)
from lis_tpu_torch.config import initialize as lis_initialize    # noqa: F401
from lis_tpu_torch.config import finalize as lis_finalize        # noqa: F401
from lis_tpu_torch.config import wtime as lis_wtime              # noqa: F401
from lis_tpu_torch.matrix.assembly import (LIS_INS_VALUE,        # noqa: F401
                                           LIS_ADD_VALUE)
from lis_tpu_torch.matrix.base import host
from lis_tpu_torch.runtime.options import STORAGE_NAMES


def lis_date(date=None):
    """Current date string (man lis_date.3; lis_time.c:120).  The C API
    fills a caller buffer; here the string is returned (and also written
    into ``date`` when a mutable list is passed)."""
    import datetime
    s = datetime.datetime.now().strftime("%a %b %d %H:%M:%S %Y")
    if isinstance(date, list):
        date[:] = [s]
    return s


def lis_do_not_handle_mpi():
    """No-op (lis_init.c:99): there is no MPI to skip initialising."""
    return None


def lis_free(p):
    """No-op (lis_memory.c): memory is garbage-collected in this
    runtime; provided so ported reference code runs unchanged."""
    return None


def lis_free2(n, *ps):
    """No-op multi-free (lis_memory.c lis_free2)."""
    return None


# storage-type constants (include/lis.h:252-284)
LIS_MATRIX_CSR = 1
LIS_MATRIX_CSC = 2
LIS_MATRIX_MSR = 3
LIS_MATRIX_DIA = 4
LIS_MATRIX_ELL = 5
LIS_MATRIX_JAD = 6
LIS_MATRIX_BSR = 7
LIS_MATRIX_BSC = 8
LIS_MATRIX_VBR = 9
LIS_MATRIX_COO = 10
LIS_MATRIX_DNS = 11
_TYPE_NAMES = {i: n for n, i in STORAGE_NAMES.items()}


class _MatrixHandle:
    def __init__(self, comm=0):
        self.comm = comm
        self.n = None
        self.matrix_type = LIS_MATRIX_CSR
        self._asm = None
        self._csr = None           # (ptr, index, value) direct-set path
        self.m = None              # assembled format object


class _VectorHandle:
    """A vector: a tensor on its device (``value``), or, after a
    per-element write, a host copy (``_host``) that holds the newest
    entries until the next read of ``value`` copies it to the device."""

    def __init__(self, comm=0):
        self.comm = comm
        self.n = None
        self._dev = None
        self._host = None
        self._device = None

    @property
    def value(self):
        if self._host is not None:
            self._dev = torch.from_numpy(self._host).to(self._device)
            self._host = None
        return self._dev

    @value.setter
    def value(self, t):
        self._dev, self._host = t, None
        if isinstance(t, torch.Tensor):
            self._device = t.device

    def staged(self) -> np.ndarray:
        """The host copy that takes per-element writes (made from the
        device tensor at the first write after a device read)."""
        if self._host is None:
            self._host = self._dev.to("cpu", copy=True).numpy()
            self._dev = None
        return self._host


def _host_copy(t) -> np.ndarray:
    """A host array of tensor ``t`` that shares no memory with it."""
    return t.to("cpu", copy=True).numpy()


def _on_device(v, a):
    """``a`` (a host array or a tensor) as a tensor on the device of
    vector handle ``v`` (the default device when ``v`` holds nothing)."""
    dev = v._device if v._device is not None else default_device()
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


class _SolverHandle:
    def __init__(self):
        self.options = ""
        self.result = None


class _EsolverHandle:
    def __init__(self):
        self.options = ""
        self.result = None


# ---- matrix (lis.h:865-914) -------------------------------------------------

def lis_matrix_create(comm=0):
    """Allocate a matrix handle (man lis_matrix_create.3)."""
    return _MatrixHandle(comm)


def lis_matrix_destroy(A):
    """Release a matrix handle (man lis_matrix_destroy.3)."""
    return LIS_SUCCESS


def lis_matrix_set_size(A, local_n, global_n):
    """Set local/global dimension and open assembly (man lis_matrix_set_size.3)."""
    A.n = int(global_n or local_n)
    from lis_tpu_torch.matrix.assembly import MatrixAssembler
    A._asm = MatrixAssembler((A.n, A.n))
    return LIS_SUCCESS


def lis_matrix_get_size(A):
    """(local_n, global_n) of the matrix (man lis_matrix_get_size.3)."""
    return A.n, A.n


def lis_matrix_set_type(A, matrix_type):
    """Declare the storage type used at assemble time (man lis_matrix_set_type.3)."""
    A.matrix_type = int(matrix_type)
    return LIS_SUCCESS


def lis_matrix_get_type(A):
    """Declared storage type id (man lis_matrix_get_type.3)."""
    return A.matrix_type


def lis_matrix_set_value(flag, i, j, value, A):
    """Insert (LIS_INS_VALUE) or accumulate (LIS_ADD_VALUE) A[i,j] (man lis_matrix_set_value.3)."""
    A._asm.set_value(flag, int(i), int(j), value)
    return LIS_SUCCESS


def lis_matrix_set_csr(nnz, ptr, index, value, A):
    """Adopt caller-owned CSR arrays as the matrix storage (man lis_matrix_set_csr.3)."""
    A._csr = (np.array(ptr), np.array(index), np.array(value))
    return LIS_SUCCESS


def lis_matrix_assemble(A):
    """Finalize assembly: build the storage object in the requested type (man lis_matrix_assemble.3)."""
    from lis_tpu_torch.matrix.csr import CSRMatrix
    from lis_tpu_torch.matrix.coo import COOMatrix
    from lis_tpu_torch.matrix.convert import convert_matrix
    if A._csr is not None:
        ptr, index, value = A._csr
        m = CSRMatrix.from_csr_arrays(ptr, index, value, (A.n, A.n))
    elif getattr(A, "_triplets", None) is not None:
        rows, cols, vals = A._triplets
        m = COOMatrix.from_arrays(rows, cols, vals, (A.n, A.n))
    else:
        m = A._asm.assemble("csr")
    name = _TYPE_NAMES.get(A.matrix_type, "csr")
    kw = {}
    if name in ("bsr", "bsc") and getattr(A, "_block", None):
        kw["bnr"] = A._block[0]
    if name == "vbr" and getattr(A, "_vbr_parts", None) is not None:
        rp, cp = A._vbr_parts
        kw["row_part"] = tuple(int(t) for t in rp)
        kw["col_part"] = tuple(int(t) for t in cp)
    A.m = convert_matrix(m, name, **kw) if name != "csr" else (
        m if isinstance(m, CSRMatrix) else convert_matrix(m, "csr"))
    return LIS_SUCCESS


def lis_matrix_convert(Ain, Aout):
    """Convert Ain's storage into Aout's declared type, honoring a
    block size / VBR partition declared on Aout via
    lis_matrix_set_blocksize (man lis_matrix_convert.3)."""
    from lis_tpu_torch.matrix.convert import convert_matrix
    name = _TYPE_NAMES.get(Aout.matrix_type, "csr")
    kw = {}
    if name in ("bsr", "bsc") and getattr(Aout, "_block", None):
        kw["bnr"] = Aout._block[0]
    if name == "vbr" and getattr(Aout, "_vbr_parts", None) is not None:
        rp, cp = Aout._vbr_parts
        kw["row_part"] = tuple(int(t) for t in rp)
        kw["col_part"] = tuple(int(t) for t in cp)
    Aout.n = Ain.n
    Aout.m = convert_matrix(Ain.m, name, **kw)
    return LIS_SUCCESS


def lis_matrix_get_diagonal(A, d):
    """Copy diag(A) into vector d (man lis_matrix_get_diagonal.3)."""
    d.value = A.m.get_diagonal()
    d.n = A.n
    return LIS_SUCCESS


# ---- vector (lis.h:824-859) -------------------------------------------------

def lis_vector_create(comm=0):
    """Allocate a vector handle (man lis_vector_create.3)."""
    return _VectorHandle(comm)


def lis_vector_destroy(v):
    """Release a vector handle (man lis_vector_destroy.3)."""
    return LIS_SUCCESS


def lis_vector_set_size(v, local_n, global_n=0):
    """Set the vector dimension and allocate float64 zeros on the default
    device (man lis_vector_set_size.3)."""
    v.n = int(global_n or local_n)
    v.value = torch.zeros(v.n, dtype=torch.float64, device=default_device())
    return LIS_SUCCESS


def _dtype(v) -> torch.dtype:
    """The element type of vector handle ``v``, read without moving it."""
    if v._host is not None:
        return torch.from_numpy(v._host[:0]).dtype
    return v._dev.dtype


def lis_vector_duplicate(vin, _cls=None):
    """New zero vector with vin's size/layout (man lis_vector_duplicate.3)."""
    v = _VectorHandle(vin.comm)
    v.n = vin.n
    v.value = torch.zeros(vin.n, dtype=_dtype(vin), device=vin._device)
    return v


def lis_vector_set_all(alpha, v):
    """Fill v with alpha (man lis_vector_set_all.3)."""
    has = v._dev is not None or v._host is not None
    v.value = torch.full((v.n,), alpha,
                         dtype=_dtype(v) if has else torch.float64,
                         device=v._device if has else default_device())
    return LIS_SUCCESS


def lis_vector_set_value(flag, i, value, v):
    """Insert or accumulate v[i] (man lis_vector_set_value.3).  The write
    goes to the vector's host copy (see the module docstring)."""
    h = v.staged()
    i = int(i)
    h[i] = value + h[i] if flag == LIS_ADD_VALUE else value
    return LIS_SUCCESS


def lis_vector_get_value(v, i):
    """Read v[i] (man lis_vector_get_value.3)."""
    if v._host is not None:
        return complex_or_float(v._host[int(i)])
    return complex_or_float(v.value[int(i)])


def lis_vector_get_values(v, start, count):
    """Read count entries starting at start (man lis_vector_get_values.3)."""
    s, c = int(start), int(count)
    if v._host is not None:
        return v._host[s:s + c].copy()
    return _host_copy(v.value[s:s + c])


def lis_vector_nrm2(v):
    """2-norm of v (man lis_vector_nrm2.3)."""
    from lis_tpu_torch.core import vector as _v
    return float(_v.nrm2(v.value))


def _common(u, w):
    """Tensors ``u`` and ``w`` promoted to one element type."""
    t = torch.promote_types(u.dtype, w.dtype)
    return u.to(t), w.to(t)


def lis_vector_dot(u, v):
    """Hermitian inner product <u, v> — conj on u for complex
    (man lis_vector_dot.3)."""
    from lis_tpu_torch.core import vector as _v
    return complex_or_float(_v.dot(*_common(u.value, v.value)))


def lis_vector_axpy(alpha, x, y):
    """y := alpha x + y (man lis_vector_axpy.3)."""
    y.value = y.value + alpha * x.value
    return LIS_SUCCESS


def lis_vector_scale(alpha, x):
    """x := alpha x (man lis_vector_scale.3)."""
    x.value = alpha * x.value
    return LIS_SUCCESS


def lis_vector_copy(src, dst):
    """dst := src (man lis_vector_copy.3)."""
    dst.value = src.value
    dst.n = src.n
    return LIS_SUCCESS


# ---- matvec (lis.h:920-921) -------------------------------------------------

def lis_matvec(A, x, y):
    """y := A x (man lis_matvec.3)."""
    y.value = A.m.matvec(x.value)
    y.n = A.n
    return LIS_SUCCESS


def lis_matvech(A, x, y):
    """y := A^H x — transpose (conjugate) product (man lis_matvech.3)."""
    y.value = A.m.matvech(x.value)
    y.n = A.n
    return LIS_SUCCESS


# ---- solver (lis.h:961-984) -------------------------------------------------

def lis_solver_create():
    """Allocate a solver workspace handle (man lis_solver_create.3)."""
    return _SolverHandle()


def lis_solver_destroy(s):
    """Release a solver handle (man lis_solver_destroy.3)."""
    return LIS_SUCCESS


def lis_solver_set_option(text, solver):
    """Append option text (e.g. \"-i gmres -p ilu\") to the solver (man lis_solver_set_option.3)."""
    solver.options = (solver.options + " " + text).strip()
    return LIS_SUCCESS


def lis_solver_set_optionC(solver):
    """Append the command-line options captured at initialize (man lis_solver_set_optionc.3)."""
    from lis_tpu_torch import config as C
    solver.options = (solver.options + " "
                      + " ".join(C.get_cmd_args())).strip()
    return LIS_SUCCESS


def lis_solve(A, b, x, solver):
    """Solve Ax = b with the solver's options; x holds the solution (man lis_solve.3)."""
    from lis_tpu_torch.solvers.driver import solve
    res = solve(A.m, b.value, x0=x.value, options=solver.options or None)
    solver.result = res
    x.value = res.x
    x.n = A.n
    return res.status


def lis_solver_get_iter(solver):
    """Iteration count of the last solve (man lis_solver_get_iter.3)."""
    return solver.result.iters


def lis_solver_get_iterex(solver):
    """Iteration counts (total, double, quad) of the last solve (man lis_solver_get_iterex.3)."""
    r = solver.result
    return r.iters, r.iters, 0


def lis_solver_get_time(solver):
    """Wall-clock time of the last solve (man lis_solver_get_time.3)."""
    return solver.result.time


def lis_solver_get_timeex(solver):
    """Phase timers (total, itime, ptime, ...) of the last solve (man lis_solver_get_timeex.3)."""
    r = solver.result
    return r.time, r.itime, r.ptime, 0.0, 0.0


def lis_solver_get_residualnorm(solver):
    """Relative residual norm reached by the last solve (man lis_solver_get_residualnorm.3)."""
    return solver.result.resid


def lis_solver_get_rhistory(solver, v=None):
    """Per-iteration residual history of the last solve (man lis_solver_get_rhistory.3)."""
    rh = solver.result.rhistory
    if v is not None:
        v.value = _on_device(v, rh)
        v.n = len(rh)
        return LIS_SUCCESS
    return rh


def lis_solver_get_status(solver):
    """Status code of the last solve (man lis_solver_get_status.3)."""
    return solver.result.status


def lis_solver_get_solver(solver):
    """Numeric id of the solver that ran (man lis_solver_get_solver.3)."""
    return solver.result.options.solver_id


def lis_solver_get_solvername(nsol):
    """Solver name for a numeric id (man lis_solver_get_solvername.3)."""
    from lis_tpu_torch.runtime.options import SOLVER_NAMES
    return SOLVER_NAMES[int(nsol) - 1]


# ---- PSD: Preconditioner and Solver Decoupled (test8f.F90 workflow) ---------
#
# The reference decouples precon construction from the solve so a factored
# preconditioner can be reused/refreshed across repeated solves on a matrix
# whose VALUES change but whose structure does not (lis_precon_psd_create /
# lis_precon_psd_update, src/precon/lis_precon.c; lis_solve_kernel,
# src/solver/lis_solver.c:440).  The reference implements the psd hooks only
# for ILU(k) and SA-AMG; here every registered preconditioner rebuilds
# cleanly, because construction was functional to begin with.

class _PreconHandle:
    def __init__(self):
        self.M = None
        self.precon_type = "none"


def lis_solver_set_matrix(A, solver):
    """Bind A to the solver for PSD precon construction
    (lisf_solver.c: lis_solver_set_matrix_f)."""
    solver.A = A
    return LIS_SUCCESS


def _psd_build(solver, precon):
    from lis_tpu_torch.runtime.options import SolverOptions
    from lis_tpu_torch.precon.base import PRECON_REGISTRY, NonePrecon, create_precon
    from lis_tpu_torch.solvers.driver import transform_operator
    opts = SolverOptions.from_string(solver.options or None)
    A = getattr(solver, "A", None)
    if A is None or A.m is None:
        return LIS_ERR_ILL_ARG
    precon.precon_type = opts.precon
    if opts.precon == "none":
        precon.M = NonePrecon()
    else:
        if opts.precon not in PRECON_REGISTRY:
            return LIS_ERR_NOT_IMPLEMENTED
        # factor the operator lis_solve_kernel will actually iterate on
        # (same scaling upgrades + storage conversion) — factors built on
        # the raw matrix would mismatch e.g. I+S's forced Jacobi scaling
        Ak = transform_operator(A.m, opts)
        precon.M = create_precon(opts.precon, Ak, opts)
        if opts.adds:
            from lis_tpu_torch.precon.ads import wrap_additive_schwarz
            precon.M = wrap_additive_schwarz(Ak, precon.M, opts)
    return LIS_SUCCESS


def lis_precon_psd_create(solver, precon=None):
    """Create the preconditioner from the solver's bound matrix + options,
    without solving (lis_precon_psd_create, lis_precon.c)."""
    precon = precon if precon is not None else _PreconHandle()
    err = _psd_build(solver, precon)
    if err:
        raise RuntimeError(f"lis_precon_psd_create failed (status {err})")
    return precon


def lis_precon_psd_update(solver, precon):
    """Re-factor the preconditioner after lis_matrix_psd_set_value updates
    (lis_precon_psd_update, lis_precon.c)."""
    return _psd_build(solver, precon)


def lis_precon_destroy(precon):
    """Release a PSD preconditioner handle (man lis_precon_destroy.3)."""
    precon.M = None
    return LIS_SUCCESS


def lis_solve_kernel(A, b, x, solver, precon):
    """lis_solve with an externally supplied preconditioner
    (lis_solve_kernel, src/solver/lis_solver.c:440)."""
    from lis_tpu_torch.solvers.driver import solve
    res = solve(A.m, b.value, x0=x.value, options=solver.options or None,
                M=precon.M)
    solver.result = res
    x.value = res.x
    x.n = A.n
    return res.status


def lis_matrix_psd_set_value(flag, i, j, value, A):
    """Update a value inside the ASSEMBLED structure — the structure must
    already contain (i, j) (lis_matrix_psd_set_value_csr,
    src/matrix/lis_matrix_csr.c; CSR only in the reference too)."""
    import dataclasses
    from lis_tpu_torch.matrix.csr import CSRMatrix
    if not isinstance(A.m, CSRMatrix):
        return LIS_ERR_NOT_IMPLEMENTED
    ptr, index, val = A.m.to_csr_arrays()
    lo, hi = int(ptr[i]), int(ptr[i + 1])
    rel = np.nonzero(index[lo:hi] == j)[0]   # columns need not be sorted
    if rel.size == 0:
        return LIS_ERR_ILL_ARG
    pos = lo + int(rel[0])
    newv = value if flag == LIS_INS_VALUE else val[pos] + value
    # a new value array (the old one may be shared by lis_matrix_copy),
    # and the host arrays kept beside it with the one entry changed
    hval = val.copy()
    hval[pos] = newv
    dval = A.m.value.clone()
    dval[pos] = hval[pos]
    A.m = dataclasses.replace(A.m, value=dval)
    object.__setattr__(A.m, "_host_csr", (ptr, index, hval))
    return LIS_SUCCESS


def lis_matrix_psd_reset_scale(A):
    """Clear the is_scaled flag (lis_matrix_psd_reset_scale,
    src/matrix/lis_matrix_ops.c).  solve() here scales functionally — the
    caller's matrix is never mutated — so this only resets bookkeeping."""
    A.is_scaled = False
    return LIS_SUCCESS


def lis_vector_psd_reset_scale(v):
    """Vector analogue of lis_matrix_psd_reset_scale
    (src/vector/lis_vector.c)."""
    v.is_scaled = False
    return LIS_SUCCESS


# ---- eigensolver (lis.h:990-1013) --------------------------------------------

def lis_esolver_create():
    """Allocate an eigensolver workspace handle (man lis_esolver_create.3)."""
    return _EsolverHandle()


def lis_esolver_destroy(e):
    """Release an eigensolver handle (man lis_esolver_destroy.3)."""
    return LIS_SUCCESS


def lis_esolver_set_option(text, esolver):
    """Append option text (e.g. \"-e cg -emaxiter 1000\") to the esolver (man lis_esolver_set_option.3)."""
    esolver.options = (esolver.options + " " + text).strip()
    return LIS_SUCCESS


def lis_esolve(A, x, esolver):
    """Compute the dominant eigenpair of A into x; returns (status, evalue) (man lis_esolve.3)."""
    import time as _time
    from lis_tpu_torch.esolvers.driver import esolve
    t0 = _time.perf_counter()
    res = esolve(A.m, options=esolver.options or None,
                 x0=None if x.value is None else x.value)
    esolver.time = _time.perf_counter() - t0
    esolver.result = res
    x.value = res.evector
    x.n = A.n
    return res.status, res.evalue


def lis_gesolve(A, B, x, esolver):
    """Generalized eigenproblem Ax = lambda Bx; returns (status, evalue) (man lis_gesolve.3)."""
    from lis_tpu_torch.esolvers.driver import gesolve
    res = gesolve(A.m, B.m, options=esolver.options or None,
                  x0=None if x.value is None else x.value)
    esolver.result = res
    x.value = res.evector
    x.n = A.n
    return res.status, res.evalue


def lis_esolver_get_iter(esolver):
    """Iteration count of the last esolve (man lis_esolver_get_iter.3)."""
    return esolver.result.iters


def lis_esolver_get_residualnorm(esolver):
    """Relative residual of the converged eigenpair (man lis_esolver_get_residualnorm.3)."""
    return esolver.result.resid


def lis_esolver_get_evalues(esolver, v=None):
    """All Ritz values from the last esolve (man lis_esolver_get_evalues.3)."""
    ev = esolver.result.evalues
    if ev is None:
        ev = np.asarray([esolver.result.evalue])
    if v is not None:
        v.value = _on_device(v, ev)
        v.n = len(ev)
        return LIS_SUCCESS
    return ev


def lis_esolver_get_status(esolver):
    """Status code of the last esolve (man lis_esolver_get_status.3)."""
    return esolver.result.status


# ---- I/O (lis.h:1019-1026) --------------------------------------------------

def lis_input(A, b, x, filename):
    """Read matrix (+ optional b, x) from file, auto-detecting the format (man lis_input.3)."""
    from lis_tpu_torch.io import lis_input as _inp
    m, bv, xv = _inp(filename)
    A.m = m
    A.n = m.nrows
    if b is not None and bv is not None:
        b.value = bv
        b.n = m.nrows
    if x is not None and xv is not None:
        x.value = xv
        x.n = m.nrows
    return LIS_SUCCESS


def lis_output(A, b, x, fmt, filename):
    """Write matrix (+ optional b, x) in the requested format (man lis_output.3)."""
    from lis_tpu_torch.io import lis_output as _out
    _out(filename, A.m,
         b=None if b is None else host(b.value),
         x=None if x is None else host(x.value),
         fmt="lis" if fmt in (3, "lis") else "mm")
    return LIS_SUCCESS


def lis_input_matrix(A, filename):
    """Read only the matrix from a file (lis.h:1021 lis_input_matrix)."""
    return lis_input(A, None, None, filename)


def lis_input_vector(v, filename):
    """Read a vector from file into the handle (man lis_input_vector.3)."""
    from lis_tpu_torch.io import lis_input_vector as _inpv
    v.value = _inpv(filename)
    v.n = int(v.value.shape[0])
    return LIS_SUCCESS


def lis_output_vector(v, fmt, filename):
    """Write a vector in the requested format (man lis_output_vector.3):
    LIS_FMT_PLAIN(1), LIS_FMT_MM(2), LIS_FMT_LIS(3, the '#LIS A vec'
    ascii flavor), LIS_FMT_LIS_BINARY(4, host-endian binary flavor)."""
    import sys as _sys
    from lis_tpu_torch.io import lis_output_vector as _outv
    name = {0: "plain", "plain": "plain", 1: "plain",
            3: "lis", "lis": "lis",
            4: "lisb" if _sys.byteorder == "big" else "lisl",
            "lisb": "lisb", "lisl": "lisl"}.get(fmt, "mm")
    _outv(filename, host(v.value), fmt=name)
    return LIS_SUCCESS


def lis_output_matrix(A, fmt, filename):
    """Write the matrix alone in the requested format (man lis_output_matrix.3)."""
    return lis_output(A, None, None, fmt, filename)


def lis_solver_output_rhistory(solver, filename):
    """Write the residual history one value per line
    (src/solver/lis_solver.c lis_solver_output_rhistory)."""
    rh = np.asarray(solver.result.rhistory)
    with open(filename, "w") as f:
        for r in rh:
            f.write(f"{float(r):e}\n")
    return LIS_SUCCESS


def lis_esolver_output_rhistory(esolver, filename):
    """Write the esolve residual history to a file (man lis_esolver_output_rhistory.3)."""
    rh = esolver.result.rhistory
    rh = np.asarray([] if rh is None else rh)
    with open(filename, "w") as f:
        for r in rh:
            f.write(f"{float(r):e}\n")
    return LIS_SUCCESS


# ---- matrix extras (lis.h:865-914) -------------------------------------------

def lis_matrix_get_range(A):
    """0-based [is, ie) row range, single-comm semantics — matching the
    reference's C lis_matrix_get_range (src/matrix/lis_matrix.c); the
    1-based shift belongs to the Fortran binding layer (lisf_matrix.c),
    applied in interop.fapi."""
    return 0, A.n


def lis_matrix_get_nnz(A):
    """Number of stored nonzeros (man lis_matrix_get_nnz.3)."""
    return int(A.m.nnz)


def lis_matrix_duplicate(Ain):
    """New matrix with the same size/comm, no values
    (lis_matrix_duplicate: structure only)."""
    out = _MatrixHandle(Ain.comm)
    out.n = Ain.n
    out.matrix_type = Ain.matrix_type
    return out


# ---- vector extras ------------------------------------------------------------

LIS_TRUE = 1
LIS_FALSE = 0


def lis_vector_is_null(v):
    """1 if the handle has no storage yet, else 0 (man lis_vector_is_null.3)."""
    return LIS_TRUE if v.value is None or v.n is None else LIS_FALSE


def lis_vector_print(v):
    """Print vector entries like lis_vector_print (one per line)."""
    vals = host(v.value)
    for val in vals:
        print(f"{complex(val):.6f}" if np.iscomplexobj(vals)
              else f"{float(val):.6f}")
    return LIS_SUCCESS


def lis_vector_conjugate(v):
    """v := conj(v) in place (man lis_vector_conjugate.3)."""
    from lis_tpu_torch.core import vector as _v
    v.value = _v.conjugate(v.value)
    return LIS_SUCCESS


# ---- esolver extras (lis.h:990-1013) -------------------------------------------

def lis_esolver_set_optionC(esolver):
    """Append the command-line options captured at initialize (man lis_esolver_set_optionc.3)."""
    from lis_tpu_torch import config as C
    esolver.options = (esolver.options + " "
                       + " ".join(C.get_cmd_args())).strip()
    return LIS_SUCCESS


def lis_esolver_get_iterex(esolver):
    """Iteration counts (total, double, quad) of the last esolve (man lis_esolver_get_iterex.3)."""
    r = esolver.result
    return r.iters, r.iters, 0


def lis_esolver_get_timeex(esolver):
    """Phase timers (total, precon, iteration) of the last esolve (man lis_esolver_get_timeex.3)."""
    t = getattr(esolver, "time", 0.0)
    return t, t, 0.0, 0.0, 0.0


def lis_esolver_get_esolver(esolver):
    """Numeric id of the eigensolver that ran (man lis_esolver_get_esolver.3)."""
    from lis_tpu_torch.runtime.options import EsolverOptions
    return EsolverOptions.from_string(esolver.options or None).esolver_id


def lis_esolver_get_esolvername(nsol):
    """Eigensolver name for a numeric id (man lis_esolver_get_esolvername.3)."""
    from lis_tpu_torch.runtime.options import ESOLVER_NAMES
    return ESOLVER_NAMES[int(nsol) - 1]


# ---- dense array ops (lis.h array section; src/array/lis_array.c) --------------

def lis_array_set_all(n, alpha, a):
    """Fill the first n entries of a raw array with alpha (man lis_array_set_all.3)."""
    a[:int(n)] = alpha
    return LIS_SUCCESS


def lis_array_matvec(n, a, x, y, flag):
    """y {=, +=, -=} A x for an n×n column-major dense array
    (lis_array_matvec; Fortran storage order)."""
    n = int(n)
    prod = np.asarray(a[:n * n]).reshape(n, n, order="F") @ np.asarray(x[:n])
    if flag == LIS_INS_VALUE:
        y[:n] = prod
    elif flag == LIS_ADD_VALUE:
        y[:n] += prod
    else:
        y[:n] -= prod
    return LIS_SUCCESS


def lis_array_solve(n, a, b, x, w):
    """Direct dense solve via the core array layer (lis_array_solve;
    w is the reference's workspace — kept for signature parity)."""
    from lis_tpu_torch.core import array as _arr
    n = int(n)
    x[:n] = np.asarray(_arr.solve(
        np.asarray(a[:n * n]).reshape(n, n, order="F"), np.asarray(b[:n])))
    return LIS_SUCCESS


def lis_array_xpay(n, x, alpha, y):
    """y = x + alpha*y (lis_array_xpay)."""
    n = int(n)
    y[:n] = np.asarray(x[:n]) + alpha * np.asarray(y[:n])
    return LIS_SUCCESS


def lis_array_nrm2(n, x):
    """2-norm of the first n entries of a raw array (man lis_array_nrm2.3)."""
    return float(np.linalg.norm(np.asarray(x[:int(n)])))


# ---- full lis.h surface: vector ops (lis.h:824-859) -------------------------

def lis_vector_get_size(v):
    """(local_n, global_n) of the vector (man lis_vector_get_size.3)."""
    return v.n, v.n


def lis_vector_get_range(v):
    """[is, ie) row range owned locally (man lis_vector_get_range.3)."""
    return 0, v.n


def lis_vector_set_values(flag, count, index, value, v):
    """Insert/accumulate count entries at positions index
    (man lis_vector_set_values.3)."""
    cur = v.value
    idx = _on_device(v, np.asarray(index[:int(count)], dtype=np.int64))
    val = _on_device(v, np.asarray(value[:int(count)])).to(cur.dtype)
    if flag == LIS_ADD_VALUE:
        v.value = cur.index_add(0, idx, val)
    else:
        v.value = cur.index_copy(0, idx, val)
    return LIS_SUCCESS


def lis_vector_set_values2(flag, start, count, value, v):
    """Insert/accumulate count contiguous entries from start
    (man lis_vector_set_values2.3)."""
    s, c = int(start), int(count)
    out = v.value.clone()
    val = _on_device(v, np.asarray(value[:c])).to(out.dtype)
    if flag == LIS_ADD_VALUE:
        out[s:s + c] += val
    else:
        out[s:s + c] = val
    v.value = out
    return LIS_SUCCESS


def lis_vector_scatter(value, v):
    """Copy a raw array into the vector (man lis_vector_scatter.3)."""
    v.value = _on_device(v, np.asarray(value[:v.n]))
    return LIS_SUCCESS


def lis_vector_gather(v, value=None):
    """Copy the vector into a raw array (man lis_vector_gather.3)."""
    out = _host_copy(v.value)
    if value is not None:
        value[:v.n] = out
        return LIS_SUCCESS
    return out


def lis_vector_swap(vsrc, vdst):
    """Exchange the contents of two vectors (man lis_vector_swap.3)."""
    vsrc.value, vdst.value = vdst.value, vsrc.value
    vsrc.n, vdst.n = vdst.n, vsrc.n
    return LIS_SUCCESS


def lis_vector_xpay(x, alpha, y):
    """y := x + alpha y (man lis_vector_xpay.3)."""
    from lis_tpu_torch.core import vector as _v
    y.value = _v.xpay(x.value, alpha, y.value)
    return LIS_SUCCESS


def lis_vector_axpyz(alpha, x, y, z):
    """z := alpha x + y (man lis_vector_axpyz.3)."""
    from lis_tpu_torch.core import vector as _v
    z.value = _v.axpyz(alpha, x.value, y.value)
    z.n = y.n
    return LIS_SUCCESS


def lis_vector_pmul(x, y, z):
    """z := x .* y elementwise (man lis_vector_pmul.3)."""
    from lis_tpu_torch.core import vector as _v
    z.value = _v.pmul(x.value, y.value)
    z.n = x.n
    return LIS_SUCCESS


def lis_vector_pdiv(x, y, z):
    """z := x ./ y elementwise (man lis_vector_pdiv.3)."""
    from lis_tpu_torch.core import vector as _v
    z.value = _v.pdiv(x.value, y.value)
    z.n = x.n
    return LIS_SUCCESS


def lis_vector_abs(x):
    """x := |x| in place (man lis_vector_abs.3)."""
    from lis_tpu_torch.core import vector as _v
    x.value = _v.abs_(x.value)
    return LIS_SUCCESS


def lis_vector_reciprocal(x):
    """x := 1 ./ x in place (man lis_vector_reciprocal.3)."""
    from lis_tpu_torch.core import vector as _v
    x.value = _v.reciprocal(x.value)
    return LIS_SUCCESS


def lis_vector_shift(sigma, x):
    """x := x - sigma in place (lis_vector_shift, src/vector/lis_vector_ops.c)."""
    from lis_tpu_torch.core import vector as _v
    x.value = _v.shift(sigma, x.value)
    return LIS_SUCCESS


def lis_vector_nhdot(u, v):
    """Non-Hermitian inner product x^T y (man lis_vector_nhdot.3)."""
    from lis_tpu_torch.core import vector as _v
    return complex_or_float(_v.nhdot(*_common(u.value, v.value)))


def lis_vector_nrm1(v):
    """1-norm of v (man lis_vector_nrm1.3)."""
    from lis_tpu_torch.core import vector as _v
    return float(_v.nrm1(v.value))


def lis_vector_nrmi(v):
    """Infinity-norm of v (man lis_vector_nrmi.3)."""
    from lis_tpu_torch.core import vector as _v
    return float(_v.nrmi(v.value))


def lis_vector_sum(v):
    """Sum of all entries (man lis_vector_sum.3)."""
    from lis_tpu_torch.core import vector as _v
    return complex_or_float(_v.vsum(v.value))


# ---- full lis.h surface: dense array ops (man lis_array_*.3) ----------------
# All operate on raw caller-owned buffers; matrices are column-major
# (Fortran order) like the reference.

def lis_array_swap(n, x, y):
    """Exchange the first n entries of two raw arrays (man lis_array_swap.3)."""
    n = int(n)
    t = np.array(x[:n])
    x[:n] = y[:n]
    y[:n] = t
    return LIS_SUCCESS


def lis_array_copy(n, x, y):
    """y := x for raw arrays (man lis_array_copy.3)."""
    y[:int(n)] = x[:int(n)]
    return LIS_SUCCESS


def lis_array_axpy(n, alpha, x, y):
    """y += alpha x for raw arrays (man lis_array_axpy.3)."""
    n = int(n)
    y[:n] = np.asarray(y[:n]) + alpha * np.asarray(x[:n])
    return LIS_SUCCESS


def lis_array_axpyz(n, alpha, x, y, z):
    """z := alpha x + y for raw arrays (man lis_array_axpyz.3)."""
    n = int(n)
    z[:n] = alpha * np.asarray(x[:n]) + np.asarray(y[:n])
    return LIS_SUCCESS


def lis_array_scale(n, alpha, x):
    """x := alpha x for raw arrays (man lis_array_scale.3)."""
    n = int(n)
    x[:n] = alpha * np.asarray(x[:n])
    return LIS_SUCCESS


def lis_array_pmul(n, x, y, z):
    """z := x .* y for raw arrays (man lis_array_pmul.3)."""
    n = int(n)
    z[:n] = np.asarray(x[:n]) * np.asarray(y[:n])
    return LIS_SUCCESS


def lis_array_pdiv(n, x, y, z):
    """z := x ./ y for raw arrays (man lis_array_pdiv.3)."""
    n = int(n)
    z[:n] = np.asarray(x[:n]) / np.asarray(y[:n])
    return LIS_SUCCESS


def lis_array_abs(n, x):
    """x := |x| in place (man lis_array_abs.3)."""
    n = int(n)
    x[:n] = np.abs(np.asarray(x[:n]))
    return LIS_SUCCESS


def lis_array_reciprocal(n, x):
    """x := 1 ./ x in place (man lis_array_reciprocal.3)."""
    n = int(n)
    x[:n] = 1.0 / np.asarray(x[:n])
    return LIS_SUCCESS


def lis_array_conjugate(n, x):
    """x := conj(x) in place (man lis_array_conjugate.3)."""
    n = int(n)
    x[:n] = np.conj(np.asarray(x[:n]))
    return LIS_SUCCESS


def lis_array_shift(n, sigma, x):
    """x := x - sigma in place (man lis_array_shift.3)."""
    n = int(n)
    x[:n] = np.asarray(x[:n]) - sigma
    return LIS_SUCCESS


def lis_array_dot(n, x, y):
    """Hermitian inner product of raw arrays (man lis_array_dot.3)."""
    n = int(n)
    return complex_or_float(np.vdot(np.asarray(x[:n]), np.asarray(y[:n])))


def lis_array_nhdot(n, x, y):
    """Non-Hermitian x^T y of raw arrays (man lis_array_nhdot.3)."""
    n = int(n)
    return complex_or_float(np.dot(np.asarray(x[:n]), np.asarray(y[:n])))


def lis_array_nrm1(n, x):
    """1-norm of the first n entries (man lis_array_nrm1.3)."""
    return float(np.sum(np.abs(np.asarray(x[:int(n)]))))


def lis_array_nrmi(n, x):
    """Infinity-norm of the first n entries (man lis_array_nrmi.3)."""
    return float(np.max(np.abs(np.asarray(x[:int(n)]))))


def lis_array_sum(n, x):
    """Sum of the first n entries (man lis_array_sum.3)."""
    return complex_or_float(np.sum(np.asarray(x[:int(n)])))


def complex_or_float(v):
    """Return a python complex for complex inputs, else float."""
    v = host(v) if isinstance(v, torch.Tensor) else np.asarray(v)
    return complex(v) if np.iscomplexobj(v) else float(v)


def _colmajor(a, rows, cols, ld=None):
    ld = int(ld) if ld is not None else int(rows)
    return np.asarray(a[:ld * int(cols)]).reshape(
        ld, int(cols), order="F")[:int(rows), :]


def _apply_op(dst, n, res, flag):
    if flag == LIS_INS_VALUE:
        dst[:n] = res
    elif flag == LIS_ADD_VALUE:
        dst[:n] = np.asarray(dst[:n]) + res
    else:
        dst[:n] = np.asarray(dst[:n]) - res


def lis_array_matvech(n, a, x, y, flag):
    """y {=, +=, -=} A^H x for an n×n column-major array
    (man lis_array_matvech.3)."""
    n = int(n)
    res = _colmajor(a, n, n).conj().T @ np.asarray(x[:n])
    _apply_op(y, n, res, flag)
    return LIS_SUCCESS


def lis_array_matvec_ns(m, n, a, lda, x, y, flag):
    """y {=, +=, -=} A x for a non-square m×n column-major array with
    leading dimension lda (man lis_array_matvec_ns.3)."""
    m, n = int(m), int(n)
    res = _colmajor(a, m, n, lda) @ np.asarray(x[:n])
    _apply_op(y, m, res, flag)
    return LIS_SUCCESS


def lis_array_matmat(n, a, b, c, flag):
    """C {=, +=, -=} A B for n×n column-major arrays (man lis_array_matmat.3)."""
    n = int(n)
    res = (_colmajor(a, n, n) @ _colmajor(b, n, n)).reshape(-1, order="F")
    _apply_op(c, n * n, res, flag)
    return LIS_SUCCESS


def lis_array_matmat_ns(m, n, k, a, lda, b, ldb, c, ldc, flag):
    """C {=, +=, -=} A B for m×k · k×n column-major arrays with leading
    dimensions (man lis_array_matmat_ns.3)."""
    m, n, k, ldc = int(m), int(n), int(k), int(ldc)
    res = _colmajor(a, m, k, lda) @ _colmajor(b, k, n, ldb)
    cm = np.asarray(c[:ldc * n]).reshape(ldc, n, order="F")
    if flag == LIS_INS_VALUE:
        cm[:m, :] = res
    elif flag == LIS_ADD_VALUE:
        cm[:m, :] += res
    else:
        cm[:m, :] -= res
    c[:ldc * n] = cm.reshape(-1, order="F")
    return LIS_SUCCESS


def lis_array_ge(n, a):
    """Invert an n×n column-major array in place by Gaussian elimination
    (man lis_array_ge.3)."""
    from lis_tpu_torch.core import array as _arr
    n = int(n)
    a[:n * n] = np.asarray(_arr.invert(_colmajor(a, n, n))).reshape(
        -1, order="F")
    return LIS_SUCCESS


def lis_array_cgs(n, a, q, r):
    """Classical Gram-Schmidt QR of an n×n column-major array into q, r
    (man lis_array_cgs.3)."""
    from lis_tpu_torch.core import array as _arr
    n = int(n)
    qm, rm = _arr.cgs(_colmajor(a, n, n))
    q[:n * n] = np.asarray(qm).reshape(-1, order="F")
    r[:n * n] = np.asarray(rm).reshape(-1, order="F")
    return LIS_SUCCESS


def lis_array_mgs(n, a, q, r):
    """Modified Gram-Schmidt QR of an n×n column-major array into q, r
    (man lis_array_mgs.3)."""
    from lis_tpu_torch.core import array as _arr
    n = int(n)
    qm, rm = _arr.mgs(_colmajor(a, n, n))
    q[:n * n] = np.asarray(qm).reshape(-1, order="F")
    r[:n * n] = np.asarray(rm).reshape(-1, order="F")
    return LIS_SUCCESS


def lis_array_qr(n, a, q, r, maxiter=100000, tol=1e-12):
    """Unshifted QR iteration a := R Q until the (2,1) entry decays,
    writing q/r of the final step; returns (qriter, qrerr)
    (man lis_array_qr.3; src/array/lis_array.c lis_array_qr)."""
    n = int(n)
    am = np.array(_colmajor(a, n, n))
    it, err = 0, np.inf
    while it < maxiter:
        it += 1
        qm, rm = np.linalg.qr(am)
        am = rm @ qm
        err = abs(am[1, 0]) if n > 1 else 0.0
        if err < tol:
            break
    a[:n * n] = am.reshape(-1, order="F")
    q[:n * n] = qm.reshape(-1, order="F")
    r[:n * n] = rm.reshape(-1, order="F")
    return it, float(err)


# ---- full lis.h surface: raw-layout matrix adoption (man lis_matrix_set_*.3)
# Each set_* records the caller's raw arrays in the reference's own packing
# (column-major blocks, diagonal-major DIA, slot-major ELL, ...); assemble
# re-lays them out into this library's TPU-first storage for the declared
# type.  Layouts verified against the reference matvec kernels
# (src/matvec/lis_matvec_{dia,ell,msr,jad,bsr,vbr}.c).

def _stash_triplets(A, rows, cols, vals, type_id):
    A._csr = None
    # keep the caller's scalar dtype (LIS_SCALAR is complex under the
    # complex build — a float64 cast would silently drop the imag part)
    A._triplets = (np.asarray(rows, dtype=np.int64),
                   np.asarray(cols, dtype=np.int64),
                   np.asarray(vals))
    A.matrix_type = type_id
    return LIS_SUCCESS


def lis_matrix_set_coo(nnz, row, col, value, A):
    """Adopt caller-owned COO triplets (man lis_matrix_set_coo.3)."""
    nnz = int(nnz)
    return _stash_triplets(A, row[:nnz], col[:nnz], value[:nnz],
                           LIS_MATRIX_COO)


def lis_matrix_set_dns(value, A):
    """Adopt a caller-owned column-major dense array
    (man lis_matrix_set_dns.3)."""
    n = A.n
    d = np.asarray(value[:n * n]).reshape(n, n, order="F")
    r, c = np.nonzero(d)
    return _stash_triplets(A, r, c, d[r, c], LIS_MATRIX_DNS)


def lis_matrix_set_csc(nnz, ptr, index, value, A):
    """Adopt caller-owned CSC arrays: column pointers + row indices
    (man lis_matrix_set_csc.3)."""
    n, nnz = A.n, int(nnz)
    p = np.asarray(ptr[:n + 1], dtype=np.int64)
    rows = np.asarray(index[:nnz], dtype=np.int64)
    cols = np.repeat(np.arange(n, dtype=np.int64), np.diff(p))
    return _stash_triplets(A, rows, cols, value[:nnz], LIS_MATRIX_CSC)


def lis_matrix_set_dia(nnd, index, value, A):
    """Adopt diagonal-major DIA arrays: value[j*n+i] on diagonal
    offset index[j] (man lis_matrix_set_dia.3)."""
    n, nnd = A.n, int(nnd)
    offs = np.asarray(index[:nnd], dtype=np.int64)
    v = np.asarray(value[:nnd * n]).reshape(nnd, n)
    rows, cols, vals = [], [], []
    for j, off in enumerate(offs):
        i = np.arange(max(0, -off), min(n, n - off), dtype=np.int64)
        rows.append(i)
        cols.append(i + off)
        vals.append(v[j, i])
    return _stash_triplets(A, np.concatenate(rows), np.concatenate(cols),
                           np.concatenate(vals), LIS_MATRIX_DIA)


def lis_matrix_set_ell(maxnzr, index, value, A):
    """Adopt slot-major ELL arrays: value[j*n+i] with column index[j*n+i];
    zero-valued padding entries are dropped (man lis_matrix_set_ell.3)."""
    n, w = A.n, int(maxnzr)
    idx = np.asarray(index[:w * n], dtype=np.int64).reshape(w, n)
    v = np.asarray(value[:w * n]).reshape(w, n)
    rows = np.tile(np.arange(n, dtype=np.int64), w)
    keep = v.reshape(-1) != 0.0
    return _stash_triplets(A, rows[keep], idx.reshape(-1)[keep],
                           v.reshape(-1)[keep], LIS_MATRIX_ELL)


def lis_matrix_set_msr(nnz, ndz, index, value, A):
    """Adopt MSR arrays: value[0:n] diagonal, index[0:n+1] pointers into
    the shared off-diagonal tail (man lis_matrix_set_msr.3)."""
    n = A.n
    p = np.asarray(index[:n + 1], dtype=np.int64)
    rows = [np.arange(n, dtype=np.int64)]
    cols = [np.arange(n, dtype=np.int64)]
    vals = [np.asarray(value[:n])]
    cnt = np.diff(p)
    rows.append(np.repeat(np.arange(n, dtype=np.int64), cnt))
    cols.append(np.asarray(index[int(p[0]):int(p[n])], dtype=np.int64))
    vals.append(np.asarray(value[int(p[0]):int(p[n])]))
    keep = np.concatenate(vals) != 0.0
    keep[:n] = True  # keep explicit diagonal incl. zeros
    return _stash_triplets(A, np.concatenate(rows)[keep],
                           np.concatenate(cols)[keep],
                           np.concatenate(vals)[keep], LIS_MATRIX_MSR)


def lis_matrix_set_jad(nnz, maxnzr, perm, ptr, index, value, A):
    """Adopt jagged-diagonal arrays: perm maps sorted position to original
    row, ptr bounds each jagged diagonal (man lis_matrix_set_jad.3)."""
    n, w, nnz = A.n, int(maxnzr), int(nnz)
    pm = np.asarray(perm[:n], dtype=np.int64)
    p = np.asarray(ptr[:w + 1], dtype=np.int64)
    rows, cols, vals = [], [], []
    for j in range(w):
        js, je = int(p[j]), int(p[j + 1])
        rows.append(pm[np.arange(je - js, dtype=np.int64)])
        cols.append(np.asarray(index[js:je], dtype=np.int64))
        vals.append(np.asarray(value[js:je]))
    return _stash_triplets(A, np.concatenate(rows), np.concatenate(cols),
                           np.concatenate(vals), LIS_MATRIX_JAD)


def _block_triplets(bnr, bnc, bptr, bindex, value, nmajor, by_row):
    """Expand column-major bnr×bnc blocks into (row, col, value) triplets.
    value[bc*bnr*bnc + j*bnr + i] is entry (i, j) of block bc
    (lis_matvec_bsr.c:57 loop order)."""
    bnr, bnc = int(bnr), int(bnc)
    bs = bnr * bnc
    p = np.asarray(bptr[:nmajor + 1], dtype=np.int64)
    bi_major = np.repeat(np.arange(nmajor, dtype=np.int64), np.diff(p))
    bother = np.asarray(bindex[:int(p[nmajor])], dtype=np.int64)
    nblk = len(bother)
    # within-block position k = j*bnr + i  (j outer, i inner)
    ii = np.tile(np.arange(bnr, dtype=np.int64), bnc)
    jj = np.repeat(np.arange(bnc, dtype=np.int64), bnr)
    if by_row:
        rows = (bi_major[:, None] * bnr + ii[None, :]).reshape(-1)
        cols = (bother[:, None] * bnc + jj[None, :]).reshape(-1)
    else:
        rows = (bother[:, None] * bnr + ii[None, :]).reshape(-1)
        cols = (bi_major[:, None] * bnc + jj[None, :]).reshape(-1)
    flat = np.asarray(value[:nblk * bs]).reshape(-1)
    return rows, cols, flat


def lis_matrix_set_bsr(bnr, bnc, bnnz, bptr, bindex, value, A):
    """Adopt BSR arrays: column-major bnr×bnc blocks, block-row pointers
    (man lis_matrix_set_bsr.3)."""
    nr = (A.n + int(bnr) - 1) // int(bnr)
    rows, cols, vals = _block_triplets(bnr, bnc, bptr, bindex, value, nr,
                                       by_row=True)
    keep = (vals != 0.0) & (rows < A.n) & (cols < A.n)
    A._block = (int(bnr), int(bnc))
    return _stash_triplets(A, rows[keep], cols[keep], vals[keep],
                           LIS_MATRIX_BSR)


def lis_matrix_set_bsc(bnr, bnc, bnnz, bptr, bindex, value, A):
    """Adopt BSC arrays: column-major blocks, block-column pointers
    (man lis_matrix_set_bsc.3)."""
    nc = (A.n + int(bnc) - 1) // int(bnc)
    rows, cols, vals = _block_triplets(bnr, bnc, bptr, bindex, value, nc,
                                       by_row=False)
    keep = (vals != 0.0) & (rows < A.n) & (cols < A.n)
    A._block = (int(bnr), int(bnc))
    return _stash_triplets(A, rows[keep], cols[keep], vals[keep],
                           LIS_MATRIX_BSC)


def lis_matrix_set_vbr(nnz, nr, nc, bnnz, row, col, ptr, bptr, bindex,
                       value, A):
    """Adopt VBR arrays: variable row/col partitions, per-block value
    pointers, column-major within blocks (man lis_matrix_set_vbr.3)."""
    nr, nc = int(nr), int(nc)
    rp = np.asarray(row[:nr + 1], dtype=np.int64)
    cp = np.asarray(col[:nc + 1], dtype=np.int64)
    bp = np.asarray(bptr[:nr + 1], dtype=np.int64)
    vp = np.asarray(ptr[:int(bp[nr]) + 1], dtype=np.int64)
    rows, cols, vals = [], [], []
    for bi in range(nr):
        for bc in range(int(bp[bi]), int(bp[bi + 1])):
            bj = int(bindex[bc])
            h = int(rp[bi + 1] - rp[bi])
            w = int(cp[bj + 1] - cp[bj])
            blk = np.asarray(
                value[int(vp[bc]):int(vp[bc]) + h * w]).reshape(
                    w, h)  # column-major: j outer, i inner
            jj, ii = np.nonzero(blk)
            rows.append(rp[bi] + ii)
            cols.append(cp[bj] + jj)
            vals.append(blk[jj, ii])
    A._vbr_parts = (rp, cp)
    return _stash_triplets(A, np.concatenate(rows), np.concatenate(cols),
                           np.concatenate(vals), LIS_MATRIX_VBR)


def lis_matrix_set_blocksize(A, bnr, bnc, row=None, col=None):
    """Record the block size used when converting to BSR/BSC/VBR
    (man lis_matrix_set_blocksize.3)."""
    if row is not None and col is not None:
        A._vbr_parts = (np.asarray(row, dtype=np.int64),
                        np.asarray(col, dtype=np.int64))
    A._block = (int(bnr), int(bnc))
    return LIS_SUCCESS


def lis_matrix_unset(A):
    """Detach the caller's raw arrays from the handle without touching
    them — the assembled storage object survives (man lis_matrix_unset.3)."""
    A._csr = None
    A._triplets = None
    return LIS_SUCCESS


def lis_matrix_is_assembled(A):
    """LIS_TRUE(1) once assemble has built storage (man
    lis_matrix_is_assembled.3)."""
    return 1 if A.m is not None else 0


def lis_matrix_copy(Ain, Aout):
    """Deep-copy storage into Aout (man lis_matrix_copy.3)."""
    Aout.n = Ain.n
    Aout.matrix_type = Ain.matrix_type
    Aout.m = Ain.m  # storage is never written in place: sharing IS copy
    return LIS_SUCCESS


def lis_matrix_set_value_new(flag, i, j, value, A):
    """set_value without duplicate search — the assembler already
    accumulates, so this is the same operation (man
    lis_matrix_set_value_new.3)."""
    return lis_matrix_set_value(flag, i, j, value, A)


def lis_matrix_set_values(flag, n, value, A):
    """Set a dense n×n row-major block of values (man
    lis_matrix_set_values.3)."""
    n = int(n)
    for i in range(n):
        for j in range(n):
            lis_matrix_set_value(flag, i, j, value[i * n + j], A)
    return LIS_SUCCESS


def lis_matrix_set_value_csr(flag, i, j, value, A):
    """Update a value inside the assembled CSR structure (man
    lis_matrix_set_value_csr.3)."""
    return lis_matrix_psd_set_value(flag, i, j, value, A)


def lis_matrix_psd_set_value_csr(flag, i, j, value, A):
    """CSR-specific PSD value update (lis_matrix_psd_set_value_csr,
    src/matrix/lis_matrix_csr.c)."""
    return lis_matrix_psd_set_value(flag, i, j, value, A)


def lis_matrix_scale(A, b, d, action):
    """Scale A (and b) by the diagonal: action 1 = row scaling D^-1 A,
    action 2 = symmetric D^-1/2 A D^-1/2; d receives the scaling vector
    (lis_matrix_scale, src/matrix/lis_matrix_ops.c)."""
    diag = A.m.get_diagonal()
    nz = diag != 0
    safe = torch.where(nz, diag, torch.ones_like(diag))
    if int(action) == 2:
        s = torch.where(nz, 1.0 / torch.sqrt(torch.abs(safe)),
                        torch.ones_like(safe))
        A.m = A.m.scale_symm(s)
    else:
        s = torch.where(nz, 1.0 / safe, torch.ones_like(safe))
        A.m = A.m.scale_rows(s)
    if b is not None:
        b.value = s * b.value
    if d is not None:
        d.value = s
        d.n = A.n
    A.is_scaled = True
    return LIS_SUCCESS


def lis_matrix_get_vbr_rowcol(A, *_):
    """Row/column block partitions recorded for VBR
    (man lis_matrix_get_vbr_rowcol.3): returns (nr, nc, row, col)."""
    rp, cp = A._vbr_parts
    return len(rp) - 1, len(cp) - 1, rp, cp


# malloc family: the reference returns raw C buffers for the caller to
# fill before lis_matrix_set_* — here they are plain numpy arrays
# (man lis_matrix_malloc_*.3).

def lis_matrix_malloc(A, nnz_row, nnz=None):
    """Pre-size the assembly workspace — a no-op under managed memory
    (man lis_matrix_malloc.3)."""
    return LIS_SUCCESS


def _ibuf(k):
    return np.zeros(int(k), dtype=np.int64)


def _dbuf(k):
    return np.zeros(int(k), dtype=np.float64)


def lis_matrix_malloc_csr(n, nnz):
    """(ptr, index, value) buffers for set_csr (man lis_matrix_malloc_csr.3)."""
    return _ibuf(n + 1), _ibuf(nnz), _dbuf(nnz)


def lis_matrix_malloc_csc(n, nnz):
    """(ptr, index, value) buffers for set_csc (man lis_matrix_malloc_csc.3)."""
    return _ibuf(n + 1), _ibuf(nnz), _dbuf(nnz)


def lis_matrix_malloc_coo(nnz):
    """(row, col, value) buffers for set_coo (man lis_matrix_malloc_coo.3)."""
    return _ibuf(nnz), _ibuf(nnz), _dbuf(nnz)


def lis_matrix_malloc_dia(n, nnd):
    """(index, value) buffers for set_dia (man lis_matrix_malloc_dia.3)."""
    return _ibuf(nnd), _dbuf(int(n) * int(nnd))


def lis_matrix_malloc_ell(n, maxnzr):
    """(index, value) buffers for set_ell (man lis_matrix_malloc_ell.3)."""
    return _ibuf(int(n) * int(maxnzr)), _dbuf(int(n) * int(maxnzr))


def lis_matrix_malloc_msr(n, nnz, ndz):
    """(index, value) buffers for set_msr (man lis_matrix_malloc_msr.3)."""
    k = int(nnz) + int(ndz) + 1
    return _ibuf(k), _dbuf(k)


def lis_matrix_malloc_jad(n, nnz, maxnzr):
    """(perm, ptr, index, value) buffers for set_jad
    (man lis_matrix_malloc_jad.3)."""
    return (_ibuf(n), _ibuf(int(maxnzr) + 1), _ibuf(nnz), _dbuf(nnz))


def lis_matrix_malloc_bsr(n, bnr, bnc, bnnz):
    """(bptr, bindex, value) buffers for set_bsr
    (man lis_matrix_malloc_bsr.3)."""
    nr = (int(n) + int(bnr) - 1) // int(bnr)
    return _ibuf(nr + 1), _ibuf(bnnz), _dbuf(int(bnnz) * int(bnr) * int(bnc))


def lis_matrix_malloc_bsc(n, bnr, bnc, bnnz):
    """(bptr, bindex, value) buffers for set_bsc
    (man lis_matrix_malloc_bsc.3)."""
    nc = (int(n) + int(bnc) - 1) // int(bnc)
    return _ibuf(nc + 1), _ibuf(bnnz), _dbuf(int(bnnz) * int(bnr) * int(bnc))


def lis_matrix_malloc_vbr(n, nnz, nr, nc, bnnz):
    """(row, col, ptr, bptr, bindex, value) buffers for set_vbr
    (man lis_matrix_malloc_vbr.3)."""
    return (_ibuf(int(nr) + 1), _ibuf(int(nc) + 1), _ibuf(int(bnnz) + 1),
            _ibuf(int(nr) + 1), _ibuf(bnnz), _dbuf(nnz))


def lis_matrix_malloc_dns(n, gn):
    """value buffer for set_dns (man lis_matrix_malloc_dns.3)."""
    return _dbuf(int(n) * int(gn))


def lis_is_malloc(p):
    """LIS_TRUE(1) for any live Python buffer (man lis_is_malloc.3)."""
    return 1 if p is not None else 0


# ---- full lis.h surface: solver/esolver getters + registration --------------

def lis_solve_setup(A, solver):
    """Bind A for subsequent lis_solve_kernel calls — the setup half of
    the decoupled workflow (lis_solve_setup, src/solver/lis_solver.c)."""
    return lis_solver_set_matrix(A, solver)


def lis_solver_get_precon(solver):
    """Numeric id of the preconditioner that ran (man
    lis_solver_get_precon.3)."""
    return solver.result.options.precon_id


def lis_solver_get_preconname(precon_type):
    """Preconditioner name for a numeric id, including user-registered
    ids above the built-in table (man lis_solver_get_preconname.3)."""
    from lis_tpu_torch.runtime.options import PRECON_NAMES
    pid = int(precon_type)
    if pid >= len(PRECON_NAMES):
        from lis_tpu_torch.precon.base import user_precon_name
        name = user_precon_name(pid)
        if name is not None:
            return name
    return PRECON_NAMES[pid]


def lis_precon_register(name, pcreate, psolve=None, psolveh=None):
    """Register a user preconditioner under -p <name>
    (man lis_precon_register.3).  pcreate(A, opts) must return an object
    with psolve(r) (and psolveh(r) for the BiCG family); alternatively
    pass psolve/psolveh callables and pcreate as the state's maker."""
    from lis_tpu_torch.precon.base import PRECON_REGISTRY

    if psolve is None:
        PRECON_REGISTRY[name] = pcreate
    else:
        def build(A, opts):
            return _UserPreconState(pcreate(A, opts), psolve,
                                    psolveh if psolveh is not None
                                    else psolve)
        PRECON_REGISTRY[name] = build
    _user_precons.append(name)
    return LIS_SUCCESS


class _UserPreconState:
    """A user preconditioner: the state that pcreate built (device
    tensors, usually) and the apply callables, which receive it and the
    solver's device tensor r."""

    def __init__(self, state, psolve_fn, psolveh_fn):
        self.state = state
        self._psolve_fn = psolve_fn
        self._psolveh_fn = psolveh_fn

    def psolve(self, r):
        return self._psolve_fn(self.state, r)

    def psolveh(self, r):
        return self._psolveh_fn(self.state, r)

    def to(self, device=None, dtype=None):
        """A copy whose state, where it is a tensor, is moved and (if
        real floating point) cast, as a built-in preconditioner's fields
        are by ``TensorFields.to``."""
        st = self.state
        if isinstance(st, torch.Tensor):
            st = st.to(device) if device is not None else st
            if dtype is not None and st.is_floating_point():
                st = st.to(dtype)
        return _UserPreconState(st, self._psolve_fn, self._psolveh_fn)


_user_precons: list = []


def lis_precon_register_free():
    """Remove every user-registered preconditioner
    (man lis_precon_register_free.3)."""
    from lis_tpu_torch.precon.base import PRECON_REGISTRY
    while _user_precons:
        PRECON_REGISTRY.pop(_user_precons.pop(), None)
    return LIS_SUCCESS


def lis_esolver_get_time(esolver):
    """Wall-clock time of the last esolve (man lis_esolver_get_time.3)."""
    return getattr(esolver, "time", 0.0)


def lis_esolver_get_rhistory(esolver, v=None):
    """Residual history of the last esolve (man lis_esolver_get_rhistory.3)."""
    rh = esolver.result.rhistory
    if v is not None:
        v.value = _on_device(v, rh)
        v.n = len(rh)
        return LIS_SUCCESS
    return rh


def lis_esolver_get_evectors(esolver, M):
    """All computed eigenvectors as the columns of a dense matrix handle
    (man lis_esolver_get_evectors.3; EsolveResult stores modes as rows)."""
    from lis_tpu_torch.matrix.dns import DNSMatrix
    ev = np.asarray(esolver.result.evectors)
    if ev.ndim == 1:
        ev = ev[None, :]
    M.n = ev.shape[1]
    M.matrix_type = LIS_MATRIX_DNS
    M.m = DNSMatrix.from_dense(ev.T)
    return LIS_SUCCESS


def lis_esolver_get_iters(esolver, v=None):
    """Per-mode iteration counts (man lis_esolver_get_iters.3)."""
    it = np.asarray(esolver.result.iters_all)
    if v is not None:
        v.value = _on_device(v, it)
        v.n = len(it)
        return LIS_SUCCESS
    return it


def lis_esolver_get_residualnorms(esolver, v=None):
    """Per-mode relative residuals (man lis_esolver_get_residualnorms.3)."""
    rs = np.asarray(esolver.result.resids_all)
    if v is not None:
        v.value = _on_device(v, rs)
        v.n = len(rs)
        return LIS_SUCCESS
    return rs


def lis_esolver_get_specific_evalue(esolver, mode):
    """Eigenvalue of the requested mode (man
    lis_esolver_get_specific_evalue.3)."""
    return float(np.asarray(esolver.result.evalues)[int(mode)])


def lis_esolver_get_specific_evector(esolver, mode, x):
    """Eigenvector of the requested mode into x (man
    lis_esolver_get_specific_evector.3)."""
    ev = np.asarray(esolver.result.evectors)
    if ev.ndim == 1:
        ev = ev[None, :]
    x.value = _on_device(x, ev[int(mode)])
    x.n = ev.shape[1]
    return LIS_SUCCESS


def lis_esolver_get_specific_iter(esolver, mode):
    """Iteration count of the requested mode (man
    lis_esolver_get_specific_iter.3)."""
    return int(np.asarray(esolver.result.iters_all)[int(mode)])


def lis_esolver_get_specific_residualnorm(esolver, mode):
    """Relative residual of the requested mode (man
    lis_esolver_get_specific_residualnorm.3)."""
    return float(np.asarray(esolver.result.resids_all)[int(mode)])


def lis_iesolver_destroy(esolver):
    """Release an inner eigensolver handle (man lis_iesolver_destroy.3)."""
    return LIS_SUCCESS


# ---- full lis.h surface: utilities ------------------------------------------

def lis_printf(comm, mess, *args):
    """Rank-0 printf (man lis_printf.3; single-process here, so: print)."""
    print((mess % args) if args else mess, end="")
    return LIS_SUCCESS


def lis_debug_trace_func(flag, func):
    """Emit a LIS_DEBUG_FUNC_IN/OUT trace line when tracing is enabled
    (man lis_debug_trace_func.3; utils/trace.py carries the state)."""
    from lis_tpu_torch.utils.trace import debug_trace_enabled
    if debug_trace_enabled():
        print(f"{'IN ' if flag else 'OUT'}: {func}")
    return LIS_SUCCESS
