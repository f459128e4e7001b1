"""Power-family eigensolvers: PI, II, RQI and their generalized forms.

Port of ``lis_tpu/esolvers/power.py`` (reference lis_epi,
src/esolver/lis_esolver_pi.c:127; lis_eii, lis_esolver_ii.c:127, one inner
Krylov solve per outer iteration through lis_solve_kernel at :216; lis_erqi,
lis_esolver_rqi.c:129).  A generalized problem Ax = λBx iterates on B⁻¹A
(inner solves with B) or solves with the pencil A − σB.

lis_tpu gives each eigensolver two forms, and so does this port:

- the device loop (lis_tpu's compiled ``lax.while_loop``: ``_epi_run``,
  ``_eii_runner``, ``_erqi_runner`` and the generalized runners).  Its
  inner solves call ``SOLVER_FNS`` directly with no preconditioner: no
  driver, no scaling, no routing.  Here it is a Python loop over device
  tensors on the matrix's device; the host reads the convergence test
  once per outer iteration, as ``solvers/base.py::krylov_loop`` does;
- the host loop, through the driver's ``solve``, which honours the whole
  inner option surface (-p, -f, every solver).

PI, II and RQI take the device loop when ``_raw_inner_ok`` holds (lis_tpu
``_jit_inner_ok``, power.py:188-197).

Each device loop takes lis_tpu's ``axis_name``: None (serial) or the
``parallel.mesh.Mesh`` of a distributed eigensolve
(``parallel/dist_esolve.py``), which goes into every dot and norm and
into the inner ``SolverSpec``, so that every value the host reads is
reduced over the mesh and every rank takes the same branch.  Under a
mesh the operator is a rank's shard, which the driver cannot analyse:
``_bsolve`` and ``_shift_solve`` then take lis_tpu's operator-only branch
(power.py:50-58, :287-316), a raw registry solve over the mesh.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from lis_tpu_torch import config as C
from lis_tpu_torch.core import vector as v
from lis_tpu_torch.esolvers.base import register_esolver
from lis_tpu_torch.matrix.base import host
from lis_tpu_torch.precon.base import NonePrecon
from lis_tpu_torch.solvers.base import SOLVER_FNS, SolverSpec


def _result(evalue, x, iters, resid, status, rh):
    from lis_tpu_torch.esolvers.driver import EsolveResult
    ev = np.asarray([evalue])
    return EsolveResult(evalue=float(np.real(evalue)), evector=x, iters=iters,
                        resid=float(resid), status=status,
                        evalues=np.real(ev), evectors=host(x)[None, :],
                        iters_all=np.asarray([iters]),
                        resids_all=np.asarray([resid]),
                        rhistory=np.asarray(rh))


def _inner_precision(opts):
    """-ef {quad,df,...} runs the inner Krylov solves in that precision
    (the reference's esolver quad registry is empty, lis_esolver.c:69-72;
    its quad support goes through the inner lis_solve)."""
    p = opts.precision
    return p if p != "double" else opts.inner.precision


def _bsolve(B, rhs, opts, axis_name=None):
    """Solve B y = rhs for the generalized reduction, through the driver;
    under a mesh a raw unpreconditioned registry solve over it (lis_tpu's
    operator-only branch, power.py:50-58)."""
    if axis_name is not None:
        return _raw_solve(B, rhs, SolverSpec(
            solver=_raw_inner_name(opts), tol=max(opts.tol * 1e-2, 1e-14),
            maxiter=opts.inner.maxiter, conv_cond=0, axis_name=axis_name))
    from lis_tpu_torch.solvers.driver import solve
    r = solve(B, rhs, options=None,
              solver=opts.inner.solver, precon=opts.inner.precon,
              maxiter=opts.inner.maxiter, tol=max(opts.tol * 1e-2, 1e-14),
              precision=_inner_precision(opts))
    return r.x


# The simple Krylov kinds a raw inner solve may use; any other -i falls
# back to bicgstab there (lis_tpu _JIT_INNER_SOLVERS, power.py:171)
_RAW_INNER_SOLVERS = ("cg", "bicgstab", "cgs", "bicg", "minres")


def _raw_inner_name(opts):
    """The inner solver of the device loops: the requested -i when it is
    one of ``_RAW_INNER_SOLVERS``, else bicgstab (lis_tpu
    ``_jit_inner_name``)."""
    s = opts.inner.solver
    return s if s in _RAW_INNER_SOLVERS else "bicgstab"


def _inner_spec(opts):
    """The SolverSpec of a raw inner solve (lis_tpu ``_gen_inner_key``)."""
    return SolverSpec(solver=_raw_inner_name(opts),
                      tol=opts.inner.tol, maxiter=opts.inner.maxiter,
                      conv_cond=0)


def _raw_inner_ok(opts):
    """Whether PI, II and RQI may take the device loop, whose inner solves
    are raw registry calls (lis_tpu ``_jit_inner_ok``, power.py:188-197):
    unpreconditioned double inner solves of the simple Krylov kinds.
    Anything else (an inner -p, -ef quad/df, another inner solver) takes
    the host loop, which honours the full inner option surface through
    the driver."""
    return (opts.inner.precon == "none"
            and opts.precision == "double"
            and opts.inner.precision == "double"
            and opts.inner.solver in _RAW_INNER_SOLVERS)


def _raw_solve(Aop, rhs, spec):
    """One inner solve straight through the registry, no preconditioner."""
    return SOLVER_FNS[spec.solver](Aop, rhs, torch.zeros_like(rhs),
                                   NonePrecon(), spec).x


def _conj(s):
    """The conjugate of a shift: a device scalar or a Python number."""
    return s.conj() if isinstance(s, torch.Tensor) else s.conjugate()


def _den(ev):
    """|ev|, or 1 where ev is 0: the relative residual's denominator."""
    a = ev.abs()
    return torch.where(ev == 0, torch.ones_like(a), a)


def _history(x, maxiter):
    """The device residual history: nan where unwritten, [0] unused."""
    return torch.full((maxiter + 1,), float("nan"), dtype=x.real.dtype,
                      device=x.device)


def _finite(y):
    """Non-finite entries zeroed (lis_tpu power.py:387, 501, 552, 610)."""
    return torch.where(torch.isfinite(y), y, torch.zeros_like(y))


def _loop_result(tol, iters, x, ev, resid, rh, dead=None):
    """An EsolveResult from a device loop's final state (lis_tpu
    ``_epi_jit``, ``_eii_jit`` and the like): SUCCESS at resid <= tol,
    else BREAKDOWN where the RQI retries gave up, else MAXITER.  A complex
    operator's eigenvalue is reported by its real part, as lis_tpu's
    is."""
    resid = float(resid)
    if resid <= tol:
        status = C.LIS_SUCCESS
    elif dead is not None and bool(dead):
        status = C.LIS_BREAKDOWN
    else:
        status = C.LIS_MAXITER
    return _result(float(ev.real), x, iters, resid, status,
                   host(rh)[1:iters + 1])


# ---- PI ---------------------------------------------------------------------

@register_esolver("pi")
def epi(A, B, x0, opts):
    """Power iteration (lis_epi); for Ax = λBx it iterates B⁻¹A.  The
    standard problem always takes the device loop, the generalized one
    when ``_raw_inner_ok`` holds."""
    if B is None:
        return _loop_result(opts.tol, *_epi_run(A, x0, opts.maxiter,
                                                opts.tol))
    if _raw_inner_ok(opts):
        return _loop_result(opts.tol, *_egpi_run(
            A, B, x0, opts.maxiter, opts.tol, _inner_spec(opts)))
    x = x0 / v.nrm2(x0)
    evalue, resid = 0.0, np.inf
    rh = []
    status = C.LIS_MAXITER
    iters = opts.maxiter
    for it in range(1, opts.maxiter + 1):
        z = _bsolve(B, A.matvec(x), opts)
        evalue = complex(v.dot(x, z)).real
        znrm = v.nrm2(z)
        x = z / znrm
        # residual: ||B⁻¹Ax − λx|| with the new normalized x
        az = _bsolve(B, A.matvec(x), opts)
        resid = float(v.nrm2(az - evalue * x) /
                      (abs(evalue) if evalue != 0 else 1.0))
        rh.append(resid)
        if resid <= opts.tol:
            status, iters = C.LIS_SUCCESS, it
            break
    return _result(evalue, x, iters, resid, status, rh)


def _epi_run(A, x0, maxiter, tol, axis_name=None):
    """The power iteration's device loop (lis_tpu ``_epi_run``)."""
    dot = partial(v.dot, axis_name=axis_name)
    nrm2 = partial(v.nrm2, axis_name=axis_name)
    x = x0 / nrm2(x0)
    z = A.matvec(x)
    rh = _history(x0, maxiter)
    lam = torch.zeros((), dtype=x0.dtype, device=x0.device)
    resid = torch.tensor(float("inf"), dtype=rh.dtype, device=x0.device)
    it = 1
    while it <= maxiter and bool(resid > tol):
        lam = dot(x, z)
        x = z / nrm2(z)
        z = A.matvec(x)
        resid = nrm2(z - lam * x) / _den(lam)
        rh[it] = resid
        it += 1
    return it - 1, x, lam, resid, rh


class _GenOp:
    """B⁻¹A as an operator: matvec nests a raw inner solve with B, so the
    standard device loops run unchanged on the generalized pencil (under
    a mesh, ``spec.axis_name`` carries it into the nested solve)."""

    def __init__(self, A, B, spec: SolverSpec):
        self.A, self.B, self.spec = A, B, spec

    def matvec(self, x):
        return _raw_solve(self.B, self.A.matvec(x), self.spec)


def _egpi_run(A, B, x0, maxiter, tol, inner, axis_name=None):
    """Generalized power iteration's device loop (lis_tpu
    ``_egpi_runner``): two raw B-solves per outer iteration."""
    dot = partial(v.dot, axis_name=axis_name)
    nrm2 = partial(v.nrm2, axis_name=axis_name)
    inner = inner._replace(axis_name=axis_name)
    x = x0 / nrm2(x0)
    rh = _history(x0, maxiter)
    ev = torch.zeros((), dtype=x0.dtype, device=x0.device)
    resid = torch.tensor(float("inf"), dtype=rh.dtype, device=x0.device)
    it = 1
    while it <= maxiter and bool(resid > tol):
        z = _raw_solve(B, A.matvec(x), inner)
        ev = dot(x, z)
        x = z / nrm2(z)
        az = _raw_solve(B, A.matvec(x), inner)
        resid = nrm2(az - ev * x) / _den(ev)
        rh[it] = resid
        it += 1
    return it - 1, x, ev, resid, rh


# ---- II ---------------------------------------------------------------------

def _shift_solve(A, B, sigma, rhs, opts, axis_name=None):
    """Solve (A − σB) y = rhs through the driver (the inner Krylov solve of
    II and RQI's host loops, reference lis_esolver_ii.c:216).  A DIA shifts
    on the device (``DIAMatrix.shift_diagonal`` / ``axpy``).  Under a mesh
    A and B are shards: a raw registry solve over the mesh with A − σI or
    A − σB as an operator (lis_tpu's operator-only branches,
    power.py:287-316)."""
    if axis_name is not None:
        As = _shifted(A, sigma) if B is None else \
            _ShiftedPencil(A, B, float(sigma))
        return _raw_solve(As, rhs,
                          _inner_spec(opts)._replace(axis_name=axis_name))
    from lis_tpu_torch.solvers.driver import solve
    if B is None:
        As = A.shift_diagonal(sigma)          # A − σI
    else:
        As = B.axpy(-sigma, A)                # A + (−σ)·B
    r = solve(As, rhs, options=None,
              solver=opts.inner.solver, precon=opts.inner.precon,
              maxiter=opts.inner.maxiter, tol=opts.inner.tol,
              precision=_inner_precision(opts))
    return r.x


@register_esolver("ii")
def eii(A, B, x0, opts):
    """Inverse iteration (lis_eii): one inner solve per outer iteration,
    the eigenvalue from the Rayleigh quotient of the inverse map."""
    sigma = opts.rval
    if _raw_inner_ok(opts):
        if B is None:
            As = A.shift_diagonal(sigma) if sigma != 0.0 else A
            out = _eii_run(As, A, x0, float(sigma), opts.maxiter, opts.tol,
                           _inner_spec(opts))
        else:
            out = _egii_run(A, B, x0, float(sigma), opts.maxiter, opts.tol,
                            _inner_spec(opts))
        return _loop_result(opts.tol, *out)
    x = x0 / v.nrm2(x0)
    evalue, resid = 0.0, np.inf
    rh = []
    status = C.LIS_MAXITER
    iters = opts.maxiter
    for it in range(1, opts.maxiter + 1):
        rhs = x if B is None else B.matvec(x)
        y = _shift_solve(A, B, sigma, rhs, opts)
        theta = complex(v.dot(x, y)).real        # ≈ 1/(λ − σ)
        ynrm = v.nrm2(y)
        x = y / ynrm
        evalue = sigma + 1.0 / theta
        az = A.matvec(x)
        bx = x if B is None else B.matvec(x)
        resid = float(v.nrm2(az - evalue * bx) /
                      (abs(evalue) if evalue != 0 else 1.0))
        rh.append(resid)
        if resid <= opts.tol:
            status, iters = C.LIS_SUCCESS, it
            break
    return _result(evalue, x, iters, resid, status, rh)


def _eii_run(As, A, x0, sigma, maxiter, tol, inner, axis_name=None):
    """Inverse iteration's device loop (lis_tpu ``_eii_runner``): a raw
    inner solve with the shifted operator ``As`` per outer iteration."""
    dot = partial(v.dot, axis_name=axis_name)
    nrm2 = partial(v.nrm2, axis_name=axis_name)
    inner = inner._replace(axis_name=axis_name)
    x = x0 / nrm2(x0)
    rh = _history(x0, maxiter)
    ev = torch.zeros((), dtype=x0.dtype, device=x0.device)
    resid = torch.tensor(float("inf"), dtype=rh.dtype, device=x0.device)
    it = 1
    while it <= maxiter and bool(resid > tol):
        y = _finite(_raw_solve(As, x, inner))
        theta = dot(x, y)
        x = y / nrm2(y)
        ev = sigma + 1.0 / theta
        resid = nrm2(A.matvec(x) - ev * x) / _den(ev)
        rh[it] = resid
        it += 1
    return it - 1, x, ev, resid, rh


class _Shifted:
    """A − σI with σ a device scalar, so RQI's moving shift rebuilds no
    matrix."""

    def __init__(self, A, sigma):
        self.A, self.sigma = A, sigma

    def matvec(self, x):
        return self.A.matvec(x) - self.sigma * x

    def matvech(self, x):
        return self.A.matvech(x) - _conj(self.sigma) * x


def _shifted(A, sigma):
    """A − σI as an operator (A itself at σ = 0)."""
    return _Shifted(A, float(sigma)) if sigma != 0.0 else A


class _ShiftedPencil:
    """A − σB as an operator with σ a device scalar: the generalized
    shift-solve operator of II and RQI's device loops (reference
    lis_esolver_ii.c generalized branch)."""

    def __init__(self, A, B, sigma):
        self.A, self.B, self.sigma = A, B, sigma

    def matvec(self, x):
        return self.A.matvec(x) - self.sigma * self.B.matvec(x)

    def matvech(self, x):
        return self.A.matvech(x) - _conj(self.sigma) * self.B.matvech(x)


def _egii_run(A, B, x0, sigma, maxiter, tol, inner, axis_name=None):
    """Generalized inverse iteration's device loop (lis_tpu
    ``_egii_runner``): one raw solve of (A − σB) y = Bx per outer step."""
    dot = partial(v.dot, axis_name=axis_name)
    nrm2 = partial(v.nrm2, axis_name=axis_name)
    inner = inner._replace(axis_name=axis_name)
    As = _ShiftedPencil(A, B, sigma)
    x = x0 / nrm2(x0)
    rh = _history(x0, maxiter)
    ev = torch.zeros((), dtype=x0.dtype, device=x0.device)
    resid = torch.tensor(float("inf"), dtype=rh.dtype, device=x0.device)
    it = 1
    while it <= maxiter and bool(resid > tol):
        y = _finite(_raw_solve(As, B.matvec(x), inner))
        theta = dot(x, y)
        x = y / nrm2(y)
        ev = sigma + 1.0 / theta
        resid = nrm2(A.matvec(x) - ev * B.matvec(x)) / _den(ev)
        rh[it] = resid
        it += 1
    return it - 1, x, ev, resid, rh


# ---- RQI --------------------------------------------------------------------

def _rqi_run(A, B, x0, maxiter, tol, inner, axis_name=None):
    """Rayleigh-quotient iteration's device loop (lis_tpu ``_erqi_runner``,
    and ``_egrqi_runner`` with a B: the shift follows x·Ax / x·Bx).

    The shift moves only while the residual halves (otherwise it stays,
    and the step is plain inverse iteration).  An inner solve with no
    finite part (a shift on an eigenvalue) keeps the last iterate and
    nudges the shift to σ·(1 + 1e-6) + 1e-12; three in a row end the loop,
    which then reports BREAKDOWN (power.py:545-566, 600-627)."""
    dot = partial(v.dot, axis_name=axis_name)
    nrm2 = partial(v.nrm2, axis_name=axis_name)
    inner = inner._replace(axis_name=axis_name)
    x = x0 / nrm2(x0)
    bx = x if B is None else B.matvec(x)
    sigma = dot(x, A.matvec(x)) / dot(x, bx)
    ev = sigma
    rh = _history(x0, maxiter)
    resid = torch.tensor(float("inf"), dtype=rh.dtype, device=x0.device)
    badcnt = torch.zeros((), dtype=torch.int64, device=x0.device)
    it = 1
    while it <= maxiter and bool((resid > tol) & (badcnt < 3)):
        if B is None:
            y = _raw_solve(_Shifted(A, sigma), x, inner)
        else:
            y = _raw_solve(_ShiftedPencil(A, B, sigma), B.matvec(x), inner)
        # a near-singular shift makes the inner Krylov solve blow up in the
        # target eigendirection, which is RQI working: keep the finite part
        y = _finite(y)
        ynrm = nrm2(y)
        bad = ~torch.isfinite(ynrm) | (ynrm == 0.0)
        xn = torch.where(bad, x, y / torch.where(ynrm == 0, 1.0, ynrm))
        axn = A.matvec(xn)
        bxn = xn if B is None else B.matvec(xn)
        evn = dot(xn, axn) / dot(xn, bxn)
        residn = nrm2(axn - evn * bxn) / _den(evn)
        move = (residn < 0.5 * resid) | ~torch.isfinite(resid)
        sigman = torch.where(move, evn, sigma)
        rh[it] = residn
        retry = sigma * (1.0 + 1e-6) + 1e-12
        x = torch.where(bad, x, xn)
        sigma = torch.where(bad, retry, sigman)
        ev = torch.where(bad, ev, evn)
        resid = torch.where(bad, resid, residn)
        badcnt = torch.where(bad, badcnt + 1, 0)
        it += 1
    return it - 1, x, ev, resid, rh, badcnt >= 3


@register_esolver("rqi")
def erqi(A, B, x0, opts):
    """Rayleigh-quotient iteration (lis_erqi): the shift follows the
    Rayleigh quotient, for cubic local convergence.  The device loop runs
    at -shift 0 when ``_raw_inner_ok`` holds."""
    if opts.rval == 0.0 and _raw_inner_ok(opts):
        return _loop_result(opts.tol, *_rqi_run(
            A, B, x0, opts.maxiter, opts.tol, _inner_spec(opts)))
    x = x0 / v.nrm2(x0)
    bx = x if B is None else B.matvec(x)
    sigma = complex(v.dot(x, A.matvec(x)) / v.dot(x, bx)).real
    evalue, resid = sigma, np.inf
    rh = []
    status = C.LIS_MAXITER
    iters = opts.maxiter
    for it in range(1, opts.maxiter + 1):
        rhs = x if B is None else B.matvec(x)
        y = _shift_solve(A, B, sigma, rhs, opts)
        ynrm = float(v.nrm2(y))
        if not np.isfinite(ynrm) or ynrm == 0.0:
            # the shifted system went singular at convergence: keep the
            # last good iterate (the reference's inner BiCG breaks down
            # the same way once σ hits the eigenvalue)
            status, iters = (C.LIS_SUCCESS if resid <= opts.tol * 1e3
                             else C.LIS_BREAKDOWN), it
            break
        x = y / ynrm
        bx = x if B is None else B.matvec(x)
        evalue = complex(v.dot(x, A.matvec(x)) / v.dot(x, bx)).real
        new_resid = float(v.nrm2(A.matvec(x) - evalue * bx) /
                          (abs(evalue) if evalue != 0 else 1.0))
        # move the shift only while the residual improves; otherwise hold
        # it, falling back to plain inverse iteration (a shift parked on
        # an eigenvalue makes the inner system singular)
        if new_resid < 0.5 * resid or not np.isfinite(resid):
            sigma = evalue
        resid = new_resid
        rh.append(resid)
        if resid <= opts.tol:
            status, iters = C.LIS_SUCCESS, it
            break
    return _result(evalue, x, iters, resid, status, rh)
