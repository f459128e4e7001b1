"""CG and CR eigensolvers (smallest eigenvalue).

Port of ``lis_tpu/esolvers/cgcr.py`` (reference lis_ecg,
src/esolver/lis_esolver_cg.c:126: Rayleigh-Ritz on span{w, x, p}, its 3×3
generalized eigenproblem solved by inverse iteration; lis_ecr, :780:
conjugate-residual minimisation of ||Ax − λx||).  Both take the spectral
shift -shift σ (A − σI) and a psolve from the inner options (default
none).  Each outer iteration is a Python loop step over device tensors
with one host read, as ``solvers/base.py::krylov_loop`` does.

The 3×3 Rayleigh-Ritz of -e cg stays lis_tpu's formula: Cramer's rule,
exactly 30 inverse iterations (cgcr.py:100-114, 218-252).  It runs on
the host in Python floats from the 12 inner products read with the
convergence test, so each iteration reads the device once; on the card
those 30 tiny iterations would be hundreds of launches.

The loops take lis_tpu's ``axis_name`` (None, or the ``Mesh`` of a
distributed eigensolve).  Inner products that no update separates are
formed as one stack of local partials (``_dots``), which a mesh
all-reduces in one collective: each product's arithmetic is the one
``v.dot`` does, and a mesh that stages its collectives through the host
makes one round trip where it would make up to 13.
"""

from __future__ import annotations

import math
from functools import partial

import numpy as np
import torch

from lis_tpu_torch import config as C
from lis_tpu_torch.core import vector as v
from lis_tpu_torch.esolvers.base import register_esolver
from lis_tpu_torch.esolvers.power import (_GenOp, _den, _history,
                                          _inner_spec, _result)
from lis_tpu_torch.matrix.base import host
from lis_tpu_torch.precon.base import NonePrecon, create_precon


def _make_psolve(A, opts):
    name = opts.inner.precon if opts.inner else "none"
    if name == "none":
        return NonePrecon()
    return create_precon(name, A, opts.inner)


@register_esolver("cg")
def ecg(A, B, x0, opts):
    """CG eigensolver (lis_ecg): the smallest eigenvalue of A, or of the
    pencil (A, B) with explicit B products (lis_egcg)."""
    sigma = opts.rval
    if sigma != 0.0:
        A = A.shift_diagonal(sigma)
    M = _make_psolve(A, opts)

    x = x0 / v.nrm2(x0)
    # p = A⁻¹x (one inner CG solve through the driver,
    # lis_esolver_cg.c:213)
    from lis_tpu_torch.solvers.driver import solve as lsolve
    p = lsolve(A, x, solver="cg", precon="none", tol=1e-10,
               maxiter=opts.inner.maxiter).x
    # (for a pencil lis_tpu also forms B⁻¹Ax here, cgcr.py:48, and never
    # reads it; the port leaves that inner solve out)
    iters, x, lam, resid, rh = _ecg_run(A, B, M, x, p, opts.maxiter,
                                        opts.tol)
    status = (C.LIS_SUCCESS if float(resid) < opts.tol
              else C.LIS_MAXITER)
    return _result(float(lam.real) + sigma, x, iters, float(resid), status,
                   host(rh)[1:iters + 1])


def _dots(pairs, axis_name=None):
    """The inner products <a, b> of ``pairs`` (``v.dot``'s, conjugating a
    for complex) as one tensor, all-reduced over the mesh ``axis_name``
    in one collective (lis_tpu's psum of each)."""
    local = torch.stack([torch.vdot(a, b) if a.is_complex()
                         else torch.dot(a, b) for a, b in pairs])
    return v._reduced(local, axis_name)


def _norms(xs, axis_name=None):
    """The 2-norms of ``xs`` (``v.nrm2``'s), with one collective."""
    return torch.sqrt(_dots([(x, x) for x in xs], axis_name).real)


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _solve3(m, rhs):
    """m⁻¹·rhs by Cramer's rule (lis_tpu ``solve3``; m as its columns)."""
    c0 = _cross(m[1], m[2])
    det = _dot3(m[0], c0)
    if det == 0:
        det = 1.0
    return (_dot3(rhs, c0) / det, _dot3(m[0], _cross(rhs, m[2])) / det,
            _dot3(m[0], _cross(m[1], rhs)) / det)


def _ritz3(a3, b3):
    """The 3×3 pencil's eigenvector by 30 steps of inverse iteration from
    ones, each normalised, a step with a non-finite result discarded
    (lis_tpu ``inv_it``).  a3 and b3 are row-major tuples of rows."""
    cols = tuple(tuple(a3[i][j] for i in range(3)) for j in range(3))
    v3 = (1.0, 1.0, 1.0)
    for _ in range(30):
        nrm = math.sqrt(sum(abs(c) ** 2 for c in v3))
        v3 = tuple(c / nrm for c in v3)
        z3 = _solve3(cols, tuple(_dot3(row, v3) for row in b3))
        if all(np.isfinite(c) for c in z3):
            v3 = z3
    return v3


def _ecg_run(A, B, M, x, p, maxiter, tol, axis_name=None):
    """The CG eigeniteration (lis_tpu ``_ecg_run``, and ``_egcg_run`` with a
    B: the pencil's Rayleigh-Ritz, with r = Bx − Ax/λ and λ = (Ax·Bx) /
    (Bx·Bx), as in the reference).  A step whose residual met tol counts
    in ``iters`` but leaves x, p and their products as they were
    (lis_tpu's ``keep`` mask, cgcr.py:128-131 and :267-270).  Under a
    mesh an iteration makes four collectives: λ, ‖w‖, ‖r‖ with the 12
    products, and the two new norms."""
    rh = _history(x, maxiter)
    Ax, Ap = A.matvec(x), x          # p = A⁻¹x from the set-up solve
    Bx = Bp = None
    if B is not None:
        Bx, Bp = B.matvec(x), B.matvec(p)
    lam = torch.zeros((), dtype=x.dtype, device=x.device)
    resid = float("inf")
    it = 1
    while it <= maxiter and resid >= tol:
        if B is None:
            lam = v.dot(x, Ax, axis_name=axis_name)
            r = x - (1.0 / lam) * Ax
        else:
            ab, bb = _dots([(Ax, Bx), (Bx, Bx)], axis_name)
            lam = ab / bb
            r = Bx - (1.0 / lam) * Ax
        w = M.psolve(r)
        w = w / v.nrm2(w, axis_name=axis_name)
        Aw = A.matvec(w)
        # the standard problem's B3 holds the inner products of w, x, p
        Bw, Bx_, Bp_ = (w, x, p) if B is None else (B.matvec(w), Bx, Bp)
        # one read: ‖r‖² and the 12 inner products of the pencil
        prods = _dots([(r, r), (w, Aw), (x, Aw), (p, Aw), (x, Ax),
                       (p, Ax), (p, Ap), (w, Bw), (x, Bw), (p, Bw),
                       (x, Bx_), (p, Bx_), (p, Bp_)], axis_name)
        rh[it] = torch.sqrt(prods[0].real)
        vals = prods.tolist()
        # the host's sqrt and the device's are both correctly rounded
        resid = math.sqrt(vals[0].real)
        wa, xa, pa, xx, px, pp = vals[1:7]
        wb, xb, pb, xbx, pbx, pbp = vals[7:13]
        a3 = ((wa, xa, pa), (xa, xx, px), (pa, px, pp))
        b3 = ((wb, xb, pb), (xb, xbx, pbx), (pb, pbx, pbp))
        it += 1
        if resid < tol:
            break                   # lis_tpu's keep: the state stays
        c0, c1, c2 = _ritz3(a3, b3)
        w2 = c0 * w + c2 * p
        xn = w2 + c1 * x
        Aw2 = c0 * Aw + c2 * Ap
        Axn = Aw2 + c1 * Ax
        nx, npn = _norms([xn, w2], axis_name)
        x, Ax = xn / nx, Axn / nx
        p, Ap = w2 / npn, Aw2 / npn
        if B is not None:
            Bw2 = c0 * Bw + c2 * Bp
            Bx = (Bw2 + c1 * Bx) / nx
            Bp = Bw2 / npn
    return it - 1, x, lam, resid, rh


@register_esolver("cr")
def ecr(A, B, x0, opts):
    """CR eigensolver (lis_ecr): conjugate-residual iteration on the
    Rayleigh quotient, the reference's default eigensolver.  For a pencil
    it iterates B⁻¹A, each product a raw inner solve with B."""
    sigma = opts.rval
    if sigma != 0.0:
        A = A.shift_diagonal(sigma)
    M = _make_psolve(A, opts)

    x = x0 / v.nrm2(x0)
    op = A if B is None else _GenOp(A, B, _inner_spec(opts))
    iters, x, lam, resid, rh = _ecr_run(op, M, x, opts.maxiter, opts.tol)
    status = (C.LIS_SUCCESS if float(resid) < opts.tol
              else C.LIS_MAXITER)
    return _result(float(lam.real) + sigma, x, iters, float(resid), status,
                   host(rh)[1:iters + 1])


def _ecr_run(A, M, x, maxiter, tol, axis_name=None):
    """The CR eigeniteration's device loop (lis_tpu ``_ecr_run``): three
    collectives an iteration under a mesh, one for each group of
    products that no update separates."""
    dots = partial(_dots, axis_name=axis_name)
    Ax = A.matvec(x)
    lam = v.dot(x, Ax, axis_name=axis_name)
    r = -(Ax - lam * x)
    p = r
    Ap = A.matvec(p)
    rh = _history(x, maxiter)
    resid = torch.tensor(float("inf"), dtype=rh.dtype, device=x.device)
    it = 1
    while it <= maxiter and bool(resid >= tol):
        rAp, rp, ApAp, pAp, pp = dots([(r, Ap), (r, p), (Ap, Ap), (p, Ap),
                                       (p, p)])
        den = ApAp - 2.0 * lam * pAp + lam * lam * pp
        den = torch.where(den == 0, torch.ones_like(den), den)
        alpha = (rAp - lam * rp) / den
        x = x + alpha * p
        Ax = A.matvec(x)
        xAx, xx = dots([(x, Ax), (x, x)])
        lam = xAx / (torch.sqrt(xx.real) ** 2)
        r = -(Ax - lam * x)
        w = M.psolve(r)
        Aw = A.matvec(w)
        AwAp, pAw, wAp, wp, rr = dots([(Aw, Ap), (p, Aw), (w, Ap), (w, p),
                                       (r, r)])
        beta = -(AwAp - lam * (pAw + wAp) + lam * lam * wp) / den
        p = w + beta * p
        Ap = Aw + beta * Ap
        resid = torch.sqrt(rr.real) / _den(lam)
        rh[it] = resid
        it += 1
    return it - 1, x / v.nrm2(x, axis_name=axis_name), lam, resid, rh
