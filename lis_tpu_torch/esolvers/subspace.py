"""Subspace eigensolvers: SI (subspace iteration), LI (Lanczos) and AI
(Arnoldi).

Port of ``lis_tpu/esolvers/subspace.py`` (reference lis_esi,
src/esolver/lis_esolver_si.c:137; lis_eli, lis_esolver_li.c:149:
tridiagonalise, then dense QR via lis_array_qr :253, then refine each
Ritz pair with the inner esolver; lis_eai, lis_esolver_ai.c:151).

The Krylov factorisations (Lanczos' three-term recurrence, Arnoldi's MGS)
are matvecs and inner products on the matrix's device, their
coefficients read on the host step by step; the small projected
eigenproblem is solved on the host by numpy (``eigh`` / ``eig``, as in
lis_tpu, so the pairs come out in the same order).  lis_tpu's
operator-only branch of ``_gen_op`` (the distributed ``GlobalView``,
subspace.py:42-48) comes with the distributed layer (ROADMAP.md queue 1
item 13).
"""

from __future__ import annotations

import numpy as np
import torch

from lis_tpu_torch import config as C
from lis_tpu_torch.core import vector as v
from lis_tpu_torch.esolvers.base import register_esolver
from lis_tpu_torch.esolvers.power import (_bsolve, _eii_run,
                                          _inner_precision, _inner_spec,
                                          _shift_solve)
from lis_tpu_torch.matrix.base import host

# What a failed inner solve of ``_refine_pair`` raises (a zero pivot of an
# inner ILU, a singular shifted system); a kernel's build or launch
# failure (RuntimeError) is not among them and propagates
_INNER_SOLVE_FAILURES = (ArithmeticError, np.linalg.LinAlgError,
                         torch.linalg.LinAlgError)


def _multi_result(evalues, evectors, iters, resids, status, rh):
    """An EsolveResult of several pairs; ``evectors`` are device tensors,
    the first is the result's ``evector`` and all go to the host as
    ``evectors``."""
    from lis_tpu_torch.esolvers.driver import EsolveResult
    evalues = np.asarray(evalues)
    return EsolveResult(evalue=float(np.real(evalues[0])),
                        evector=evectors[0],
                        iters=int(iters[0]), resid=float(resids[0]),
                        status=status,
                        evalues=np.real(evalues),
                        evectors=np.stack([host(x) for x in evectors]),
                        iters_all=np.asarray(iters),
                        resids_all=np.asarray(resids),
                        rhistory=np.asarray(rh))


def _gen_op(A, B, opts):
    """The operator x -> B⁻¹Ax of the generalized problem (B None: A),
    its B-solve through the driver."""
    if B is None:
        return A.matvec
    from lis_tpu_torch.solvers.driver import solve

    def op(x):
        z = A.matvec(x)
        return solve(B, z, solver=opts.inner.solver, precon=opts.inner.precon,
                     maxiter=opts.inner.maxiter, tol=1e-13,
                     precision=_inner_precision(opts)).x
    return op


def _pair_resid(A, B, lam, x):
    bx = x if B is None else B.matvec(x)
    den = abs(lam) if lam != 0 else 1.0
    return float(v.nrm2(A.matvec(x) - lam * bx) / den)


def _refine_pair(A, B, lam, x, opts):
    """Polish a Ritz pair by fixed-shift inverse iteration (the reference's
    per-pair refinement by the inner esolver, lis_esolver_li.c:576).  The
    shift stays at the Ritz value: moving it onto the converging eigenvalue
    makes the inner system singular and stalls the inner Krylov solve.

    The standard problem runs II's device loop (50 steps at most, raw
    inner solves of ``_raw_inner_name``'s solver, as lis_tpu runs its
    compiled loop there); a pencil runs the host loop through the driver."""
    resid = _pair_resid(A, B, lam, x)
    if resid <= opts.tol:
        return lam, x, resid
    if B is None:
        As = A.shift_diagonal(lam)
        iters, xr, ev, res, rh = _eii_run(As, A, x, float(lam), 50,
                                          opts.tol, _inner_spec(opts))
        res = float(res)
        if np.isfinite(res) and res < resid:
            return complex(ev).real, xr, res
        return lam, x, resid
    sigma = lam
    for _ in range(min(max(opts.maxiter, 10), 50)):
        if resid <= opts.tol:
            break
        try:
            y = _shift_solve(A, B, sigma, B.matvec(x), opts)
        except _INNER_SOLVE_FAILURES:
            break
        nrm = float(v.nrm2(y))
        if not np.isfinite(nrm) or nrm == 0.0:
            break
        x = y / nrm
        lam = complex(v.dot(x, A.matvec(x)) / v.dot(x, B.matvec(x))).real
        resid = _pair_resid(A, B, lam, x)
    return lam, x, resid


def _ritz_pairs(A, B, opts, Qm, evalues, vecs, ss):
    """The ss Ritz pairs Qm·s (each normalised), refined by
    ``_refine_pair`` unless -rval true asks for the raw pairs
    (lis_esolver_li.c's ``if (rval) return LIS_SUCCESS`` branch,
    lis_esolver_ai.c:313).  Returns (evalues, evectors, resids, status)."""
    ritz_only = opts.ritz_only
    evectors, resids = [], []
    for idx in range(ss):
        xi = Qm @ torch.from_numpy(np.ascontiguousarray(vecs[idx])).to(
            Qm.device, Qm.dtype)
        nrm = v.nrm2(xi)
        xi = xi / torch.where(nrm == 0, torch.ones_like(nrm), nrm)
        if ritz_only:
            res = _pair_resid(A, B, float(evalues[idx]), xi)
        else:
            lam, xi, res = _refine_pair(A, B, float(evalues[idx]), xi, opts)
            evalues[idx] = lam
        evectors.append(xi)
        resids.append(res)
    status = (C.LIS_SUCCESS if ritz_only
              or max(resids) <= max(opts.tol * 10, 1e-10)
              else C.LIS_MAXITER)
    return evalues, evectors, resids, status


@register_esolver("li")
def eli(A, B, x0, opts):
    """Lanczos (lis_eli): tridiagonalisation with full reorthogonalisation,
    a dense eigh of T on the host, fixed-shift II refinement of each Ritz
    pair (lis_esolver_li.c:253,576).

    As in lis_tpu (a deliberate divergence from the reference, which runs
    ss − 1 Lanczos steps and reports refined Ritz values in QR order): the
    Krylov dimension is max(2·ss, ss + 8) and the ss pairs are the
    dominant Ritz values."""
    n = A.nrows
    ss = min(max(opts.ss, 1), n)
    m = min(max(2 * ss, ss + 8), n)       # Krylov dimension >= pairs asked
    op = _gen_op(A, B, opts)

    q = x0 / v.nrm2(x0)
    Q = [q]
    alphas, betas = [], []
    beta = 0.0
    qm1 = torch.zeros_like(q)
    for j in range(m):
        w = op(Q[-1])
        alpha = complex(v.dot(Q[-1], w)).real
        w = w - alpha * Q[-1] - beta * qm1
        # full reorthogonalisation
        for qq in Q:
            w = w - v.dot(qq, w) * qq
        beta = float(v.nrm2(w))
        alphas.append(alpha)
        if j + 1 < m:
            betas.append(beta)
            if beta == 0.0:
                break
            qm1 = Q[-1]
            Q.append(w / beta)

    k = len(alphas)
    T = np.diag(np.asarray(alphas))
    if k > 1:
        off = np.asarray(betas[: k - 1])
        T += np.diag(off, 1) + np.diag(off, -1)
    w_eig, s_eig = np.linalg.eigh(T)
    # largest magnitude first (the reference returns the dominant pairs)
    order = np.argsort(-np.abs(w_eig))[:ss]
    evalues = np.array(w_eig[order], dtype=float)
    Qm = torch.stack(Q[:k], dim=1)
    evalues, evectors, resids, status = _ritz_pairs(
        A, B, opts, Qm, evalues, [s_eig[:, order[i]] for i in range(ss)], ss)
    return _multi_result(evalues, evectors, [k] * ss, resids, status,
                         resids)


@register_esolver("ai")
def eai(A, B, x0, opts):
    """Arnoldi (lis_eai): MGS Hessenberg factorisation, a dense eig of H on
    the host."""
    n = A.nrows
    ss = min(max(opts.ss, 1), n)
    m = min(max(2 * ss, ss + 8), n)
    op = _gen_op(A, B, opts)

    q = x0 / v.nrm2(x0)
    Q = [q]
    H = np.zeros((m + 1, m), dtype=host(x0).dtype)
    k = m
    for j in range(m):
        w = op(Q[j])
        for i in range(j + 1):
            h = complex(v.dot(Q[i], w)) \
                if np.iscomplexobj(H) else float(v.dot(Q[i], w))
            H[i, j] = h
            w = w - h * Q[i]
        hn = float(v.nrm2(w))
        H[j + 1, j] = hn
        if hn == 0.0:
            k = j + 1
            break
        if j + 1 < m:
            Q.append(w / hn)

    w_eig, s_eig = np.linalg.eig(H[:k, :k])
    order = np.argsort(-np.abs(w_eig))[:ss]
    evalues = np.real(np.array(w_eig[order]))
    vecs = []
    for idx in range(ss):
        vec = s_eig[:, order[idx]]
        if np.iscomplexobj(vec) and np.abs(vec.imag).max() < 1e-13:
            vec = vec.real
        vecs.append(np.real(vec))
    Qm = torch.stack(Q[:k], dim=1)
    evalues, evectors, resids, status = _ritz_pairs(A, B, opts, Qm, evalues,
                                                    vecs, ss)
    return _multi_result(evalues, evectors, [k] * ss, resids, status,
                         resids)


@register_esolver("si")
def esi(A, B, x0, opts):
    """Subspace iteration (lis_esi, src/esolver/lis_esolver_si.c:230-330):
    sequential deflated iteration.  Pair j is orthogonalised against the
    converged v_1..v_{j-1} every sweep; the kernel is the inner esolver's
    map (-ie ii, the default: an inverse solve per sweep, so the smallest
    pairs come out first; -ie pi: a matvec, the largest).  Always the host
    loop.

    The first pair starts from x0.  lis_tpu starts pair j >= 2 from the
    vector pair j − 1 ended on, which the deflation then removes: what is
    left is rounding noise, so whether and in how many sweeps those pairs
    converge depends on the order of a dot product's sum (ROADMAP.md queue
    3).  Here pair j >= 2 starts from a seeded random vector (numpy
    ``default_rng(j)``), deflated like any other, so the later pairs do
    not rest on rounding."""
    n = A.nrows
    ss = min(max(opts.ss, 1), n)
    inner = opts.inner_esolver
    sigma = opts.rval

    vs = []
    evalues, resids, iters_all, rh = [], [], [], []
    status = C.LIS_SUCCESS
    for j in range(ss):
        if j == 0:
            vj = x0 / v.nrm2(x0)
        else:
            vj = torch.from_numpy(np.random.default_rng(j).standard_normal(
                n)).to(x0.device, x0.dtype)
            vj = vj / v.nrm2(vj)
        resid = np.inf
        theta = 0.0
        it = opts.maxiter
        for k in range(1, opts.maxiter + 1):
            for vk in vs:
                # project out vk: the coefficient is <vk, vj>, conjugate on
                # vk's side (dot(vj, vk) would deflate the wrong component
                # of complex operands)
                vj = vj - v.dot(vk, vj) * vk
            if inner == "pi":
                rnew = A.matvec(vj) if B is None else _bsolve(
                    B, A.matvec(vj), opts)
            else:
                rhs = vj if B is None else B.matvec(vj)
                rnew = _shift_solve(A, B, sigma, rhs, opts)
            nrm = float(v.nrm2(rnew))
            if not np.isfinite(nrm) or nrm == 0.0:
                break
            theta = complex(v.dot(vj, rnew)).real
            resid = float(v.nrm2(rnew - theta * vj) /
                          (abs(theta) if theta != 0 else 1.0))
            vj = rnew / nrm
            if j == 0:
                rh.append(resid)
            if resid < opts.tol:
                it = k
                break
        if inner == "pi":
            lam = theta + sigma
        else:
            lam = (1.0 / theta if theta != 0 else 0.0) + sigma
        evalues.append(lam)
        resids.append(resid)
        iters_all.append(it)
        vs.append(vj)
        if resid > opts.tol:
            status = C.LIS_MAXITER
    return _multi_result(np.asarray(evalues), vs, iters_all, resids,
                         status, rh)
