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
lis_tpu, so the pairs come out in the same order).

Each eigensolver takes lis_tpu's ``axis_name``: None, or the ``Mesh`` of
a distributed eigensolve (``parallel/dist_esolve.py``), where A and B
are a rank's shards behind its view.  Every dot and norm is then
all-reduced, so each rank reads the same coefficients, takes the same
branches and solves the same small eigenproblem on its host; ``Qm @ s``
stays a product over the rank's rows, and the B-solves and shifted
solves take lis_tpu's operator-only branch (subspace.py:42-48, raw
registry solves over the mesh).
"""

from __future__ import annotations

from functools import partial

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


def _gen_op(A, B, opts, axis_name=None):
    """The operator x -> B⁻¹Ax of the generalized problem (B None: A),
    its B-solve through the driver, or under a mesh ``_bsolve``'s raw
    solve over it (lis_tpu's operator-only branch)."""
    if B is None:
        return A.matvec
    if axis_name is not None:
        return lambda x: _bsolve(B, A.matvec(x), opts, axis_name)
    from lis_tpu_torch.solvers.driver import solve

    def op(x):
        z = A.matvec(x)
        return solve(B, z, solver=opts.inner.solver, precon=opts.inner.precon,
                     maxiter=opts.inner.maxiter, tol=1e-13,
                     precision=_inner_precision(opts)).x
    return op


def _pair_resid(A, B, lam, x, axis_name=None):
    bx = x if B is None else B.matvec(x)
    den = abs(lam) if lam != 0 else 1.0
    return float(v.nrm2(A.matvec(x) - lam * bx, axis_name) / den)


def _refine_pair(A, B, lam, x, opts, axis_name=None):
    """Polish a Ritz pair by fixed-shift inverse iteration (the reference's
    per-pair refinement by the inner esolver, lis_esolver_li.c:576).  The
    shift stays at the Ritz value: moving it onto the converging eigenvalue
    makes the inner system singular and stalls the inner Krylov solve.

    The standard problem runs II's device loop (50 steps at most, raw
    inner solves of ``_raw_inner_name``'s solver, as lis_tpu runs its
    compiled loop there); a pencil runs the host loop, its shifted solves
    through the driver (under a mesh raw solves over it)."""
    resid = _pair_resid(A, B, lam, x, axis_name)
    if resid <= opts.tol:
        return lam, x, resid
    if B is None:
        As = A.shift_diagonal(lam)
        iters, xr, ev, res, rh = _eii_run(As, A, x, float(lam), 50,
                                          opts.tol, _inner_spec(opts),
                                          axis_name)
        res = float(res)
        if np.isfinite(res) and res < resid:
            return complex(ev).real, xr, res
        return lam, x, resid
    sigma = lam
    for _ in range(min(max(opts.maxiter, 10), 50)):
        if resid <= opts.tol:
            break
        try:
            y = _shift_solve(A, B, sigma, B.matvec(x), opts, axis_name)
        except _INNER_SOLVE_FAILURES:
            break
        nrm = float(v.nrm2(y, axis_name))
        if not np.isfinite(nrm) or nrm == 0.0:
            break
        x = y / nrm
        lam = complex(v.dot(x, A.matvec(x), axis_name)
                      / v.dot(x, B.matvec(x), axis_name)).real
        resid = _pair_resid(A, B, lam, x, axis_name)
    return lam, x, resid


def _ritz_pairs(A, B, opts, Qm, evalues, vecs, ss, axis_name=None):
    """The ss Ritz pairs Qm·s (each normalised), refined by
    ``_refine_pair`` unless -rval true asks for the raw pairs
    (lis_esolver_li.c's ``if (rval) return LIS_SUCCESS`` branch,
    lis_esolver_ai.c:313).  Returns (evalues, evectors, resids, status)."""
    ritz_only = opts.ritz_only
    evectors, resids = [], []
    for idx in range(ss):
        xi = Qm @ torch.from_numpy(np.ascontiguousarray(vecs[idx])).to(
            Qm.device, Qm.dtype)
        nrm = v.nrm2(xi, axis_name)
        xi = xi / torch.where(nrm == 0, torch.ones_like(nrm), nrm)
        if ritz_only:
            res = _pair_resid(A, B, float(evalues[idx]), xi, axis_name)
        else:
            lam, xi, res = _refine_pair(A, B, float(evalues[idx]), xi, opts,
                                        axis_name)
            evalues[idx] = lam
        evectors.append(xi)
        resids.append(res)
    status = (C.LIS_SUCCESS if ritz_only
              or max(resids) <= max(opts.tol * 10, 1e-10)
              else C.LIS_MAXITER)
    return evalues, evectors, resids, status


@register_esolver("li")
def eli(A, B, x0, opts, axis_name=None):
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
    op = _gen_op(A, B, opts, axis_name)
    dot = partial(v.dot, axis_name=axis_name)
    nrm2 = partial(v.nrm2, axis_name=axis_name)

    q = x0 / nrm2(x0)
    Q = [q]
    alphas, betas = [], []
    beta = 0.0
    qm1 = torch.zeros_like(q)
    for j in range(m):
        w = op(Q[-1])
        alpha = complex(dot(Q[-1], w)).real
        w = w - alpha * Q[-1] - beta * qm1
        # full reorthogonalisation (each dot reads the w the last one
        # updated, so under a mesh each is a collective of its own)
        for qq in Q:
            w = w - dot(qq, w) * qq
        beta = float(nrm2(w))
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
        A, B, opts, Qm, evalues, [s_eig[:, order[i]] for i in range(ss)], ss,
        axis_name)
    return _multi_result(evalues, evectors, [k] * ss, resids, status,
                         resids)


@register_esolver("ai")
def eai(A, B, x0, opts, axis_name=None):
    """Arnoldi (lis_eai): MGS Hessenberg factorisation, a dense eig of H on
    the host."""
    n = A.nrows
    ss = min(max(opts.ss, 1), n)
    m = min(max(2 * ss, ss + 8), n)
    op = _gen_op(A, B, opts, axis_name)
    dot = partial(v.dot, axis_name=axis_name)
    nrm2 = partial(v.nrm2, axis_name=axis_name)

    q = x0 / nrm2(x0)
    Q = [q]
    H = np.zeros((m + 1, m), dtype=host(x0).dtype)
    k = m
    for j in range(m):
        w = op(Q[j])
        for i in range(j + 1):
            h = complex(dot(Q[i], w)) \
                if np.iscomplexobj(H) else float(dot(Q[i], w))
            H[i, j] = h
            w = w - h * Q[i]
        hn = float(nrm2(w))
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
                                                    vecs, ss, axis_name)
    return _multi_result(evalues, evectors, [k] * ss, resids, status,
                         resids)


def _si_start(A, j, x0, axis_name):
    """SI's start for pair j >= 2: ``default_rng(j)``'s normal vector of
    the global size; under a mesh padded to gn_pad and cut to the rank's
    rows (``A`` is then the rank's view, which knows gn)."""
    rng = np.random.default_rng(j)
    if axis_name is None:
        return torch.from_numpy(rng.standard_normal(A.nrows)).to(
            x0.device, x0.dtype)
    from lis_tpu_torch.parallel.dist import distribute_vector
    return distribute_vector(rng.standard_normal(A.gn), axis_name,
                             A.gn_pad).to(x0.dtype)


@register_esolver("si")
def esi(A, B, x0, opts, axis_name=None):
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
    not rest on rounding.  Under a mesh that vector is drawn at the
    global size and the rank takes its rows, so every mesh width starts
    from the serial solve's vector."""
    n = A.nrows
    ss = min(max(opts.ss, 1), n)
    inner = opts.inner_esolver
    sigma = opts.rval
    dot = partial(v.dot, axis_name=axis_name)
    nrm2 = partial(v.nrm2, axis_name=axis_name)

    vs = []
    evalues, resids, iters_all, rh = [], [], [], []
    status = C.LIS_SUCCESS
    for j in range(ss):
        if j == 0:
            vj = x0 / nrm2(x0)
        else:
            vj = _si_start(A, j, x0, axis_name)
            vj = vj / nrm2(vj)
        resid = np.inf
        theta = 0.0
        it = opts.maxiter
        for k in range(1, opts.maxiter + 1):
            for vk in vs:
                # project out vk: the coefficient is <vk, vj>, conjugate on
                # vk's side (dot(vj, vk) would deflate the wrong component
                # of complex operands)
                vj = vj - dot(vk, vj) * vk
            if inner == "pi":
                rnew = A.matvec(vj) if B is None else _bsolve(
                    B, A.matvec(vj), opts, axis_name)
            else:
                rhs = vj if B is None else B.matvec(vj)
                rnew = _shift_solve(A, B, sigma, rhs, opts, axis_name)
            nrm = float(nrm2(rnew))
            if not np.isfinite(nrm) or nrm == 0.0:
                break
            theta = complex(dot(vj, rnew)).real
            resid = float(nrm2(rnew - theta * vj) /
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
