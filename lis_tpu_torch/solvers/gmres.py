"""GMRES(m) and FGMRES(m).

Port of ``lis_tpu/solvers/gmres.py`` (reference lis_gmres,
src/solver/lis_solver_gmres.c:135, and lis_fgmres, :1128): restarted,
right-preconditioned GMRES with modified Gram-Schmidt and Givens rotations
applied as the columns arrive; -restart m (default 40).

The Krylov basis is an (m+1, n) tensor on the operator's device, and the
Arnoldi step runs there: psolve, matvec, then for each earlier basis
vector one dot and one update (modified Gram-Schmidt, in lis_tpu's order:
t = ⟨w, v_k⟩, w ← w − t·v_k), the norm and the new basis vector.  The
Hessenberg column is read to the host once per step, where the rotations,
the residual estimate |s[i+1]| (which drives the loop, as in the
reference) and the small upper-triangular solve at each restart run in
numpy, in lis_tpu's order of operations.  A restart recomputes its
residual with a fresh matvec (lis_tpu :109).  The loop reads the device
once per step anyway, like the other solvers' loops.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch

from lis_tpu_torch import config as C
from lis_tpu_torch.core import vector as v
from lis_tpu_torch.solvers.base import (SolverOutput, SolverSpec,
                                        init_residual, register_solver)


def _host(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _gmres_core(A, b, x0, M, spec: SolverSpec, flexible: bool):
    m = spec.restart
    n = b.shape[0]
    dev = b.device
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    dt = b.dtype
    hdt = torch.empty(0, dtype=dt).numpy().dtype        # host scalar type
    rdt = torch.empty(0, dtype=b.real.dtype).numpy().dtype
    scale = _host(bnrm_inv).astype(rdt) if spec.conv_cond != 2 else rdt.type(1)
    tol = float(_host(tol_eff))
    nrm = _host(nrm0).astype(rdt)
    rh = np.full(spec.maxiter + 2, np.nan, dtype=rdt)
    rh[0] = nrm
    x, it = x0, 1
    while it <= spec.maxiter and nrm > tol:
        rnorm = v.nrm2(r, spec.axis_name)
        V = torch.zeros((m + 1, n), dtype=dt, device=dev)
        V[0] = r / torch.where(rnorm == 0, torch.ones_like(rnorm), rnorm)
        Z = torch.zeros((m, n), dtype=dt, device=dev) if flexible else None
        H = np.zeros((m + 1, m), dtype=hdt)
        cs = np.zeros(m + 1, dtype=hdt)
        sn = np.zeros(m + 1, dtype=hdt)
        svec = np.zeros(m + 2, dtype=hdt)
        svec[0] = _host(rnorm)
        i = 0
        while i < m and it <= spec.maxiter and nrm > tol:
            z = M.psolve(V[i])
            w = A.matvec(z)
            if flexible:
                Z[i] = z
            # modified Gram-Schmidt against v_0 .. v_i
            col = []
            for k in range(i + 1):
                t = v.dot(w, V[k], spec.axis_name)
                w = w - t * V[k]
                col.append(t)
            t = v.nrm2(w, spec.axis_name)
            V[i + 1] = w / torch.where(t == 0, torch.ones_like(t), t)
            col.append(t.to(dt))
            H[: i + 2, i] = torch.stack(col).cpu().numpy()   # one host read
            # the earlier rotations on column i, then a new one
            for k in range(i):
                a = cs[k] * H[k, i] + sn[k] * H[k + 1, i]
                bval = -sn[k] * H[k, i] + cs[k] * H[k + 1, i]
                H[k, i], H[k + 1, i] = a, bval
            aa, bb = H[i, i], H[i + 1, i]
            rr = np.sqrt(aa * aa + bb * bb)
            if rr == 0.0:
                rr = hdt.type(1.0e-17)
            ci, si = aa / rr, bb / rr
            cs[i], sn[i] = ci, si
            svec[i + 1] = -si * svec[i]
            svec[i] = ci * svec[i]
            H[i, i] = ci * H[i, i] + si * H[i + 1, i]
            nrm = np.abs(svec[i + 1]) * scale
            rh[min(it, spec.maxiter + 1)] = nrm
            if spec.live_print:
                print(f"iteration: {it:5d}  relative residual = {nrm:e}",
                      flush=True)
            i += 1
            it += 1
        y = scipy.linalg.solve_triangular(H[:i, :i], svec[:i], lower=False)
        yd = torch.from_numpy(np.ascontiguousarray(y, dtype=hdt)).to(dev)
        if flexible:
            dx = Z[:i].T @ yd
        else:
            dx = M.psolve(V[:i].T @ yd)
        x = x + dx
        r = b - A.matvec(x)

    status = C.LIS_SUCCESS if nrm <= tol else C.LIS_MAXITER
    return SolverOutput(
        x=x, status=torch.tensor(status),
        iters=torch.tensor(min(max(it - 1, 1), spec.maxiter)),
        resid=torch.tensor(nrm), rhistory=torch.from_numpy(rh))


@register_solver("gmres")
def gmres(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    return _gmres_core(A, b, x0, M, spec, flexible=False)


@register_solver("fgmres")
def fgmres(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    return _gmres_core(A, b, x0, M, spec, flexible=True)
