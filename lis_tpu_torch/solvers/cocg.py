"""COCG and COCR — the complex-symmetric solvers.

Port of ``lis_tpu/solvers/cocg.py`` (reference lis_cocg,
src/solver/lis_solver_cg.c:632, and lis_cocr, :1155).  The loops of CG
and CR with the unconjugated bilinear form ``nhdot`` (lis_vector_nhdot)
in place of the Hermitian inner product, which A = Aᵀ allows.
"""

from __future__ import annotations

import torch

from lis_tpu_torch import config as C
from lis_tpu_torch.core import vector as v
from lis_tpu_torch.solvers.base import (RUNNING, SolverOutput, SolverSpec,
                                        init_residual, krylov_loop,
                                        loop_output, loop_scalar,
                                        new_rhistory, record,
                                        register_solver, residual_norm)


@register_solver("cocg")
def cocg(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, b.real.dtype)
    one = torch.ones((), dtype=b.dtype, device=b.device)

    state = dict(it=loop_scalar(1, b), flag=loop_scalar(RUNNING, b),
                 x=x0, r=r, p=torch.zeros_like(b), rho_old=one,
                 nrm=nrm0, rh=rh)

    def step(s):
        z = M.psolve(s["r"])
        rho = v.nhdot(s["r"], z, spec.axis_name)
        beta = rho / s["rho_old"]
        p = z + beta * s["p"]
        q = A.matvec(p)
        dot_pq = v.nhdot(p, q, spec.axis_name)
        broke = dot_pq == 0.0
        alpha = rho / torch.where(broke, one, dot_pq)
        x = s["x"] + alpha * p
        r = s["r"] - alpha * q
        nrm = residual_norm(r, bnrm_inv, spec)

        def keep(new, old):
            return torch.where(broke, old, new)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=keep(x, s["x"]), r=keep(r, s["r"]), p=p,
                    rho_old=keep(rho, s["rho_old"]),
                    nrm=keep(nrm, s["nrm"]),
                    rh=record(s["rh"], s["it"], keep(nrm, s["nrm"])))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)


@register_solver("cocr")
def cocr(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, b.real.dtype)
    one = torch.ones((), dtype=b.dtype, device=b.device)

    p = M.psolve(r)
    q = A.matvec(p)

    state = dict(it=loop_scalar(1, b), flag=loop_scalar(RUNNING, b),
                 x=x0, r=r, z=p, p=p, q=q, nrm=nrm0, rh=rh)

    def step(s):
        qtld = M.psolve(s["q"])
        rho = v.nhdot(qtld, s["q"], spec.axis_name)
        broke = rho == 0.0
        rho_safe = torch.where(broke, one, rho)
        alpha = v.nhdot(s["r"], qtld, spec.axis_name) / rho_safe
        x = s["x"] + alpha * s["p"]
        r = s["r"] - alpha * s["q"]
        nrm = residual_norm(r, bnrm_inv, spec)
        z = s["z"] - alpha * qtld
        az = A.matvec(z)
        beta = -v.nhdot(az, qtld, spec.axis_name) / rho_safe
        p = z + beta * s["p"]
        q = az + beta * s["q"]

        def keep(new, old):
            return torch.where(broke, old, new)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=keep(x, s["x"]), r=keep(r, s["r"]), z=keep(z, s["z"]),
                    p=keep(p, s["p"]), q=keep(q, s["q"]),
                    nrm=keep(nrm, s["nrm"]),
                    rh=record(s["rh"], s["it"], keep(nrm, s["nrm"])))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)
