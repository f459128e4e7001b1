"""CG and CR — the conjugate gradient/residual pair.

Port of ``lis_tpu/solvers/cg.py`` (reference lis_cg,
src/solver/lis_solver_cg.c:129, and lis_cr, :819).  The loop bodies keep
the reference's update order (psolve → dot → xpay → matvec → dots → axpys
→ convergence check) so iteration counts match; a breakdown freezes the
state as the JAX step does.
"""

from __future__ import annotations

import torch

from lis_tpu_torch import config as C
from lis_tpu_torch.core import vector as v
from lis_tpu_torch.solvers.base import (RUNNING, SolverOutput, SolverSpec,
                                        init_residual, krylov_loop,
                                        loop_output, new_rhistory, record,
                                        register_solver, residual_norm)


def _scalar(val, like):
    return torch.tensor(val, device=like.device)


@register_solver("cg")
def cg(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, b.real.dtype if b.is_complex()
                      else b.dtype)
    one = torch.ones((), dtype=b.dtype, device=b.device)

    state = dict(it=_scalar(1, b), flag=_scalar(RUNNING, b),
                 x=x0, r=r, p=torch.zeros_like(b), rho_old=one,
                 nrm=nrm0, rh=rh)

    def step(s):
        z = M.psolve(s["r"])
        rho = v.dot(s["r"], z)
        beta = rho / s["rho_old"]
        p = v.xpay(z, beta, s["p"])
        q = A.matvec(p)
        dot_pq = v.dot(p, q)
        broke = dot_pq == 0.0
        alpha = rho / torch.where(broke, one, dot_pq)
        x = s["x"] + alpha * p
        r = s["r"] - alpha * q
        nrm = residual_norm(r, bnrm_inv, spec)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=torch.where(broke, s["x"], x),
                    r=torch.where(broke, s["r"], r),
                    p=p, rho_old=rho,
                    nrm=torch.where(broke, s["nrm"], nrm),
                    rh=record(s["rh"], s["it"], nrm))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)


@register_solver("cr")
def cr(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, b.real.dtype if b.is_complex()
                      else b.dtype)
    one = torch.ones((), dtype=b.dtype, device=b.device)

    p = M.psolve(r)
    q = A.matvec(p)
    z = p

    state = dict(it=_scalar(1, b), flag=_scalar(RUNNING, b),
                 x=x0, r=r, z=z, p=p, q=q, nrm=nrm0, rh=rh)

    def step(s):
        qtld = M.psolve(s["q"])
        rho = v.dot(qtld, s["q"])
        broke = rho == 0.0
        rho_safe = torch.where(broke, one, rho)
        dot_rq = v.dot(s["r"], qtld)
        alpha = dot_rq / rho_safe
        x = s["x"] + alpha * s["p"]
        r = s["r"] - alpha * s["q"]
        nrm = residual_norm(r, bnrm_inv, spec)
        z = s["z"] - alpha * qtld
        az = A.matvec(z)
        dot_zq = v.dot(az, qtld)
        beta = -dot_zq / rho_safe
        p = v.xpay(z, beta, s["p"])
        q = v.xpay(az, beta, s["q"])

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
