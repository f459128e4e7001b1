"""BiCG and BiCR — the biconjugate gradient/residual pair.

Port of ``lis_tpu/solvers/bicg.py`` (reference lis_bicg,
src/solver/lis_solver_bicg.c:138, and lis_bicr, :788).  Both walk A and
Aᴴ together: every step applies ``matvech`` (on CST through the transpose
grid ``at``) and ``psolveh``.  The shadow residual is r̃₀ = conj(r₀)
(lis_solver_set_shadowresidual default, src/solver/lis_solver.c:1816).
The loop bodies keep lis_tpu's update order and breakdown masks, so
iteration counts match.
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


@register_solver("bicg")
def bicg(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, b.real.dtype)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    z = torch.zeros_like(b)

    state = dict(it=loop_scalar(1, b), flag=loop_scalar(RUNNING, b),
                 x=x0, r=r, rtld=v.conj(r), p=z, ptld=z, rho_old=one,
                 nrm=nrm0, rh=rh)

    def step(s):
        z = M.psolve(s["r"])
        ztld = M.psolveh(s["rtld"])
        rho = v.dot(s["rtld"], z, spec.axis_name)
        broke1 = rho == 0.0
        beta = rho / s["rho_old"]
        p = v.xpay(z, beta, s["p"])
        q = A.matvec(p)
        ptld = v.xpay(ztld, v.conj(beta), s["ptld"])
        qtld = A.matvech(ptld)
        tmpdot1 = v.dot(ptld, q, spec.axis_name)
        broke = broke1 | (tmpdot1 == 0.0)
        alpha = rho / torch.where(tmpdot1 == 0.0, one, tmpdot1)
        x = s["x"] + alpha * p
        r = s["r"] - alpha * q
        rtld = s["rtld"] - v.conj(alpha) * qtld
        nrm = residual_norm(r, bnrm_inv, spec)

        def keep(new, old):
            return torch.where(broke, old, new)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=keep(x, s["x"]), r=keep(r, s["r"]),
                    rtld=keep(rtld, s["rtld"]), p=p, ptld=ptld,
                    rho_old=keep(rho, s["rho_old"]),
                    nrm=keep(nrm, s["nrm"]),
                    rh=record(s["rh"], s["it"], keep(nrm, s["nrm"])))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)


@register_solver("bicr")
def bicr(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, b.real.dtype)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rtld = v.conj(r)

    z = M.psolve(r)
    ztld = M.psolveh(rtld)
    ap = A.matvec(z)
    rho_old = v.dot(ztld, ap, spec.axis_name)

    state = dict(it=loop_scalar(1, b), flag=loop_scalar(RUNNING, b),
                 x=x0, r=r, rtld=rtld, z=z, ztld=ztld, p=z, ptld=ztld,
                 ap=ap, rho_old=rho_old, nrm=nrm0, rh=rh)

    def step(s):
        aptld = A.matvech(s["ptld"])
        map_ = M.psolve(s["ap"])
        tmpdot1 = v.dot(aptld, map_, spec.axis_name)
        broke1 = tmpdot1 == 0.0
        alpha = s["rho_old"] / torch.where(broke1, one, tmpdot1)
        x = s["x"] + alpha * s["p"]
        r = s["r"] - alpha * s["ap"]
        nrm = residual_norm(r, bnrm_inv, spec)
        conv = nrm <= tol_eff
        rtld = s["rtld"] - v.conj(alpha) * aptld
        z = s["z"] - alpha * map_
        ztld = M.psolveh(rtld)
        az = A.matvec(z)
        rho = v.dot(ztld, az, spec.axis_name)
        broke = broke1 | ((rho == 0.0) & ~conv)
        beta = rho / torch.where(s["rho_old"] == 0.0, one, s["rho_old"])
        p = v.xpay(z, beta, s["p"])
        ptld = v.xpay(ztld, v.conj(beta), s["ptld"])
        ap = v.xpay(az, beta, s["ap"])

        def keep1(new, old):
            return torch.where(broke1, old, new)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=keep1(x, s["x"]), r=keep1(r, s["r"]),
                    rtld=keep1(rtld, s["rtld"]),
                    z=keep1(z, s["z"]), ztld=keep1(ztld, s["ztld"]),
                    p=keep1(p, s["p"]), ptld=keep1(ptld, s["ptld"]),
                    ap=keep1(ap, s["ap"]),
                    rho_old=torch.where(broke, s["rho_old"], rho),
                    nrm=keep1(nrm, s["nrm"]),
                    rh=record(s["rh"], s["it"], keep1(nrm, s["nrm"])))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)
