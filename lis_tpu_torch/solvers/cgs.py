"""CGS and CRS — the transpose-free squared methods.

Port of ``lis_tpu/solvers/cgs.py`` (reference lis_cgs,
src/solver/lis_solver_cgs.c:134, and lis_crs, :805).  Neither applies Aᴴ
in the loop; CRS applies it once at setup for its shadow vector
Aᴴ·conj(r₀), which on a CST without a transpose grid takes the scatter.
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


@register_solver("cgs")
def cgs(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, b.real.dtype)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    z = torch.zeros_like(b)
    rtld = v.conj(r)

    state = dict(it=loop_scalar(1, b), flag=loop_scalar(RUNNING, b),
                 x=x0, r=r, p=z, q=z, rho_old=one, nrm=nrm0, rh=rh)

    def step(s):
        rho = v.dot(rtld, s["r"])
        broke1 = rho == 0.0
        beta = rho / s["rho_old"]
        u = s["r"] + beta * s["q"]
        p = u + beta * (s["q"] + beta * s["p"])
        phat = M.psolve(p)
        vhat = A.matvec(phat)
        tmpdot1 = v.dot(rtld, vhat)
        broke = broke1 | (tmpdot1 == 0.0)
        alpha = rho / torch.where(tmpdot1 == 0.0, one, tmpdot1)
        q = u - alpha * vhat
        uhat = M.psolve(u + q)
        x = s["x"] + alpha * uhat
        qhat = A.matvec(uhat)
        r = s["r"] - alpha * qhat
        nrm = residual_norm(r, bnrm_inv, spec)

        def keep(new, old):
            return torch.where(broke, old, new)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=keep(x, s["x"]), r=keep(r, s["r"]), p=p,
                    q=keep(q, s["q"]), rho_old=keep(rho, s["rho_old"]),
                    nrm=keep(nrm, s["nrm"]),
                    rh=record(s["rh"], s["it"], keep(nrm, s["nrm"])))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)


@register_solver("crs")
def crs(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, b.real.dtype)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rtld = A.matvech(v.conj(r))     # shadow = Aᴴ·conj(r₀) (lis_crs setup)
    z = torch.zeros_like(b)

    state = dict(it=loop_scalar(1, b), flag=loop_scalar(RUNNING, b),
                 x=x0, r=r, p=z, q=z, rho_old=one, nrm=nrm0, rh=rh)

    def step(s):
        z = M.psolve(s["r"])
        rho = v.dot(rtld, z)
        broke1 = rho == 0.0
        beta = rho / s["rho_old"]
        u = z + beta * s["q"]
        p = u + beta * (s["q"] + beta * s["p"])
        map_ = M.psolve(A.matvec(p))
        tmpdot1 = v.dot(rtld, map_)
        broke = broke1 | (tmpdot1 == 0.0)
        alpha = rho / torch.where(tmpdot1 == 0.0, one, tmpdot1)
        q = u - alpha * map_
        uq = u + q
        auq = A.matvec(uq)
        x = s["x"] + alpha * uq
        r = s["r"] - alpha * auq
        nrm = residual_norm(r, bnrm_inv, spec)

        def keep(new, old):
            return torch.where(broke, old, new)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=keep(x, s["x"]), r=keep(r, s["r"]), p=p,
                    q=keep(q, s["q"]), rho_old=keep(rho, s["rho_old"]),
                    nrm=keep(nrm, s["nrm"]),
                    rh=record(s["rh"], s["it"], keep(nrm, s["nrm"])))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)
