"""BiCGSTAB and BiCRSTAB.

Port of ``lis_tpu/solvers/bicgstab.py`` (reference lis_bicgstab,
src/solver/lis_solver_bicgstab.c:137, and lis_bicrstab, :951).  Both keep
the reference's mid-iteration early exit on the intermediate residual s
(before the stabilising omega step), as masked updates of the same step.
BiCRSTAB applies ``matvech`` once, at setup, for its fixed shadow vector.
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


@register_solver("bicgstab")
def bicgstab(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, b.real.dtype)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    z = torch.zeros_like(b)
    rtld = v.conj(r)

    state = dict(it=loop_scalar(1, b), flag=loop_scalar(RUNNING, b),
                 x=x0, r=r, p=z, vv=z, alpha=one, omega=one, rho_old=one,
                 nrm=nrm0, rh=rh)

    def step(s):
        rho = v.dot(rtld, s["r"], spec.axis_name)
        broke1 = rho == 0.0
        beta = (rho / s["rho_old"]) * (s["alpha"] / s["omega"])
        p = torch.where(s["it"] == 1, s["r"],
                        s["r"] + beta * (s["p"] - s["omega"] * s["vv"]))
        phat = M.psolve(p)
        vv = A.matvec(phat)
        tmpdot1 = v.dot(rtld, vv, spec.axis_name)
        alpha = rho / torch.where(tmpdot1 == 0.0, one, tmpdot1)
        srec = s["r"] - alpha * vv                      # intermediate s
        nrm_s = residual_norm(srec, bnrm_inv, spec)
        early = nrm_s <= tol_eff                        # early exit on s
        shat = M.psolve(srec)
        t = A.matvec(shat)
        omega = v.dot(t, srec, spec.axis_name) / v.dot(t, t, spec.axis_name)
        x_full = s["x"] + alpha * phat + omega * shat
        r_full = srec - omega * t
        nrm_full = residual_norm(r_full, bnrm_inv, spec)
        broke2 = (omega == 0.0) & ~early & (nrm_full > tol_eff)
        broke = broke1 | broke2
        x = torch.where(early, s["x"] + alpha * phat, x_full)
        r = torch.where(early, srec, r_full)
        nrm = torch.where(early, nrm_s, nrm_full)

        def keep(new, old):
            return torch.where(broke1, old, new)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=keep(x, s["x"]), r=keep(r, s["r"]),
                    p=keep(p, s["p"]), vv=keep(vv, s["vv"]),
                    alpha=keep(alpha, s["alpha"]),
                    omega=keep(omega, s["omega"]),
                    rho_old=keep(rho, s["rho_old"]),
                    nrm=keep(nrm, s["nrm"]),
                    rh=record(s["rh"], s["it"], keep(nrm, s["nrm"])))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)


@register_solver("bicrstab")
def bicrstab(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, b.real.dtype)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rtld = A.matvech(v.conj(r))
    z = M.psolve(r)
    rho_old = v.dot(rtld, z, spec.axis_name)

    state = dict(it=loop_scalar(1, b), flag=loop_scalar(RUNNING, b),
                 x=x0, r=r, z=z, p=z, rho_old=rho_old, nrm=nrm0, rh=rh)

    def step(s):
        ap = A.matvec(s["p"])
        map_ = M.psolve(ap)
        tmpdot1 = v.dot(rtld, map_, spec.axis_name)
        alpha = s["rho_old"] / torch.where(tmpdot1 == 0.0, one, tmpdot1)
        srec = s["r"] - alpha * ap
        nrm_s = residual_norm(srec, bnrm_inv, spec)
        early = nrm_s <= tol_eff
        ms = s["z"] - alpha * map_
        ams = A.matvec(ms)
        omega = (v.dot(ams, srec, spec.axis_name)
                 / v.dot(ams, ams, spec.axis_name))
        x_full = s["x"] + alpha * s["p"] + omega * ms
        r_full = srec - omega * ams
        nrm_full = residual_norm(r_full, bnrm_inv, spec)
        z_new = M.psolve(r_full)
        rho = v.dot(rtld, z_new, spec.axis_name)
        conv_full = nrm_full <= tol_eff
        broke = (rho == 0.0) & ~early & ~conv_full
        beta = (rho / s["rho_old"]) * (
            alpha / torch.where(omega == 0.0, one, omega))
        p = z_new + beta * (s["p"] - omega * map_)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=torch.where(early, s["x"] + alpha * s["p"], x_full),
                    r=torch.where(early, srec, r_full),
                    z=torch.where(early, s["z"], z_new),
                    p=torch.where(early, s["p"], p),
                    rho_old=torch.where(broke | early, s["rho_old"], rho),
                    nrm=torch.where(early, nrm_s, nrm_full),
                    rh=record(s["rh"], s["it"],
                              torch.where(early, nrm_s, nrm_full)))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)
