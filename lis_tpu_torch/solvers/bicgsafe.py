"""BiCGSafe and BiCRSafe — the "safe" product-type variants.

Port of ``lis_tpu/solvers/bicgsafe.py`` (reference lis_bicgsafe,
src/solver/lis_solver_bicgsafe.c:145, and lis_bicrsafe, :1048): GPBiCG's
qsi/eta stabilisation (``gpbicg.qsi_eta``) with the associate residual y
kept explicitly.  BiCRSafe applies ``matvech`` once, at setup.
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
from lis_tpu_torch.solvers.gpbicg import qsi_eta


def _zeros(b):
    return torch.zeros_like(b), torch.zeros((), dtype=b.dtype,
                                            device=b.device)


@register_solver("bicgsafe")
def bicgsafe(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, b.real.dtype)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    z0, beta0 = _zeros(b)
    rtld = v.conj(r)
    mr = M.psolve(r)
    amr = A.matvec(mr)

    state = dict(it=loop_scalar(1, b), flag=loop_scalar(RUNNING, b),
                 x=x0, r=r, mr=mr, amr=amr, p=mr, ap=amr, u=z0, au=z0,
                 y=z0, z=z0, beta=beta0, rho_old=v.dot(rtld, r), nrm=nrm0,
                 rh=rh)

    def step(s):
        tdot = v.dot(rtld, s["ap"])
        alpha = s["rho_old"] / torch.where(tdot == 0.0, one, tdot)
        qsi, eta = qsi_eta(s["it"] == 1, s["y"], s["r"], s["amr"])
        t = qsi * s["ap"] + eta * s["y"]
        u = M.psolve(t) + eta * s["beta"] * s["u"]
        au = A.matvec(u)
        z = qsi * s["mr"] + eta * s["z"] - alpha * u
        y = qsi * s["amr"] + eta * s["y"] - alpha * au
        x = s["x"] + alpha * s["p"] + z
        r = s["r"] - alpha * s["ap"] - y
        nrm = residual_norm(r, bnrm_inv, spec)
        conv = nrm <= tol_eff
        rho = v.dot(rtld, r)
        broke = (rho == 0.0) & ~conv
        beta = (rho / torch.where(s["rho_old"] == 0.0, one, s["rho_old"])) \
            * (alpha / torch.where(qsi == 0.0, one, qsi))
        mr = M.psolve(r)
        amr = A.matvec(mr)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=x, r=r, mr=mr, amr=amr, p=mr + beta * (s["p"] - u),
                    ap=amr + beta * (s["ap"] - au), u=u, au=au, y=y, z=z,
                    beta=beta,
                    rho_old=torch.where(broke, s["rho_old"], rho),
                    nrm=nrm, rh=record(s["rh"], s["it"], nrm))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)


@register_solver("bicrsafe")
def bicrsafe(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, b.real.dtype)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    z0, beta0 = _zeros(b)
    rtld = v.conj(r)
    artld = A.matvech(rtld)
    mr = M.psolve(r)
    amr = A.matvec(mr)

    state = dict(it=loop_scalar(1, b), flag=loop_scalar(RUNNING, b),
                 x=x0, r=r, mr=mr, amr=amr, p=mr, ap=amr, u=z0, au=z0,
                 y=z0, my=z0, z=z0, beta=beta0, rho_old=v.dot(rtld, amr),
                 nrm=nrm0, rh=rh)

    def step(s):
        map_ = M.psolve(s["ap"])
        tdot = v.dot(artld, map_)
        alpha = s["rho_old"] / torch.where(tdot == 0.0, one, tdot)
        qsi, eta = qsi_eta(s["it"] == 1, s["y"], s["r"], s["amr"])
        u = qsi * map_ + eta * s["my"] + eta * s["beta"] * s["u"]
        au = A.matvec(u)
        z = qsi * s["mr"] + eta * s["z"] - alpha * u
        y = qsi * s["amr"] + eta * s["y"] - alpha * au
        my = M.psolve(y)
        x = s["x"] + alpha * s["p"] + z
        r = s["r"] - alpha * s["ap"] - y
        nrm = residual_norm(r, bnrm_inv, spec)
        conv = nrm <= tol_eff
        mr = s["mr"] - alpha * map_ - my
        amr = A.matvec(mr)
        rho = v.dot(rtld, amr)
        broke = (rho == 0.0) & ~conv
        beta = (rho / torch.where(s["rho_old"] == 0.0, one, s["rho_old"])) \
            * (alpha / torch.where(qsi == 0.0, one, qsi))
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=x, r=r, mr=mr, amr=amr, p=mr + beta * (s["p"] - u),
                    ap=amr + beta * (s["ap"] - au), u=u, au=au, y=y, my=my,
                    z=z, beta=beta,
                    rho_old=torch.where(broke, s["rho_old"], rho),
                    nrm=nrm, rh=record(s["rh"], s["it"], nrm))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)
