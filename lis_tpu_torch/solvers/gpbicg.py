"""GPBiCG and GPBiCR — product-type methods with two-step stabilising
polynomials.

Port of ``lis_tpu/solvers/gpbicg.py`` (reference lis_gpbicg,
src/solver/lis_solver_gpbicg.c:356, and lis_gpbicr, :1349).  The qsi/eta
pair comes from the same five-dot 2×2 least-squares system in both (also
BiCGSafe's, ``bicgsafe.py``); both keep the reference's early exit on the
intermediate residual t as masked updates of the same step.  GPBiCR
applies ``matvech`` once, at setup, for its shadow vector.
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


def qsi_eta(first, y, t, w, axis_name=None):
    """(qsi, eta) minimising ||t − eta·y − qsi·w||: the 2×2 normal
    equations, or qsi = <w,t>/<w,w> and eta = 0 on the first step."""
    d0 = v.dot(y, y, axis_name)
    d1 = v.dot(w, t, axis_name)
    d2 = v.dot(y, t, axis_name)
    d3 = v.dot(w, y, axis_name)
    d4 = v.dot(w, w, axis_name)
    tmp = d4 * d0 - d3 * d3
    qsi_n = (d0 * d1 - d2 * d3) / tmp
    eta_n = (d4 * d2 - d3 * d1) / tmp
    qsi = torch.where(first, d1 / d4, qsi_n)
    eta = torch.where(first, torch.zeros_like(eta_n), eta_n)
    return qsi, eta


@register_solver("gpbicg")
def gpbicg(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, b.real.dtype)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    z0 = torch.zeros_like(b)
    rtld = v.conj(r)

    state = dict(it=loop_scalar(1, b), flag=loop_scalar(RUNNING, b),
                 x=x0, r=r, t=z0, t0=z0, ttld=z0, p=z0, ptld=z0, u=z0,
                 z=z0, alpha=one, qsi=one, rho_old=one, nrm=nrm0, rh=rh)

    def step(s):
        rho = v.dot(rtld, s["r"], spec.axis_name)
        broke = rho == 0.0
        beta = (rho / s["rho_old"]) * (s["alpha"] / s["qsi"])
        w = s["ttld"] + beta * s["ptld"]
        rhat = M.psolve(s["r"])
        p = rhat + beta * (s["p"] - s["u"])
        ptld = A.matvec(p)
        tdot = v.dot(rtld, ptld, spec.axis_name)
        alpha = rho / torch.where(tdot == 0.0, one, tdot)
        y = s["t"] + alpha * (ptld - w) - s["r"]
        t = s["r"] - alpha * ptld
        nrm_t = residual_norm(t, bnrm_inv, spec)
        early = nrm_t <= tol_eff
        that = M.psolve(t)
        phat = M.psolve(ptld)
        t0hat = M.psolve(s["t0"])
        ttld = A.matvec(that)
        qsi, eta = qsi_eta(s["it"] == 1, y, t, ttld, spec.axis_name)
        u = qsi * phat + eta * (t0hat - rhat + beta * s["u"])
        z = qsi * rhat + eta * s["z"] - alpha * u
        x_full = s["x"] + alpha * p + z
        r_full = t - eta * y - qsi * ttld
        nrm_full = residual_norm(r_full, bnrm_inv, spec)
        x = torch.where(early, s["x"] + alpha * p, x_full)
        rr = torch.where(early, t, r_full)
        nrm = torch.where(early, nrm_t, nrm_full)

        def keep(new, old):
            return torch.where(broke, old, new)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=keep(x, s["x"]), r=keep(rr, s["r"]),
                    t=keep(t, s["t"]), t0=keep(t, s["t0"]),
                    ttld=keep(ttld, s["ttld"]),
                    p=keep(p, s["p"]), ptld=keep(ptld, s["ptld"]),
                    u=keep(u, s["u"]), z=keep(z, s["z"]),
                    alpha=keep(alpha, s["alpha"]), qsi=keep(qsi, s["qsi"]),
                    rho_old=keep(rho, s["rho_old"]),
                    nrm=keep(nrm, s["nrm"]),
                    rh=record(s["rh"], s["it"], keep(nrm, s["nrm"])))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)


@register_solver("gpbicr")
def gpbicr(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, b.real.dtype)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    z0 = torch.zeros_like(b)
    rtld = A.matvech(v.conj(r))
    p = M.psolve(r)

    state = dict(it=loop_scalar(1, b), flag=loop_scalar(RUNNING, b),
                 x=x0, r=r, mr=z0, p=p, t=z0, w=z0, u=z0, y=z0, z=z0,
                 mt_old=z0, beta=torch.zeros((), dtype=b.dtype,
                                             device=b.device),
                 rho_old=v.dot(rtld, p, spec.axis_name), nrm=nrm0, rh=rh)

    def step(s):
        ap = A.matvec(s["p"])
        map_ = M.psolve(ap)
        tdot = v.dot(rtld, map_, spec.axis_name)
        broke1 = tdot == 0.0
        alpha = s["rho_old"] / torch.where(broke1, one, tdot)
        y = s["t"] + alpha * (ap - s["w"]) - s["r"]
        t = s["r"] - alpha * ap
        nrm_t = residual_norm(t, bnrm_inv, spec)
        early = nrm_t <= tol_eff
        mt = s["mr"] - alpha * map_
        amt = A.matvec(mt)
        qsi, eta = qsi_eta(s["it"] == 1, y, t, amt, spec.axis_name)
        u = qsi * map_ + eta * (s["mt_old"] - s["mr"] + s["beta"] * s["u"])
        z = qsi * s["mr"] + eta * s["z"] - alpha * u
        x_full = s["x"] + alpha * s["p"] + z
        r_full = t - eta * y - qsi * amt
        nrm_full = residual_norm(r_full, bnrm_inv, spec)
        conv_full = nrm_full <= tol_eff
        mr = M.psolve(r_full)
        rho = v.dot(rtld, mr, spec.axis_name)
        broke2 = (rho == 0.0) & ~early & ~conv_full
        beta = (rho / torch.where(s["rho_old"] == 0.0, one, s["rho_old"])) \
            * (alpha / torch.where(qsi == 0.0, one, qsi))
        w = amt + beta * ap
        p = mr + beta * (s["p"] - u)
        broke = broke1 | broke2
        x = torch.where(early, s["x"] + alpha * s["p"], x_full)
        rr = torch.where(early, t, r_full)
        nrm = torch.where(early, nrm_t, nrm_full)

        def keep(new, old):
            return torch.where(broke1, old, new)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=keep(x, s["x"]), r=keep(rr, s["r"]),
                    mr=keep(mr, s["mr"]), p=keep(p, s["p"]),
                    t=keep(t, s["t"]), w=keep(w, s["w"]),
                    u=keep(u, s["u"]), y=keep(y, s["y"]), z=keep(z, s["z"]),
                    mt_old=keep(mt, s["mt_old"]),
                    beta=keep(beta, s["beta"]),
                    rho_old=torch.where(broke, s["rho_old"], rho),
                    nrm=keep(nrm, s["nrm"]),
                    rh=record(s["rh"], s["it"], keep(nrm, s["nrm"])))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)
