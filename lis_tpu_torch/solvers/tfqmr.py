"""TFQMR — transpose-free QMR.

Port of ``lis_tpu/solvers/tfqmr.py`` (reference lis_tfqmr,
src/solver/lis_solver_qmr.c:113): the reference's two half-steps per
iteration (m = 0, 1) run in one step, the second masked when the first
already converged; the quasi-residual estimate τ·√(m+1)·bnrm_inv drives
convergence.  The setup runs one psolve and one matvec before the loop,
and each step applies M⁻¹ and A twice.
"""

from __future__ import annotations

import math

import torch

from lis_tpu_torch import config as C
from lis_tpu_torch.core import vector as v
from lis_tpu_torch.solvers.base import (RUNNING, SolverOutput, SolverSpec,
                                        init_residual, krylov_loop,
                                        loop_output, loop_scalar,
                                        new_rhistory, record,
                                        register_solver)


@register_solver("tfqmr")
def tfqmr(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, b.real.dtype)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    rtld = v.conj(r)
    vv = A.matvec(M.psolve(r))
    tau = v.nrm2(r)

    state = dict(it=loop_scalar(1, b), flag=loop_scalar(RUNNING, b),
                 x=x0, r=r, p=r, u=r, d=torch.zeros_like(b), vv=vv,
                 rhoold=v.dot(r, rtld), tau=tau, wold=tau, theta=zero,
                 eta=zero, nrm=nrm0, rh=rh)

    def half_step(x, d, tau, theta, eta, alpha, ww, vec):
        d = vec + (theta * theta * eta / alpha) * d
        theta = ww / tau
        c = 1.0 / torch.sqrt(1.0 + theta * theta)
        eta = c * c * alpha
        tau = tau * theta * c
        x = x + eta * M.psolve(d)
        return x, d, tau, theta, eta

    def step(s):
        sdot = v.dot(s["vv"], rtld)
        broke1 = sdot == 0.0
        alpha = s["rhoold"] / torch.where(broke1, one, sdot)
        q = s["u"] - alpha * s["vv"]
        t = s["u"] + q
        vv = A.matvec(M.psolve(t))
        r = s["r"] - alpha * vv
        w = v.nrm2(r)

        # half-step m=0: ww = sqrt(w*wold), direction u
        x, d, tau, theta, eta = half_step(
            s["x"], s["d"], s["tau"], s["theta"], s["eta"], alpha,
            torch.sqrt(w * s["wold"]), s["u"])
        nrm_a = tau * bnrm_inv
        early = nrm_a <= tol_eff
        # half-step m=1: ww = w, direction q (masked if early)
        x2, d2, tau2, theta2, eta2 = half_step(x, d, tau, theta, eta,
                                               alpha, w, q)
        nrm_b = tau2 * math.sqrt(2.0) * bnrm_inv

        def late(first, second):
            return torch.where(early, first, second)
        x, d, tau = late(x, x2), late(d, d2), late(tau, tau2)
        theta, eta = late(theta, theta2), late(eta, eta2)
        nrm = late(nrm_a, nrm_b)

        rho = v.dot(r, rtld)
        broke2 = (rho == 0.0) & ~early & (nrm > tol_eff)
        beta = rho / torch.where(s["rhoold"] == 0.0, one, s["rhoold"])
        u = r + beta * q
        p = u + beta * (q + beta * s["p"])
        vv_next = A.matvec(M.psolve(p))
        broke = broke1 | broke2

        def keep(new, old):
            return torch.where(broke1, old, new)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=keep(x, s["x"]), r=keep(r, s["r"]),
                    p=keep(p, s["p"]), u=keep(u, s["u"]), d=keep(d, s["d"]),
                    vv=keep(vv_next, s["vv"]),
                    rhoold=torch.where(broke, s["rhoold"], rho),
                    tau=keep(tau, s["tau"]), wold=keep(w, s["wold"]),
                    theta=keep(theta, s["theta"]), eta=keep(eta, s["eta"]),
                    nrm=keep(nrm, s["nrm"]),
                    rh=record(s["rh"], s["it"], keep(nrm, s["nrm"])))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)
