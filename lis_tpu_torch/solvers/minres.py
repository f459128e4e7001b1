"""MINRES — minimal residuals on the Lanczos tridiagonal.

Port of ``lis_tpu/solvers/minres.py`` (reference lis_minres,
src/solver/lis_solver_minres.c:121): left-preconditioned Lanczos with
Givens QR.  Convergence measures the preconditioned residual
||M⁻¹r|| / ||M⁻¹r₀|| against ``-tol`` itself: the reference ignores
``-conv_cond`` here.  eta is a scalar of the data's type (complex under
complex data, lis_solver_minres.c:131); beta stays real.
"""

from __future__ import annotations

import torch

from lis_tpu_torch.core import vector as v
from lis_tpu_torch.solvers.base import (RUNNING, SolverOutput, SolverSpec,
                                        krylov_loop, loop_output,
                                        loop_scalar, new_rhistory, record,
                                        register_solver)


@register_solver("minres")
def minres(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    v2 = M.psolve(b - A.matvec(x0))
    r0_euc = v.nrm2(v2)
    one_r = torch.ones_like(r0_euc)
    r0_inv = torch.where(r0_euc == 0, one_r,
                         1.0 / torch.where(r0_euc == 0, one_r, r0_euc))
    nrm0 = r0_euc * r0_inv
    rh = new_rhistory(spec, nrm0, b.real.dtype)
    zv = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)

    state = dict(it=loop_scalar(1, b), flag=loop_scalar(RUNNING, b), x=x0,
                 v1=zv, v2=v2, w0=zv, w1=zv, beta2=r0_euc,
                 eta=r0_euc.to(b.dtype), gamma1=one, gamma2=one,
                 sigma1=zero, sigma2=zero, r_euc=r0_euc, nrm=nrm0, rh=rh)

    def step(s):
        v2n = s["v2"] / s["beta2"]
        v4 = M.psolve(A.matvec(v2n))
        alpha = v.dot(v2n, v4)
        v4 = v4 - alpha * v2n - s["beta2"] * s["v1"]
        beta3 = v.nrm2(v4)
        delta = s["gamma2"] * alpha - s["gamma1"] * s["sigma2"] * s["beta2"]
        rho1 = torch.sqrt(delta * delta + beta3 * beta3)
        rho2 = s["sigma2"] * alpha + s["gamma1"] * s["gamma2"] * s["beta2"]
        rho3 = s["sigma1"] * s["beta2"]
        gamma3 = delta / rho1
        sigma3 = beta3 / rho1
        w2 = (v2n - rho3 * s["w0"] - rho2 * s["w1"]) / rho1
        x = s["x"] + gamma3 * s["eta"] * w2
        r_euc = s["r_euc"] * torch.abs(sigma3)
        nrm = r_euc * r0_inv
        return dict(it=s["it"] + 1, flag=s["flag"], x=x,
                    v1=v2n, v2=v4, w0=s["w1"], w1=w2,
                    beta2=beta3, eta=s["eta"] * -sigma3,
                    gamma1=s["gamma2"], gamma2=gamma3,
                    sigma1=s["sigma2"], sigma2=sigma3,
                    r_euc=r_euc, nrm=nrm, rh=record(s["rh"], s["it"], nrm))

    final = krylov_loop(spec, spec.tol, state, step)
    return loop_output(spec, spec.tol, final)
