"""BiCGSTAB(l) — l BiCG steps, then an l-dimensional minimal residual step.

Port of ``lis_tpu/solvers/bicgstabl.py`` (reference lis_bicgstabl,
src/solver/lis_solver_bicgstabl.c:123), ``-ell`` l (default 2).
Right-preconditioned in correction space: the Krylov correction xc runs
on A·M⁻¹ and the solution is x = M⁻¹·xc + x₀ at the exit.  The r and u
directions are (l+1, n) stacks on the operator's device, updated in
place row by row.

One step of ``krylov_loop`` is a whole cycle, so the host reads the loop
condition once per cycle.  Each inner BiCG step advances ``it`` and
records its residual; one that converges sets the sentinel flag -1, and
the MR part is then dropped.  As in lis_tpu every inner matvec and
psolve runs and its result is masked, so nothing inside a cycle reads
the device: 2·l matvecs and psolves a cycle, and one psolve at the exit.
Once a cycle has left the loop only xc, nrm, rh and the counters are
read again, so its stacks need no mask.
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

_CONVERGED = -1       # the sentinel flag of an inner step that converged


@register_solver("bicgstabl")
def bicgstabl(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    l = spec.ell
    n = b.shape[0]
    r0, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, b.real.dtype)
    dt = b.dtype
    one = torch.ones((), dtype=dt, device=b.device)
    zero = torch.zeros((), dtype=dt, device=b.device)
    rtld = v.conj(r0)
    R = torch.zeros((l + 1, n), dtype=dt, device=b.device)
    R[0] = r0
    U = torch.zeros_like(R)
    top = spec.maxiter + 1          # the last slot of the history

    def bicg_part(s):
        xc, alpha, nrm, rh, it, flag = (s["xc"], s["alpha"], s["nrm"],
                                        s["rh"], s["it"], s["flag"])
        rho0 = -s["omega"] * s["rho0"]
        for j in range(l):
            active = flag == RUNNING
            rho1 = v.dot(rtld, R[j], spec.axis_name)
            broke1 = (rho1 == 0.0) & active
            beta = alpha * (rho1 / torch.where(rho0 == 0, one, rho0))
            U[: j + 1] = torch.where(active, R[: j + 1] - beta * U[: j + 1],
                                     U[: j + 1])
            U[j + 1] = torch.where(active, A.matvec(M.psolve(U[j])),
                                   U[j + 1])
            nu = v.dot(rtld, U[j + 1], spec.axis_name)
            broke2 = (nu == 0.0) & active
            alpha_new = rho1 / torch.where(nu == 0, one, nu)
            xc = torch.where(active, xc + alpha_new * U[0], xc)
            R[: j + 1] = torch.where(
                active, R[: j + 1] - alpha_new * U[1: j + 2], R[: j + 1])
            nrm_new = residual_norm(R[0], bnrm_inv, spec)
            it = torch.where(active, it + 1, it)
            rh = torch.where(active, record(rh, torch.clamp(it, max=top),
                                            nrm_new), rh)
            conv = (nrm_new <= tol_eff) & active
            R[j + 1] = torch.where(active & ~conv, A.matvec(M.psolve(R[j])),
                                   R[j + 1])
            flag = torch.where(broke1 | broke2, C.LIS_BREAKDOWN, flag)
            flag = torch.where(conv, _CONVERGED, flag)
            alpha = torch.where(active, alpha_new, alpha)
            rho0 = torch.where(active, rho1, rho0)
            nrm = torch.where(active, nrm_new, nrm)
        return xc, alpha, rho0, nrm, rh, it, flag

    def mr_part(xc, rh, it):
        """The modified Gram-Schmidt of R[1..l] and the gamma recurrences
        (the reference's tau/sigma loops) on 0-d device scalars.  lis_tpu
        also runs the terms i >= j of the Gram-Schmidt, multiplied by 0;
        they are left out here."""
        tau = [[zero] * (l + 1) for _ in range(l + 1)]
        sigma = [zero] * (l + 1)
        gamma1 = [zero] * (l + 1)
        for j in range(1, l + 1):
            for i in range(1, j):
                nu = v.dot(R[j], R[i], spec.axis_name) / torch.where(
                    sigma[i] == 0, one, sigma[i])
                tau[i][j] = nu
                R[j] -= nu * R[i]
            sigma[j] = v.dot(R[j], R[j], spec.axis_name)
            gamma1[j] = v.dot(R[0], R[j], spec.axis_name) / torch.where(
                sigma[j] == 0, one, sigma[j])
        gamma = [zero] * (l + 1)
        gamma[l] = gamma1[l]
        for j in range(l - 1, 0, -1):
            gamma[j] = gamma1[j] - sum(tau[j][i] * gamma[i]
                                       for i in range(j + 1, l + 1))
        gamma2 = [zero] * (l + 1)
        for j in range(1, l):
            gamma2[j] = gamma[j + 1] + sum(tau[j][i] * gamma[i + 1]
                                           for i in range(j + 1, l))
        xc = xc + gamma[1] * R[0]
        r_new = R[0] - gamma1[l] * R[l]
        u_new = U[0] - gamma[l] * U[l]
        for j in range(1, l):
            u_new = u_new - gamma[j] * U[j]
            xc = xc + gamma2[j] * R[j]
            r_new = r_new - gamma1[j] * R[j]
        R[0], U[0] = r_new, u_new
        nrm = residual_norm(r_new, bnrm_inv, spec)
        return xc, gamma1[l], nrm, record(rh, torch.clamp(it, max=top), nrm)

    def cycle(s):
        xc, alpha, rho0, nrm, rh, it, flag = bicg_part(s)
        do_mr = flag == RUNNING
        xc2, omega2, nrm2, rh2 = mr_part(xc, rh, it)

        def sel(after_mr, before):
            return torch.where(do_mr, after_mr, before)
        return dict(it=it, flag=torch.where(flag == _CONVERGED, RUNNING, flag),
                    xc=sel(xc2, xc), alpha=alpha,
                    omega=sel(omega2, s["omega"]), rho0=rho0,
                    nrm=sel(nrm2, nrm), rh=sel(rh2, rh))

    state = dict(it=loop_scalar(0, b), flag=loop_scalar(RUNNING, b),
                 xc=torch.zeros_like(b), alpha=zero, omega=one, rho0=one,
                 nrm=nrm0, rh=rh)
    final = krylov_loop(spec, tol_eff, state, cycle, it_done=True)
    # x = M⁻¹·xc + x₀ (the reference's exit psolve and add)
    final["x"] = M.psolve(final["xc"]) + x0
    final["it"] = final["it"] + 1   # loop_output's it - 1 convention
    return loop_output(spec, tol_eff, final)
