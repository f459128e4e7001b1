"""Orthomin(m) — truncated generalized conjugate residuals.

Port of ``lis_tpu/solvers/orthomin.py`` (reference lis_orthomin,
src/solver/lis_solver_orthomin.c:124).  The last m = ``-restart``
directions p, their images A·p and M⁻¹A·p live in three (m+1, n) rings
on the operator's device, written in place at slot (it-1) mod (m+1) (the
reference's modulo ring of work vectors).

lis_tpu runs all m orthogonalisation terms on every step and masks those
with l > it-1.  Here ``it`` advances by exactly one per step, so the host
knows how many terms are live and runs only those: a masked term adds
0·(a ring slot not yet written, all zeros), so the result is bit for bit
the same, at 4 launches a term instead of 4·m.
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


@register_solver("orthomin")
def orthomin(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    m = spec.restart
    n = b.shape[0]
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, b.real.dtype)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    ring = dict(dtype=b.dtype, device=b.device)
    P, AP, APT = (torch.zeros((m + 1, n), **ring) for _ in range(3))
    # dotsave[l-1] = 1/<APT, APT> of the direction l steps back
    dotsave = [torch.zeros((), **ring) for _ in range(m)]
    host_it = 1         # the device's s["it"], known without reading it

    state = dict(it=loop_scalar(1, b), flag=loop_scalar(RUNNING, b),
                 x=x0, r=r, rtld=M.psolve(r), nrm=nrm0, rh=rh)

    def step(s):
        nonlocal host_it, dotsave
        ip = (host_it - 1) % (m + 1)
        p_new = s["rtld"]
        ap_new = A.matvec(p_new)
        apt_new = M.psolve(ap_new)
        for l in range(1, min(m, host_it - 1) + 1):
            ip0 = (ip + m + 1 - l) % (m + 1)
            beta = -v.dot(apt_new, APT[ip0], spec.axis_name) * dotsave[l - 1]
            p_new = p_new + beta * P[ip0]
            ap_new = ap_new + beta * AP[ip0]
            apt_new = apt_new + beta * APT[ip0]

        dot0 = v.dot(apt_new, apt_new, spec.axis_name)
        broke = dot0 == 0.0
        dot0_inv = 1.0 / torch.where(broke, one, dot0)
        dotsave = [torch.where(broke, old, new) for old, new in
                   zip(dotsave, [dot0_inv] + dotsave[:-1])]
        alpha = v.dot(s["rtld"], apt_new, spec.axis_name) * dot0_inv
        x = s["x"] + alpha * p_new
        r = s["r"] - alpha * ap_new
        rtld = s["rtld"] - alpha * apt_new
        nrm = residual_norm(r, bnrm_inv, spec)
        P[ip], AP[ip], APT[ip] = p_new, ap_new, apt_new
        host_it += 1

        def keep(new, old):
            return torch.where(broke, old, new)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=keep(x, s["x"]), r=keep(r, s["r"]),
                    rtld=keep(rtld, s["rtld"]), nrm=keep(nrm, s["nrm"]),
                    rh=record(s["rh"], s["it"], keep(nrm, s["nrm"])))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)
