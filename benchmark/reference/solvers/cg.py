"""Preconditioned CG in plain torch, as Lis states it (lis_cg,
src/solver/lis_solver_cg.c): x0 = 0, z = M⁻¹r, ρ = r·z, β = ρ/ρ_old,
p = z + βp, q = Ap, α = ρ/(p·q), x += αp, r −= αq, and convergence when
‖r‖₂/‖r₀‖₂ ≤ tol after the update; the count is the iteration that
converged.  Statuses as Lis's: SUCCESS 0, BREAKDOWN 2, MAXITER 4."""

from __future__ import annotations

import torch

SUCCESS, BREAKDOWN, MAXITER = 0, 2, 4


def solve(b, op, psolve, tol: float, maxiter: int):
    """(x, iterations, status) from x0 = 0 on A·x = b."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = torch.zeros_like(b)
    nrm0 = float(torch.linalg.vector_norm(r))
    inv = 1.0 / nrm0 if nrm0 != 0 else 1.0
    if nrm0 * inv <= tol:
        return x, 1, SUCCESS
    rho_old = 1.0
    for it in range(1, maxiter + 1):
        z = psolve(r)
        rho = float(torch.dot(r, z))
        p = z + (rho / rho_old) * p
        q = op.matvec(p)
        pq = float(torch.dot(p, q))
        if pq == 0.0:
            return x, it, BREAKDOWN
        alpha = rho / pq
        x = x + alpha * p
        r = r - alpha * q
        if float(torch.linalg.vector_norm(r)) * inv <= tol:
            return x, it, SUCCESS
        rho_old = rho
    return x, maxiter, MAXITER
