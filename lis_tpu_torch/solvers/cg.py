"""CG and CR — the conjugate gradient/residual pair.

Port of ``lis_tpu/solvers/cg.py`` (reference lis_cg,
src/solver/lis_solver_cg.c:129, and lis_cr, :819).  The loop bodies keep
the reference's update order (psolve → dot → xpay → matvec → dots → axpys
→ convergence check) so iteration counts match; a breakdown freezes the
state as the JAX step does.

CG on real vectors runs the fused step (``core/vector.py``, kernels G on
the card): four launches and the operator's matvec per iteration, the
loop scalars in device memory, with any operator.  A Jacobi or absent
preconditioner is folded into the passes; any other ``M`` gives z through
``M.psolve``.  Complex vectors, and CR, keep the step of plain torch
operations.  ``cg`` chooses between ``cg_fused`` and ``cg_torch_ops`` by
dtype; a test or a timing script may call either with ``cg``'s setup
(``init_residual``, ``new_rhistory``).
"""

from __future__ import annotations

import torch

from lis_tpu_torch import config as C
from lis_tpu_torch.core import vector as v
from lis_tpu_torch.precon.base import NonePrecon
from lis_tpu_torch.precon.jacobi import JacobiPrecon
from lis_tpu_torch.solvers.base import (RUNNING, SolverOutput, SolverSpec,
                                        init_residual, krylov_loop,
                                        loop_output, loop_scalar,
                                        new_rhistory, record,
                                        register_solver, residual_norm)


@register_solver("cg")
def cg(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, b.real.dtype)
    if (b.dtype in v.FUSED_DTYPES and r.dtype == b.dtype
            and x0.dtype == b.dtype):
        return cg_fused(A, b, x0, M, spec, r, bnrm_inv, tol_eff, nrm0, rh)
    return cg_torch_ops(A, b, x0, M, spec, r, bnrm_inv, tol_eff, nrm0, rh)


def cg_fused(A, b, x0, M, spec, r, bnrm_inv, tol_eff, nrm0, rh):
    """CG through the fused step.  x, r and p are updated in place and the
    loop scalars live in ``ws``; the state dict holds views of them."""
    ws = v.KrylovScalars(b, spec.maxiter, tol_eff, bnrm_inv, nrm0,
                         nrm1=spec.conv_cond == 2, running=RUNNING,
                         breakdown=C.LIS_BREAKDOWN)
    x = x0.clone()
    p = torch.zeros_like(b)
    dinv = None
    if type(M) is JacobiPrecon and M.dinv.dtype == b.dtype:
        dinv = M.dinv.contiguous()
    folded = dinv is not None or type(M) is NonePrecon
    mesh = spec.axis_name

    def reduce(rows):
        # under a mesh the block partials of a slot are all-reduced between
        # the kernel that writes them and the one that sums them (every
        # rank has the same block count: the shards are padded alike)
        if mesh is not None:
            mesh.all_reduce(rows)

    if folded:
        v.krylov_dot(r, r if dinv is None else dinv,
                     None if dinv is None else r, ws, v.P_RHO)
        reduce(ws.part[v.P_RHO])

    def step(s):
        z = None
        if not folded:
            z = M.psolve(r).contiguous()
            v.krylov_dot(r, z, None, ws, v.P_RHO)
            reduce(ws.part[v.P_RHO])
        v.cg_direction(p, r, z, dinv, ws)
        q = A.matvec(p).contiguous()
        v.krylov_dot(p, q, None, ws, v.P_PQ)
        reduce(ws.part[v.P_PQ])
        v.cg_update(x, r, p, q, dinv, ws, next_rho=folded)
        # P_NRM, and the next step's P_RHO when folded, in one collective:
        # the P_PQ row it also sums was read by cg_update and is written
        # again before any kernel reads it
        reduce(ws.part if folded else ws.part[v.P_NRM])
        v.cg_finish(ws, rh)
        return s

    state = dict(it=ws.it, flag=ws.flag, nrm=ws.nrm, live=ws.live, x=x, rh=rh)
    final = krylov_loop(spec, tol_eff, state, step, live=lambda s: s["live"])
    return loop_output(spec, tol_eff, final)


def cg_torch_ops(A, b, x0, M, spec, r, bnrm_inv, tol_eff, nrm0, rh):
    """CG as plain torch operations, a new tensor per update: the step of
    complex systems, and the reference the fused step is tested against."""
    one = torch.ones((), dtype=b.dtype, device=b.device)

    state = dict(it=loop_scalar(1, b), flag=loop_scalar(RUNNING, b),
                 x=x0, r=r, p=torch.zeros_like(b), rho_old=one,
                 nrm=nrm0, rh=rh)

    def step(s):
        z = M.psolve(s["r"])
        rho = v.dot(s["r"], z, spec.axis_name)
        beta = rho / s["rho_old"]
        p = v.xpay(z, beta, s["p"])
        q = A.matvec(p)
        dot_pq = v.dot(p, q, spec.axis_name)
        broke = dot_pq == 0.0
        alpha = rho / torch.where(broke, one, dot_pq)
        x = s["x"] + alpha * p
        r = s["r"] - alpha * q
        nrm = residual_norm(r, bnrm_inv, spec)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=torch.where(broke, s["x"], x),
                    r=torch.where(broke, s["r"], r),
                    p=p, rho_old=rho,
                    nrm=torch.where(broke, s["nrm"], nrm),
                    rh=record(s["rh"], s["it"], nrm))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)


@register_solver("cr")
def cr(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, b.real.dtype)
    one = torch.ones((), dtype=b.dtype, device=b.device)

    p = M.psolve(r)
    q = A.matvec(p)
    z = p

    state = dict(it=loop_scalar(1, b), flag=loop_scalar(RUNNING, b),
                 x=x0, r=r, z=z, p=p, q=q, nrm=nrm0, rh=rh)

    def step(s):
        qtld = M.psolve(s["q"])
        rho = v.dot(qtld, s["q"], spec.axis_name)
        broke = rho == 0.0
        rho_safe = torch.where(broke, one, rho)
        dot_rq = v.dot(s["r"], qtld, spec.axis_name)
        alpha = dot_rq / rho_safe
        x = s["x"] + alpha * s["p"]
        r = s["r"] - alpha * s["q"]
        nrm = residual_norm(r, bnrm_inv, spec)
        z = s["z"] - alpha * qtld
        az = A.matvec(z)
        dot_zq = v.dot(az, qtld, spec.axis_name)
        beta = -dot_zq / rho_safe
        p = v.xpay(z, beta, s["p"])
        q = v.xpay(az, beta, s["q"])

        def keep(new, old):
            return torch.where(broke, old, new)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=keep(x, s["x"]), r=keep(r, s["r"]), z=keep(z, s["z"]),
                    p=keep(p, s["p"]), q=keep(q, s["q"]),
                    nrm=keep(nrm, s["nrm"]),
                    rh=record(s["rh"], s["it"], keep(nrm, s["nrm"])))

    final = krylov_loop(spec, tol_eff, state, step)
    return loop_output(spec, tol_eff, final)
