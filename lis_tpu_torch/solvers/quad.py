"""Quad (double-double) precision solvers: CG, CR, BiCG, CGS, BiCGSTAB.

Port of ``lis_tpu/solvers/quad.py`` (reference: the _quad registry column,
src/solver/lis_solver.c:107-144, and e.g. lis_cg_quad,
src/solver/lis_solver_cg.c:246).  Vectors and loop scalars are DD pairs
(``lis_tpu_torch.core.ddreal``): matvecs accumulate by TWO_PROD (kernels M
and N on the card), the reductions go through lis_tpu's two-sum tree
(kernel O), the vector updates and the DD scalar algebra on 0-d pairs
(divisions, products) through kernel P; the breakdown tests and the
merges are torch operations.  Every loop scalar stays on the device.  The
preconditioner is applied to each limb (valid for any linear M).  Registered as "<name>_quad"; the driver dispatches on
``-f quad``, ``switch``, ``df`` and ``switch_df``.  The other twelve twins
are in ``quad_ext.py``.

``cg_quad`` with a Jacobi preconditioner in the limb type, or none, and
no mesh runs the fused step of ``core/ddcg.py`` (kernels S on the card:
three launches and the matvec an iteration, Jacobi folded in, x, r and p
updated in place, the breakdown frozen on the device); any other
preconditioner, and a distributed solve, run ``cg_quad_plain``, which the
fused step equals bit for bit.  The counters ``cg_quad.fused`` and
``cg_quad.plain`` (``utils/trace.count``) record the route once a solve.
"""

from __future__ import annotations

import torch

from lis_tpu_torch import config as C
from lis_tpu_torch.core import ddcg
from lis_tpu_torch.core import ddreal as q
from lis_tpu_torch.core.ddreal import DD
from lis_tpu_torch.precon.base import NonePrecon
from lis_tpu_torch.precon.jacobi import JacobiPrecon
from lis_tpu_torch.solvers.base import (RUNNING, SolverOutput, SolverSpec,
                                        _inv_or_one, krylov_loop,
                                        loop_output, loop_scalar,
                                        new_rhistory, record,
                                        register_solver)
from lis_tpu_torch.utils.trace import count


def _psolve_dd(M, r: DD) -> DD:
    return DD(M.psolve(r.hi), M.psolve(r.lo))


def _psolveh_dd(M, r: DD) -> DD:
    return DD(M.psolveh(r.hi), M.psolveh(r.lo))


def _const(val, b) -> DD:
    """A 0-d DD constant in b's limb type on b's device (b a tensor or a
    DD pair)."""
    return q.dd(torch.full((), val, dtype=b.dtype, device=b.device))


def _init_dd(A, b, x0, spec):
    """The DD initial residual and its normalisation (lis_tpu's
    ``_init_dd``): (r0, bnrm_inv, tol_eff, nrm0), the last three f64."""
    bdd = q.dd(b)
    r = q.sub(bdd, A.matvec(q.dd(x0)))
    if spec.conv_cond == 1:
        ref = q.to_float(q.nrm2(bdd, spec.axis_name))
        nrm0 = q.to_float(q.nrm2(r, spec.axis_name))
    elif spec.conv_cond == 2:
        ref = q.to_float(q.nrm1(bdd, spec.axis_name))
        nrm0 = q.to_float(q.nrm1(r, spec.axis_name))
    else:
        ref = q.to_float(q.nrm2(r, spec.axis_name))
        nrm0 = ref
    bnrm_inv = _inv_or_one(ref)
    if spec.conv_cond == 2:
        tol_eff = ref * spec.tol_w + spec.tol
        return r, bnrm_inv, tol_eff, nrm0
    return r, bnrm_inv, spec.tol, nrm0 * bnrm_inv


def _resid_dd(r: DD, bnrm_inv, spec):
    if spec.conv_cond == 2:
        return q.to_float(q.nrm1(r, spec.axis_name))
    return q.to_float(q.nrm2(r, spec.axis_name)) * bnrm_inv


def _kd(broke, new: DD, old: DD) -> DD:
    return q.where(~broke, new, old)


def _start(x0, r, nrm0, spec, **extra):
    """The loop state every twin starts from."""
    return dict(it=loop_scalar(1, r.hi), flag=loop_scalar(RUNNING, r.hi),
                x=q.dd(x0), r=r, nrm=nrm0,
                rh=new_rhistory(spec, nrm0, torch.float64), **extra)


def _finish(spec, tol_eff, final) -> SolverOutput:
    out = loop_output(spec, tol_eff, final)
    return out._replace(x=q.to_float(final["x"]))


@register_solver("cg_quad")
def cg_quad(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = _init_dd(A, b, x0, spec)
    dinv = None
    if (type(M) is JacobiPrecon and M.dinv.dtype == r.dtype
            and M.dinv.shape == r.shape):
        dinv = M.dinv.contiguous()
    if spec.axis_name is None and (dinv is not None
                                   or type(M) is NonePrecon):
        count("cg_quad.fused")
        return cg_quad_fused(A, x0, spec, r, bnrm_inv, tol_eff, nrm0, dinv)
    count("cg_quad.plain")
    return cg_quad_plain(A, b, x0, M, spec, r, bnrm_inv, tol_eff, nrm0)


def cg_quad_fused(A, x0, spec, r, bnrm_inv, tol_eff, nrm0, dinv):
    """cg_quad through the fused step (``core/ddcg.py``), from
    ``_init_dd``'s setup: x, r and p updated in place, z = dinv·r (or r
    with ``dinv`` None) folded into the passes, the loop scalars in
    ``ws``; the state dict holds views of them."""
    x = DD(*(t.clone(memory_format=torch.contiguous_format)
             for t in q.dd(x0)))
    r = DD(r.hi.contiguous(), r.lo.contiguous())
    p = q.zeros_like(r)
    z = ddcg.z_limbs(r, dinv)
    ws = ddcg.DDCGScalars(r, spec.maxiter, tol_eff, bnrm_inv, nrm0,
                          q.dot(r, z), nrm1=spec.conv_cond == 2,
                          running=RUNNING, breakdown=C.LIS_BREAKDOWN)
    rh = new_rhistory(spec, nrm0, torch.float64)

    def step(s):
        ddcg.ddcg_direction(p, r, dinv, ws)
        qv = A.matvec(p)
        ddcg.ddcg_pq(p, qv, ws)
        ddcg.ddcg_update(x, r, p, qv, dinv, ws, rh)
        return s

    state = dict(it=ws.it, flag=ws.flag, nrm=ws.nrm, live=ws.live, x=x, rh=rh)
    final = krylov_loop(spec, tol_eff, state, step, live=lambda s: s["live"])
    return _finish(spec, tol_eff, final)


def cg_quad_plain(A, b, x0, M, spec, r, bnrm_inv, tol_eff, nrm0):
    """cg_quad as kernels O and P and torch operations, a new pair per
    update: the step of every other preconditioner and of a mesh, and the
    reference the fused step is tested against."""
    one = _const(1.0, b)
    state = _start(x0, r, nrm0, spec, p=q.zeros_like(r), rho_old=one)

    def step(s):
        z = _psolve_dd(M, s["r"])
        rho = q.dot(s["r"], z, spec.axis_name)
        beta = q.div(rho, s["rho_old"])
        p = q.xpay(z, beta, s["p"])
        qv = A.matvec(p)
        dot_pq = q.dot(p, qv, spec.axis_name)
        broke = q.is_zero(dot_pq)
        alpha = q.div(rho, q.where(broke, one, dot_pq))
        x = q.axpy(alpha, p, s["x"])
        r = q.axpy(q.neg(alpha), qv, s["r"])
        nrm = _resid_dd(r, bnrm_inv, spec)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=_kd(broke, x, s["x"]), r=_kd(broke, r, s["r"]),
                    p=p, rho_old=q.where(broke, s["rho_old"], rho),
                    nrm=torch.where(broke, s["nrm"], nrm),
                    rh=record(s["rh"], s["it"], nrm))

    return _finish(spec, tol_eff, krylov_loop(spec, tol_eff, state, step))


@register_solver("cr_quad")
def cr_quad(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = _init_dd(A, b, x0, spec)
    one = _const(1.0, b)
    p = _psolve_dd(M, r)
    qv = A.matvec(p)
    state = _start(x0, r, nrm0, spec, z=p, p=p, q=qv)

    def step(s):
        qtld = _psolve_dd(M, s["q"])
        rho = q.dot(qtld, s["q"], spec.axis_name)
        broke = q.is_zero(rho)
        rho_s = q.where(broke, one, rho)
        alpha = q.div(q.dot(s["r"], qtld, spec.axis_name), rho_s)
        x = q.axpy(alpha, s["p"], s["x"])
        r = q.axpy(q.neg(alpha), s["q"], s["r"])
        nrm = _resid_dd(r, bnrm_inv, spec)
        z = q.axpy(q.neg(alpha), qtld, s["z"])
        az = A.matvec(z)
        beta = q.neg(q.div(q.dot(az, qtld, spec.axis_name), rho_s))
        p = q.xpay(z, beta, s["p"])
        qn = q.xpay(az, beta, s["q"])
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=_kd(broke, x, s["x"]), r=_kd(broke, r, s["r"]),
                    z=_kd(broke, z, s["z"]), p=_kd(broke, p, s["p"]),
                    q=_kd(broke, qn, s["q"]),
                    nrm=torch.where(broke, s["nrm"], nrm),
                    rh=record(s["rh"], s["it"], nrm))

    return _finish(spec, tol_eff, krylov_loop(spec, tol_eff, state, step))


@register_solver("bicg_quad")
def bicg_quad(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = _init_dd(A, b, x0, spec)
    one = _const(1.0, b)
    state = _start(x0, r, nrm0, spec, rtld=r, p=q.zeros_like(r),
                   ptld=q.zeros_like(r), rho_old=one)

    def step(s):
        z = _psolve_dd(M, s["r"])
        ztld = _psolveh_dd(M, s["rtld"])
        rho = q.dot(s["rtld"], z, spec.axis_name)
        broke1 = q.is_zero(rho)
        beta = q.div(rho, s["rho_old"])
        p = q.xpay(z, beta, s["p"])
        qv = A.matvec(p)
        ptld = q.xpay(ztld, beta, s["ptld"])
        qtld = A.matvech(ptld)
        tmp = q.dot(ptld, qv, spec.axis_name)
        broke = broke1 | q.is_zero(tmp)
        alpha = q.div(rho, q.where(broke, one, tmp))
        x = q.axpy(alpha, p, s["x"])
        r = q.axpy(q.neg(alpha), qv, s["r"])
        rtld = q.axpy(q.neg(alpha), qtld, s["rtld"])
        nrm = _resid_dd(r, bnrm_inv, spec)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=_kd(broke, x, s["x"]), r=_kd(broke, r, s["r"]),
                    rtld=_kd(broke, rtld, s["rtld"]), p=p, ptld=ptld,
                    rho_old=q.where(broke, s["rho_old"], rho),
                    nrm=torch.where(broke, s["nrm"], nrm),
                    rh=record(s["rh"], s["it"], nrm))

    return _finish(spec, tol_eff, krylov_loop(spec, tol_eff, state, step))


@register_solver("cgs_quad")
def cgs_quad(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = _init_dd(A, b, x0, spec)
    one = _const(1.0, b)
    state = _start(x0, r, nrm0, spec, rtld=r, p=q.zeros_like(r),
                   qq=q.zeros_like(r), rho_old=one)

    def step(s):
        rho = q.dot(s["rtld"], s["r"], spec.axis_name)
        broke1 = q.is_zero(rho)
        beta = q.div(rho, s["rho_old"])
        u = q.axpy(beta, s["qq"], s["r"])
        p = q.xpay(u, beta, q.add(s["qq"], q.scal(beta, s["p"])))
        phat = _psolve_dd(M, p)
        vhat = A.matvec(phat)
        tmp = q.dot(s["rtld"], vhat, spec.axis_name)
        broke = broke1 | q.is_zero(tmp)
        alpha = q.div(rho, q.where(broke, one, tmp))
        qq = q.axpy(q.neg(alpha), vhat, u)
        uhat = _psolve_dd(M, q.add(u, qq))
        x = q.axpy(alpha, uhat, s["x"])
        qhat = A.matvec(uhat)
        r = q.axpy(q.neg(alpha), qhat, s["r"])
        nrm = _resid_dd(r, bnrm_inv, spec)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=_kd(broke, x, s["x"]), r=_kd(broke, r, s["r"]),
                    rtld=s["rtld"], p=p, qq=_kd(broke, qq, s["qq"]),
                    rho_old=q.where(broke, s["rho_old"], rho),
                    nrm=torch.where(broke, s["nrm"], nrm),
                    rh=record(s["rh"], s["it"], nrm))

    return _finish(spec, tol_eff, krylov_loop(spec, tol_eff, state, step))


@register_solver("bicgstab_quad")
def bicgstab_quad(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = _init_dd(A, b, x0, spec)
    one = _const(1.0, b)
    z = q.zeros_like(r)
    state = _start(x0, r, nrm0, spec, rtld=r, p=z, vv=z, alpha=one,
                   omega=one, rho_old=one)

    def step(s):
        rho = q.dot(s["rtld"], s["r"], spec.axis_name)
        broke1 = q.is_zero(rho)
        beta = q.mul(q.div(rho, s["rho_old"]), q.div(s["alpha"], s["omega"]))
        pm = q.axpy(q.neg(s["omega"]), s["vv"], s["p"])
        p = q.where(s["it"] == 1, s["r"], q.xpay(s["r"], beta, pm))
        phat = _psolve_dd(M, p)
        vv = A.matvec(phat)
        tmp1 = q.dot(s["rtld"], vv, spec.axis_name)
        alpha = q.div(rho, q.where(q.is_zero(tmp1), one, tmp1))
        srec = q.axpy(q.neg(alpha), vv, s["r"])
        nrm_s = _resid_dd(srec, bnrm_inv, spec)
        early = nrm_s <= tol_eff
        shat = _psolve_dd(M, srec)
        t = A.matvec(shat)
        omega = q.div(q.dot(t, srec, spec.axis_name),
                      q.dot(t, t, spec.axis_name))
        x_half = q.axpy(alpha, phat, s["x"])
        x_full = q.axpy(omega, shat, x_half)
        r_full = q.axpy(q.neg(omega), t, srec)
        nrm_full = _resid_dd(r_full, bnrm_inv, spec)
        broke2 = q.is_zero(omega) & ~early & (nrm_full > tol_eff)
        broke = broke1 | broke2
        x = q.where(early, x_half, x_full)
        r = q.where(early, srec, r_full)
        nrm = torch.where(early, nrm_s, nrm_full)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=_kd(broke1, x, s["x"]), r=_kd(broke1, r, s["r"]),
                    rtld=s["rtld"], p=_kd(broke1, p, s["p"]),
                    vv=_kd(broke1, vv, s["vv"]),
                    alpha=q.where(broke1, s["alpha"], alpha),
                    omega=q.where(broke1, s["omega"], omega),
                    rho_old=q.where(broke1, s["rho_old"], rho),
                    nrm=torch.where(broke1, s["nrm"], nrm),
                    rh=record(s["rh"], s["it"], nrm))

    return _finish(spec, tol_eff, krylov_loop(spec, tol_eff, state, step))
