"""Quad (double-double) twins of the other solver families.

Port of ``lis_tpu/solvers/quad_ext.py`` (reference: the _quad registry
column, src/solver/lis_solver.c:107-144): BiCR, CRS, BiCRSTAB, GPBiCG,
GPBiCR, BiCGSafe, BiCRSafe, TFQMR, Orthomin(m), BiCGSTAB(l), GMRES(m) and
FGMRES(m).  Each is the DD lift of its double twin, in lis_tpu's order of
operations and with its breakdown checks, over the kernels of
``core/ddreal.py`` (see ``quad.py``).

Where lis_tpu masks a term that the host can tell is dead (Orthomin's
directions not yet made, BiCGSTAB(l)'s Gram-Schmidt terms i >= j, GMRES's
basis vectors past the last step), the term is left out.  Such a term adds
a DD zero, which leaves a normalised pair as it is; the one pair that may
not be normalised, Orthomin's first direction M⁻¹r (preconditioned limb by
limb), is renormalised by the same zero add.  GMRES reads its Hessenberg
column to the host once per step, as the double port does, and runs the
rotations, the residual estimate and the triangular solve there, on CPU
tensors through the same DD functions.
"""

from __future__ import annotations

import math

import torch

from lis_tpu_torch import config as C
from lis_tpu_torch.core import ddreal as q
from lis_tpu_torch.core.ddreal import DD
from lis_tpu_torch.solvers.base import (RUNNING, SolverOutput, SolverSpec,
                                        krylov_loop, loop_scalar,
                                        new_rhistory, record,
                                        register_solver)
from lis_tpu_torch.solvers.quad import (_const, _finish, _init_dd, _kd,
                                        _psolve_dd, _psolveh_dd, _resid_dd,
                                        _start)

_z = q.is_zero


def _safe(den: DD, broke) -> DD:
    return q.where(broke, _const(1.0, den.hi), den)


def _row(X: DD, i) -> DD:
    return DD(X.hi[i], X.lo[i])


def _setrow(X: DD, i, val: DD) -> None:
    """X[i] = val in place."""
    X.hi[i] = val.hi
    X.lo[i] = val.lo


def _zeros(shape, like) -> DD:
    z = torch.zeros(shape, dtype=like.dtype, device=like.device)
    return DD(z, z.clone())


def _sub_scaled(y: DD, alpha: DD, x: DD) -> DD:
    """y - alpha*x."""
    return q.axpy(q.neg(alpha), x, y)


@register_solver("bicr_quad")
def bicr_quad(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = _init_dd(A, b, x0, spec)
    z = _psolve_dd(M, r)
    ztld = _psolveh_dd(M, r)
    ap = A.matvec(z)
    state = _start(x0, r, nrm0, spec, rtld=r, z=z, ztld=ztld, p=z,
                   ptld=ztld, ap=ap, rho_old=q.dot(ztld, ap, spec.axis_name))

    def step(s):
        aptld = A.matvech(s["ptld"])
        map_ = _psolve_dd(M, s["ap"])
        tmpdot1 = q.dot(aptld, map_, spec.axis_name)
        broke1 = _z(tmpdot1)
        alpha = q.div(s["rho_old"], _safe(tmpdot1, broke1))
        x = q.axpy(alpha, s["p"], s["x"])
        r = _sub_scaled(s["r"], alpha, s["ap"])
        nrm = _resid_dd(r, bnrm_inv, spec)
        conv = nrm <= tol_eff
        rtld = _sub_scaled(s["rtld"], alpha, aptld)
        z = _sub_scaled(s["z"], alpha, map_)
        ztld = _psolveh_dd(M, rtld)
        az = A.matvec(z)
        rho = q.dot(ztld, az, spec.axis_name)
        broke2 = _z(rho) & ~conv
        broke = broke1 | broke2
        beta = q.div(rho, _safe(s["rho_old"], _z(s["rho_old"])))
        p = q.xpay(z, beta, s["p"])
        ptld = q.xpay(ztld, beta, s["ptld"])
        ap = q.xpay(az, beta, s["ap"])

        def k1(new, old):
            return q.where(~broke1, new, old)
        nrm = torch.where(broke1, s["nrm"], nrm)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=k1(x, s["x"]), r=k1(r, s["r"]),
                    rtld=k1(rtld, s["rtld"]), z=k1(z, s["z"]),
                    ztld=k1(ztld, s["ztld"]), p=k1(p, s["p"]),
                    ptld=k1(ptld, s["ptld"]), ap=k1(ap, s["ap"]),
                    rho_old=q.where(broke, s["rho_old"], rho),
                    nrm=nrm, rh=record(s["rh"], s["it"], nrm))

    return _finish(spec, tol_eff, krylov_loop(spec, tol_eff, state, step))


@register_solver("crs_quad")
def crs_quad(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = _init_dd(A, b, x0, spec)
    z0 = q.zeros_like(r)
    state = _start(x0, r, nrm0, spec, rtld=A.matvech(r), p=z0,
                   qq=z0, rho_old=_const(1.0, b))

    def step(s):
        z = _psolve_dd(M, s["r"])
        rho = q.dot(s["rtld"], z, spec.axis_name)
        broke1 = _z(rho)
        beta = q.div(rho, s["rho_old"])
        u = q.axpy(beta, s["qq"], z)
        p = q.xpay(u, beta, q.add(s["qq"], q.scal(beta, s["p"])))
        ap = A.matvec(p)
        map_ = _psolve_dd(M, ap)
        tmpdot1 = q.dot(s["rtld"], map_, spec.axis_name)
        broke = broke1 | _z(tmpdot1)
        alpha = q.div(rho, _safe(tmpdot1, broke))
        qq = _sub_scaled(u, alpha, map_)
        uq = q.add(u, qq)
        auq = A.matvec(uq)
        x = q.axpy(alpha, uq, s["x"])
        r = _sub_scaled(s["r"], alpha, auq)
        nrm = torch.where(broke, s["nrm"], _resid_dd(r, bnrm_inv, spec))
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=_kd(broke, x, s["x"]), r=_kd(broke, r, s["r"]),
                    rtld=s["rtld"], p=p, qq=_kd(broke, qq, s["qq"]),
                    rho_old=q.where(broke, s["rho_old"], rho),
                    nrm=nrm, rh=record(s["rh"], s["it"], nrm))

    return _finish(spec, tol_eff, krylov_loop(spec, tol_eff, state, step))


@register_solver("bicrstab_quad")
def bicrstab_quad(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = _init_dd(A, b, x0, spec)
    rtld = A.matvech(r)
    z = _psolve_dd(M, r)
    state = _start(x0, r, nrm0, spec, z=z, p=z, map_=q.zeros_like(r),
                   rho_old=q.dot(rtld, z, spec.axis_name))

    def step(s):
        ap = A.matvec(s["p"])
        map_ = _psolve_dd(M, ap)
        tmpdot1 = q.dot(rtld, map_, spec.axis_name)
        alpha = q.div(s["rho_old"], _safe(tmpdot1, _z(tmpdot1)))
        srec = _sub_scaled(s["r"], alpha, ap)
        nrm_s = _resid_dd(srec, bnrm_inv, spec)
        early = nrm_s <= tol_eff
        ms = _sub_scaled(s["z"], alpha, map_)
        ams = A.matvec(ms)
        omega = q.div(q.dot(ams, srec, spec.axis_name),
                      q.dot(ams, ams, spec.axis_name))
        x_half = q.axpy(alpha, s["p"], s["x"])
        x_full = q.axpy(omega, ms, x_half)
        r_full = _sub_scaled(srec, omega, ams)
        nrm_full = _resid_dd(r_full, bnrm_inv, spec)
        z_new = _psolve_dd(M, r_full)
        rho = q.dot(rtld, z_new, spec.axis_name)
        conv_full = nrm_full <= tol_eff
        broke = _z(rho) & ~early & ~conv_full
        beta = q.mul(q.div(rho, s["rho_old"]),
                     q.div(alpha, _safe(omega, _z(omega))))
        p = q.xpay(z_new, beta, _sub_scaled(s["p"], omega, map_))
        nrm = torch.where(early, nrm_s, nrm_full)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=q.where(early, x_half, x_full),
                    r=q.where(early, srec, r_full),
                    z=q.where(early, s["z"], z_new),
                    p=q.where(early, s["p"], p), map_=map_,
                    rho_old=q.where(broke | early, s["rho_old"], rho),
                    nrm=nrm, rh=record(s["rh"], s["it"], nrm))

    return _finish(spec, tol_eff, krylov_loop(spec, tol_eff, state, step))


def _qsi_eta_dd(first, y: DD, tvec: DD, w: DD, axis_name=None):
    """The DD 2x2 least-squares solve shared by GPBiCG and BiCGSafe."""
    d0 = q.dot(y, y, axis_name)
    d1 = q.dot(w, tvec, axis_name)
    d2 = q.dot(y, tvec, axis_name)
    d3 = q.dot(w, y, axis_name)
    d4 = q.dot(w, w, axis_name)
    tmp = q.sub(q.mul(d4, d0), q.mul(d3, d3))
    tmp = _safe(tmp, _z(tmp))
    qsi_n = q.div(q.sub(q.mul(d0, d1), q.mul(d2, d3)), tmp)
    eta_n = q.div(q.sub(q.mul(d4, d2), q.mul(d3, d1)), tmp)
    qsi_1 = q.div(d1, _safe(d4, _z(d4)))
    zero = _const(0.0, y.hi)
    return q.where(first, qsi_1, qsi_n), q.where(first, zero, eta_n)


@register_solver("gpbicg_quad")
def gpbicg_quad(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = _init_dd(A, b, x0, spec)
    z0 = q.zeros_like(r)
    one = _const(1.0, b)
    state = _start(x0, r, nrm0, spec, rtld=r, t=z0, t0=z0, ttld=z0, p=z0,
                   ptld=z0, u=z0, z=z0, alpha=one, qsi=one, rho_old=one)

    def step(s):
        rho = q.dot(s["rtld"], s["r"], spec.axis_name)
        broke = _z(rho)
        beta = q.mul(q.div(rho, s["rho_old"]),
                     q.div(s["alpha"], _safe(s["qsi"], _z(s["qsi"]))))
        w = q.xpay(s["ttld"], beta, s["ptld"])
        rhat = _psolve_dd(M, s["r"])
        p = q.xpay(rhat, beta, q.sub(s["p"], s["u"]))
        ptld = A.matvec(p)
        tdot = q.dot(s["rtld"], ptld, spec.axis_name)
        alpha = q.div(rho, _safe(tdot, _z(tdot)))
        y = q.sub(q.axpy(alpha, q.sub(ptld, w), s["t"]), s["r"])
        t = _sub_scaled(s["r"], alpha, ptld)
        nrm_t = _resid_dd(t, bnrm_inv, spec)
        early = nrm_t <= tol_eff
        that = _psolve_dd(M, t)
        phat = _psolve_dd(M, ptld)
        t0hat = _psolve_dd(M, s["t0"])
        ttld = A.matvec(that)
        qsi, eta = _qsi_eta_dd(s["it"] == 1, y, t, ttld, spec.axis_name)
        u = q.add(q.scal(qsi, phat),
                  q.scal(eta, q.add(q.sub(t0hat, rhat), q.scal(beta, s["u"]))))
        z = q.sub(q.add(q.scal(qsi, rhat), q.scal(eta, s["z"])),
                  q.scal(alpha, u))
        x_half = q.axpy(alpha, p, s["x"])
        x_full = q.add(x_half, z)
        r_full = q.sub(_sub_scaled(t, eta, y), q.scal(qsi, ttld))
        nrm_full = _resid_dd(r_full, bnrm_inv, spec)
        x = q.where(early, x_half, x_full)
        rr = q.where(early, t, r_full)
        nrm = torch.where(broke, s["nrm"], torch.where(early, nrm_t, nrm_full))

        def k(new, old):
            return q.where(~broke, new, old)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=k(x, s["x"]), r=k(rr, s["r"]), rtld=s["rtld"],
                    t=k(t, s["t"]), t0=k(t, s["t0"]),
                    ttld=k(ttld, s["ttld"]),
                    p=k(p, s["p"]), ptld=k(ptld, s["ptld"]),
                    u=k(u, s["u"]), z=k(z, s["z"]),
                    alpha=k(alpha, s["alpha"]), qsi=k(qsi, s["qsi"]),
                    rho_old=q.where(broke, s["rho_old"], rho),
                    nrm=nrm, rh=record(s["rh"], s["it"], nrm))

    return _finish(spec, tol_eff, krylov_loop(spec, tol_eff, state, step))


@register_solver("gpbicr_quad")
def gpbicr_quad(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = _init_dd(A, b, x0, spec)
    z0 = q.zeros_like(r)
    rtld = A.matvech(r)
    p = _psolve_dd(M, r)
    state = _start(x0, r, nrm0, spec, mr=z0, p=p, t=z0, w=z0, u=z0, y=z0,
                   z=z0, mt_old=z0, beta=_const(0.0, b),
                   rho_old=q.dot(rtld, p, spec.axis_name))

    def step(s):
        ap = A.matvec(s["p"])
        map_ = _psolve_dd(M, ap)
        tdot = q.dot(rtld, map_, spec.axis_name)
        broke1 = _z(tdot)
        alpha = q.div(s["rho_old"], _safe(tdot, broke1))
        y = q.sub(q.axpy(alpha, q.sub(ap, s["w"]), s["t"]), s["r"])
        t = _sub_scaled(s["r"], alpha, ap)
        nrm_t = _resid_dd(t, bnrm_inv, spec)
        early = nrm_t <= tol_eff
        mt = _sub_scaled(s["mr"], alpha, map_)
        amt = A.matvec(mt)
        qsi, eta = _qsi_eta_dd(s["it"] == 1, y, t, amt, spec.axis_name)
        u = q.add(q.scal(qsi, map_),
                  q.scal(eta, q.add(q.sub(s["mt_old"], s["mr"]),
                                    q.scal(s["beta"], s["u"]))))
        z = q.sub(q.add(q.scal(qsi, s["mr"]), q.scal(eta, s["z"])),
                  q.scal(alpha, u))
        x_half = q.axpy(alpha, s["p"], s["x"])
        x_full = q.add(x_half, z)
        r_full = q.sub(_sub_scaled(t, eta, y), q.scal(qsi, amt))
        nrm_full = _resid_dd(r_full, bnrm_inv, spec)
        conv_full = nrm_full <= tol_eff
        mr = _psolve_dd(M, r_full)
        rho = q.dot(rtld, mr, spec.axis_name)
        broke2 = _z(rho) & ~early & ~conv_full
        beta = q.mul(q.div(rho, _safe(s["rho_old"], _z(s["rho_old"]))),
                     q.div(alpha, _safe(qsi, _z(qsi))))
        w = q.xpay(amt, beta, ap)
        p = q.xpay(mr, beta, q.sub(s["p"], u))
        broke = broke1 | broke2
        x = q.where(early, x_half, x_full)
        rr = q.where(early, t, r_full)
        nrm = torch.where(broke1, s["nrm"],
                          torch.where(early, nrm_t, nrm_full))

        def k1(new, old):
            return q.where(~broke1, new, old)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=k1(x, s["x"]), r=k1(rr, s["r"]),
                    mr=k1(mr, s["mr"]), p=k1(p, s["p"]),
                    t=k1(t, s["t"]), w=k1(w, s["w"]),
                    u=k1(u, s["u"]), y=k1(y, s["y"]), z=k1(z, s["z"]),
                    mt_old=k1(mt, s["mt_old"]), beta=k1(beta, s["beta"]),
                    rho_old=q.where(broke, s["rho_old"], rho),
                    nrm=nrm, rh=record(s["rh"], s["it"], nrm))

    return _finish(spec, tol_eff, krylov_loop(spec, tol_eff, state, step))


@register_solver("bicgsafe_quad")
def bicgsafe_quad(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = _init_dd(A, b, x0, spec)
    z0 = q.zeros_like(r)
    rtld = r
    mr = _psolve_dd(M, r)
    amr = A.matvec(mr)
    state = _start(x0, r, nrm0, spec, mr=mr, amr=amr, p=mr, ap=amr, u=z0,
                   au=z0, y=z0, z=z0, beta=_const(0.0, b),
                   rho_old=q.dot(rtld, r, spec.axis_name))

    def step(s):
        tdot = q.dot(rtld, s["ap"], spec.axis_name)
        alpha = q.div(s["rho_old"], _safe(tdot, _z(tdot)))
        qsi, eta = _qsi_eta_dd(s["it"] == 1, s["y"], s["r"], s["amr"],
                               spec.axis_name)
        t = q.add(q.scal(qsi, s["ap"]), q.scal(eta, s["y"]))
        mt = _psolve_dd(M, t)
        u = q.axpy(q.mul(eta, s["beta"]), s["u"], mt)
        au = A.matvec(u)
        z = q.sub(q.add(q.scal(qsi, s["mr"]), q.scal(eta, s["z"])),
                  q.scal(alpha, u))
        y = q.sub(q.add(q.scal(qsi, s["amr"]), q.scal(eta, s["y"])),
                  q.scal(alpha, au))
        x = q.add(q.axpy(alpha, s["p"], s["x"]), z)
        r = q.sub(_sub_scaled(s["r"], alpha, s["ap"]), y)
        nrm = _resid_dd(r, bnrm_inv, spec)
        conv = nrm <= tol_eff
        rho = q.dot(rtld, r, spec.axis_name)
        broke = _z(rho) & ~conv
        beta = q.mul(q.div(rho, _safe(s["rho_old"], _z(s["rho_old"]))),
                     q.div(alpha, _safe(qsi, _z(qsi))))
        mr = _psolve_dd(M, r)
        amr = A.matvec(mr)
        p = q.xpay(mr, beta, q.sub(s["p"], u))
        ap = q.xpay(amr, beta, q.sub(s["ap"], au))
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=x, r=r, mr=mr, amr=amr, p=p, ap=ap,
                    u=u, au=au, y=y, z=z, beta=beta,
                    rho_old=q.where(broke, s["rho_old"], rho),
                    nrm=nrm, rh=record(s["rh"], s["it"], nrm))

    return _finish(spec, tol_eff, krylov_loop(spec, tol_eff, state, step))


@register_solver("bicrsafe_quad")
def bicrsafe_quad(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = _init_dd(A, b, x0, spec)
    z0 = q.zeros_like(r)
    rtld = r
    artld = A.matvech(rtld)
    mr = _psolve_dd(M, r)
    amr = A.matvec(mr)
    state = _start(x0, r, nrm0, spec, mr=mr, amr=amr, p=mr, ap=amr, u=z0,
                   au=z0, y=z0, my=z0, z=z0, beta=_const(0.0, b),
                   rho_old=q.dot(rtld, amr, spec.axis_name))

    def step(s):
        map_ = _psolve_dd(M, s["ap"])
        tdot = q.dot(artld, map_, spec.axis_name)
        alpha = q.div(s["rho_old"], _safe(tdot, _z(tdot)))
        qsi, eta = _qsi_eta_dd(s["it"] == 1, s["y"], s["r"], s["amr"],
                               spec.axis_name)
        u = q.add(q.add(q.scal(qsi, map_), q.scal(eta, s["my"])),
                  q.scal(q.mul(eta, s["beta"]), s["u"]))
        au = A.matvec(u)
        z = q.sub(q.add(q.scal(qsi, s["mr"]), q.scal(eta, s["z"])),
                  q.scal(alpha, u))
        y = q.sub(q.add(q.scal(qsi, s["amr"]), q.scal(eta, s["y"])),
                  q.scal(alpha, au))
        my = _psolve_dd(M, y)
        x = q.add(q.axpy(alpha, s["p"], s["x"]), z)
        r = q.sub(_sub_scaled(s["r"], alpha, s["ap"]), y)
        nrm = _resid_dd(r, bnrm_inv, spec)
        conv = nrm <= tol_eff
        mr = q.sub(_sub_scaled(s["mr"], alpha, map_), my)
        amr = A.matvec(mr)
        rho = q.dot(rtld, amr, spec.axis_name)
        broke = _z(rho) & ~conv
        beta = q.mul(q.div(rho, _safe(s["rho_old"], _z(s["rho_old"]))),
                     q.div(alpha, _safe(qsi, _z(qsi))))
        p = q.xpay(mr, beta, q.sub(s["p"], u))
        ap = q.xpay(amr, beta, q.sub(s["ap"], au))
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=x, r=r, mr=mr, amr=amr, p=p, ap=ap,
                    u=u, au=au, y=y, my=my, z=z, beta=beta,
                    rho_old=q.where(broke, s["rho_old"], rho),
                    nrm=nrm, rh=record(s["rh"], s["it"], nrm))

    return _finish(spec, tol_eff, krylov_loop(spec, tol_eff, state, step))


@register_solver("tfqmr_quad")
def tfqmr_quad(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    r, bnrm_inv, tol_eff, nrm0 = _init_dd(A, b, x0, spec)
    one = _const(1.0, b)
    zero = _const(0.0, b)
    rtld = r
    tau = q.nrm2(r, spec.axis_name)
    state = _start(x0, r, nrm0, spec, p=r, u=r, d=q.zeros_like(r),
                   vv=A.matvec(_psolve_dd(M, r)),
                   rhoold=q.dot(r, rtld, spec.axis_name), tau=tau, wold=tau,
                   theta=zero,
                   eta=zero)

    def half_step(x, d, tau, theta, eta, alpha, ww, vec):
        coef = q.div(q.mul(q.mul(theta, theta), eta), _safe(alpha, _z(alpha)))
        d = q.axpy(coef, d, vec)
        theta = q.div(ww, _safe(tau, _z(tau)))
        c = q.div(one, q.sqrt(q.add(one, q.mul(theta, theta))))
        eta = q.mul(q.mul(c, c), alpha)
        tau = q.mul(q.mul(tau, theta), c)
        x = q.axpy(eta, _psolve_dd(M, d), x)
        return x, d, tau, theta, eta

    def step(s):
        sdot = q.dot(s["vv"], rtld, spec.axis_name)
        broke1 = _z(sdot)
        alpha = q.div(s["rhoold"], _safe(sdot, broke1))
        qvec = _sub_scaled(s["u"], alpha, s["vv"])
        t = q.add(s["u"], qvec)
        vv = A.matvec(_psolve_dd(M, t))
        r = _sub_scaled(s["r"], alpha, vv)
        w = q.nrm2(r, spec.axis_name)
        x, d, tau, theta, eta = half_step(
            s["x"], s["d"], s["tau"], s["theta"], s["eta"], alpha,
            q.sqrt(q.mul(w, s["wold"])), s["u"])
        nrm_a = q.to_float(tau) * bnrm_inv
        early = nrm_a <= tol_eff
        x2, d2, tau2, theta2, eta2 = half_step(x, d, tau, theta, eta, alpha,
                                               w, qvec)
        nrm_b = q.to_float(tau2) * math.sqrt(2.0) * bnrm_inv

        def late(first, second):
            return q.where(early, first, second)
        x, d, tau = late(x, x2), late(d, d2), late(tau, tau2)
        theta, eta = late(theta, theta2), late(eta, eta2)
        nrm = torch.where(early, nrm_a, nrm_b)
        rho = q.dot(r, rtld, spec.axis_name)
        broke2 = _z(rho) & ~early & (nrm > tol_eff)
        beta = q.div(rho, _safe(s["rhoold"], _z(s["rhoold"])))
        u = q.axpy(beta, qvec, r)
        p = q.xpay(u, beta, q.add(qvec, q.scal(beta, s["p"])))
        vv_next = A.matvec(_psolve_dd(M, p))
        broke = broke1 | broke2

        def k1(new, old):
            return q.where(~broke1, new, old)
        nrm = torch.where(broke1, s["nrm"], nrm)
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=k1(x, s["x"]), r=k1(r, s["r"]), p=k1(p, s["p"]),
                    u=k1(u, s["u"]), d=k1(d, s["d"]),
                    vv=k1(vv_next, s["vv"]),
                    rhoold=q.where(broke, s["rhoold"], rho),
                    tau=k1(tau, s["tau"]), wold=k1(w, s["wold"]),
                    theta=k1(theta, s["theta"]), eta=k1(eta, s["eta"]),
                    nrm=nrm, rh=record(s["rh"], s["it"], nrm))

    return _finish(spec, tol_eff, krylov_loop(spec, tol_eff, state, step))


@register_solver("orthomin_quad")
def orthomin_quad(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    """The ring of the last m directions as in the double port: only the
    live orthogonalisation terms run; while any is dead (it - 1 < m), the
    three new vectors get lis_tpu's zero add once."""
    m = spec.restart
    n = b.shape[0]
    r, bnrm_inv, tol_eff, nrm0 = _init_dd(A, b, x0, spec)
    one = _const(1.0, b)
    P, AP, APT = (_zeros((m + 1, n), r.hi) for _ in range(3))
    zero_vec = _zeros(n, r.hi)
    dotsave = [_const(0.0, b) for _ in range(m)]
    host_it = 1
    state = _start(x0, r, nrm0, spec, rtld=_psolve_dd(M, r))

    def step(s):
        nonlocal host_it, dotsave
        ip = (host_it - 1) % (m + 1)
        p_new = s["rtld"]
        ap_new = A.matvec(p_new)
        apt_new = _psolve_dd(M, ap_new)
        lmax = min(m, host_it - 1)
        for l in range(1, lmax + 1):
            ip0 = (ip + m + 1 - l) % (m + 1)
            beta = q.neg(q.mul(q.dot(apt_new, _row(APT, ip0), spec.axis_name),
                               dotsave[l - 1]))
            p_new = q.axpy(beta, _row(P, ip0), p_new)
            ap_new = q.axpy(beta, _row(AP, ip0), ap_new)
            apt_new = q.axpy(beta, _row(APT, ip0), apt_new)
        if lmax < m:
            p_new = q.add(p_new, zero_vec)
            ap_new = q.add(ap_new, zero_vec)
            apt_new = q.add(apt_new, zero_vec)
        dot0 = q.dot(apt_new, apt_new, spec.axis_name)
        broke = _z(dot0)
        dot0_inv = q.div(one, _safe(dot0, broke))
        dotsave = [q.where(broke, old, new) for old, new in
                   zip(dotsave, [dot0_inv] + dotsave[:-1])]
        alpha = q.mul(q.dot(s["rtld"], apt_new, spec.axis_name), dot0_inv)
        x = q.axpy(alpha, p_new, s["x"])
        r = _sub_scaled(s["r"], alpha, ap_new)
        rtld = _sub_scaled(s["rtld"], alpha, apt_new)
        nrm = torch.where(broke, s["nrm"], _resid_dd(r, bnrm_inv, spec))
        _setrow(P, ip, p_new)
        _setrow(AP, ip, ap_new)
        _setrow(APT, ip, apt_new)
        host_it += 1
        return dict(it=s["it"] + 1,
                    flag=torch.where(broke, C.LIS_BREAKDOWN, s["flag"]),
                    x=_kd(broke, x, s["x"]), r=_kd(broke, r, s["r"]),
                    rtld=_kd(broke, rtld, s["rtld"]),
                    nrm=nrm, rh=record(s["rh"], s["it"], nrm))

    return _finish(spec, tol_eff, krylov_loop(spec, tol_eff, state, step))


_CONVERGED = -1       # the sentinel flag of an inner step that converged


@register_solver("bicgstabl_quad")
def bicgstabl_quad(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    """One krylov_loop step is a cycle of l BiCG steps and the MR part,
    as in the double port; every inner product runs and is masked."""
    l = spec.ell
    n = b.shape[0]
    r0, bnrm_inv, tol_eff, nrm0 = _init_dd(A, b, x0, spec)
    one = _const(1.0, b)
    zero = _const(0.0, b)
    rtld = r0
    R = _zeros((l + 1, n), r0.hi)
    _setrow(R, 0, r0)
    U = _zeros((l + 1, n), r0.hi)
    top = spec.maxiter + 1

    def bicg_part(s):
        xc, alpha, nrm, rh, it, flag = (s["xc"], s["alpha"], s["nrm"],
                                        s["rh"], s["it"], s["flag"])
        rho0 = q.neg(q.mul(s["omega"], s["rho0"]))
        for j in range(l):
            active = flag == RUNNING
            rho1 = q.dot(rtld, _row(R, j), spec.axis_name)
            broke1 = _z(rho1) & active
            beta = q.mul(alpha, q.div(rho1, _safe(rho0, _z(rho0))))
            for i in range(j + 1):
                _setrow(U, i, q.where(active, q.sub(_row(R, i),
                                                    q.scal(beta, _row(U, i))),
                                      _row(U, i)))
            t = _psolve_dd(M, _row(U, j))
            _setrow(U, j + 1, q.where(active, A.matvec(t),
                                      _row(U, j + 1)))
            nu = q.dot(rtld, _row(U, j + 1), spec.axis_name)
            broke2 = _z(nu) & active
            alpha_new = q.div(rho1, _safe(nu, _z(nu)))
            xc = q.where(active, q.axpy(alpha_new, _row(U, 0), xc), xc)
            for i in range(j + 1):
                _setrow(R, i, q.where(active, q.sub(
                    _row(R, i), q.scal(alpha_new, _row(U, i + 1))),
                    _row(R, i)))
            nrm_new = _resid_dd(_row(R, 0), bnrm_inv, spec)
            it = torch.where(active, it + 1, it)
            rh = torch.where(active, record(rh, torch.clamp(it, max=top),
                                            nrm_new), rh)
            conv = (nrm_new <= tol_eff) & active
            t2 = _psolve_dd(M, _row(R, j))
            _setrow(R, j + 1, q.where(active & ~conv, A.matvec(t2),
                                      _row(R, j + 1)))
            flag = torch.where(broke1 | broke2, C.LIS_BREAKDOWN, flag)
            flag = torch.where(conv, _CONVERGED, flag)
            alpha = q.where(active, alpha_new, alpha)
            rho0 = q.where(active, rho1, rho0)
            nrm = torch.where(active, nrm_new, nrm)
        return xc, alpha, rho0, nrm, rh, it, flag

    def mr_part(xc, rh, it):
        """The Gram-Schmidt of R[1..l] and the gamma recurrences; tau,
        sigma and the gammas are small DD arrays on the device, summed by
        ``_dd_sum`` over lis_tpu's masked rows."""
        tau = _zeros((l + 1, l + 1), r0.hi)
        sigma = _zeros(l + 1, r0.hi)
        gamma1 = _zeros(l + 1, r0.hi)
        for j in range(1, l + 1):
            for i in range(1, j):
                si = _row(sigma, i)
                nu = q.div(q.dot(_row(R, j), _row(R, i), spec.axis_name),
                           _safe(si, _z(si)))
                tau.hi[i, j], tau.lo[i, j] = nu.hi, nu.lo
                _setrow(R, j, _sub_scaled(_row(R, j), nu, _row(R, i)))
            sj = q.dot(_row(R, j), _row(R, j), spec.axis_name)
            _setrow(sigma, j, sj)
            _setrow(gamma1, j, q.div(q.dot(_row(R, 0), _row(R, j),
                                           spec.axis_name),
                                     _safe(sj, _z(sj))))
        gamma = _zeros(l + 1, r0.hi)
        _setrow(gamma, l, _row(gamma1, l))
        omega = _row(gamma1, l)

        def tail_sum(row, vec, lo, hi):
            """_dd_sum of tau[row, k]·vec[k] over lo < k <= hi, the other
            entries zero."""
            prods = q.mul(_row(tau, row), vec)
            keep = torch.zeros(l + 1, dtype=torch.bool)
            keep[lo + 1:hi + 1] = True
            keep = keep.to(prods.hi.device)
            return q._dd_sum(DD(torch.where(keep, prods.hi, 0.0),
                                torch.where(keep, prods.lo, 0.0)))
        for j in range(l - 1, 0, -1):
            _setrow(gamma, j, q.sub(_row(gamma1, j),
                                    tail_sum(j, gamma, j, l)))
        gamma_up = DD(torch.roll(gamma.hi, -1), torch.roll(gamma.lo, -1))
        gamma2 = _zeros(l + 1, r0.hi)
        for j in range(1, l):
            _setrow(gamma2, j, q.add(_row(gamma, min(j + 1, l)),
                                     tail_sum(j, gamma_up, j, l - 1)))
        xc = q.axpy(_row(gamma, 1), _row(R, 0), xc)
        r_new = _sub_scaled(_row(R, 0), _row(gamma1, l), _row(R, l))
        u_new = _sub_scaled(_row(U, 0), _row(gamma, l), _row(U, l))
        for j in range(1, l):
            u_new = _sub_scaled(u_new, _row(gamma, j), _row(U, j))
            xc = q.axpy(_row(gamma2, j), _row(R, j), xc)
            r_new = _sub_scaled(r_new, _row(gamma1, j), _row(R, j))
        _setrow(R, 0, r_new)
        _setrow(U, 0, u_new)
        nrm = _resid_dd(r_new, bnrm_inv, spec)
        return xc, omega, nrm, record(rh, torch.clamp(it, max=top), nrm)

    def cycle(s):
        xc, alpha, rho0, nrm, rh, it, flag = bicg_part(s)
        do_mr = flag == RUNNING
        xc2, omega2, nrm2, rh2 = mr_part(xc, rh, it)
        return dict(it=it,
                    flag=torch.where(flag == _CONVERGED, RUNNING, flag),
                    xc=q.where(do_mr, xc2, xc), alpha=alpha,
                    omega=q.where(do_mr, omega2, s["omega"]), rho0=rho0,
                    nrm=torch.where(do_mr, nrm2, nrm),
                    rh=torch.where(do_mr, rh2, rh))

    state = dict(it=loop_scalar(0, r0.hi), flag=loop_scalar(RUNNING, r0.hi),
                 xc=q.zeros_like(r0), alpha=zero, omega=one, rho0=one,
                 nrm=nrm0, rh=new_rhistory(spec, nrm0, torch.float64))
    final = krylov_loop(spec, tol_eff, state, cycle, it_done=True)
    # x = M⁻¹·xc + x₀ (the reference's exit psolve and add)
    final["x"] = q.add(_psolve_dd(M, final["xc"]), q.dd(x0))
    final["it"] = final["it"] + 1
    return _finish(spec, tol_eff, final)


def _gmres_core_dd(A, b, x0, M, spec: SolverSpec, flexible: bool):
    m = spec.restart
    n = b.shape[0]
    r, bnrm_inv, tol_eff, nrm0 = _init_dd(A, b, x0, spec)
    host = torch.device("cpu")

    def to_host(v: DD) -> DD:
        return DD(v.hi.to(host), v.lo.to(host))

    def to_dev(v: DD) -> DD:
        return DD(v.hi.to(r.hi.device), v.lo.to(r.hi.device))
    one = q.dd(torch.ones((), dtype=r.hi.dtype))
    scale = (bnrm_inv if spec.conv_cond != 2
             else torch.ones_like(bnrm_inv)).to(host)
    tol = float(tol_eff)
    nrm = nrm0.to(host)
    rh = torch.full((spec.maxiter + 2,), float("nan"),
                             dtype=torch.float64)
    rh[0] = nrm
    bdd = q.dd(b)
    x = q.dd(x0)
    it = 1
    while it <= spec.maxiter and float(nrm) > tol:
        rnorm = to_host(q.nrm2(r, spec.axis_name))
        rinv = q.div(one, _safe(rnorm, _z(rnorm)))
        V = _zeros((m + 1, n), r.hi)
        _setrow(V, 0, q.scal(to_dev(rinv), r))
        Z = _zeros((m, n), r.hi) if flexible else None
        H = _zeros((m + 1, m), one.hi)
        cs, sn = _zeros(m + 1, one.hi), _zeros(m + 1, one.hi)
        svec = _zeros(m + 2, one.hi)
        _setrow(svec, 0, rnorm)
        i = 0
        while i < m and it <= spec.maxiter and float(nrm) > tol:
            z = _psolve_dd(M, _row(V, i))
            w = A.matvec(z)
            if flexible:
                _setrow(Z, i, z)
            col = []
            for k in range(i + 1):
                t = q.dot(w, _row(V, k), spec.axis_name)
                w = _sub_scaled(w, t, _row(V, k))
                col.append(t)
            t = q.nrm2(w, spec.axis_name)
            col.append(t)
            hcol = to_host(DD(torch.stack([c.hi for c in col]),
                              torch.stack([c.lo for c in col])))
            H.hi[: i + 2, i], H.lo[: i + 2, i] = hcol.hi, hcol.lo
            t = _row(hcol, i + 1)
            tinv = q.div(one, _safe(t, _z(t)))
            _setrow(V, i + 1, q.scal(to_dev(tinv), w))
            for k in range(i):
                hk, hk1 = DD(H.hi[k, i], H.lo[k, i]), \
                    DD(H.hi[k + 1, i], H.lo[k + 1, i])
                a = q.add(q.mul(_row(cs, k), hk), q.mul(_row(sn, k), hk1))
                bv = q.sub(q.mul(_row(cs, k), hk1), q.mul(_row(sn, k), hk))
                H.hi[k, i], H.lo[k, i] = a.hi, a.lo
                H.hi[k + 1, i], H.lo[k + 1, i] = bv.hi, bv.lo
            aa = DD(H.hi[i, i].clone(), H.lo[i, i].clone())
            bb = DD(H.hi[i + 1, i].clone(), H.lo[i + 1, i].clone())
            rr = q.sqrt(q.add(q.mul(aa, aa), q.mul(bb, bb)))
            rr = q.where(_z(rr), _const(1.0e-17, one.hi), rr)
            ci, si = q.div(aa, rr), q.div(bb, rr)
            _setrow(cs, i, ci)
            _setrow(sn, i, si)
            svi = _row(svec, i)
            s_next = q.neg(q.mul(si, svi))
            _setrow(svec, i, q.mul(ci, svi))
            _setrow(svec, i + 1, s_next)
            hii = q.add(q.mul(ci, aa), q.mul(si, bb))
            H.hi[i, i], H.lo[i, i] = hii.hi, hii.lo
            nrm = torch.abs(q.to_float(s_next)) * scale
            rh[min(it, spec.maxiter + 1)] = nrm
            if spec.live_print:
                print(f"iteration: {it:5d}  relative residual = "
                      f"{float(nrm):e}", flush=True)
            i += 1
            it += 1
        # DD back-substitution on the padded upper-triangular H
        y = _zeros(m, one.hi)
        for row in range(m - 1, -1, -1):
            if row >= i:
                continue             # lis_tpu: y[row] = 0
            prods = q.mul(DD(H.hi[row], H.lo[row]), y)
            keep = torch.arange(m) > row
            ssum = q._dd_sum(DD(torch.where(keep, prods.hi, 0.0),
                                torch.where(keep, prods.lo, 0.0)))
            hii = DD(H.hi[row, row], H.lo[row, row])
            _setrow(y, row, q.div(q.sub(_row(svec, row), ssum), hii))
        yd = to_dev(y)
        dx = _zeros(n, r.hi)
        src = Z if flexible else V
        for k in range(i):
            dx = q.axpy(_row(yd, k), _row(src, k), dx)
        if not flexible:
            dx = _psolve_dd(M, dx)
        x = q.add(x, dx)
        r = q.sub(bdd, A.matvec(x))
    final = dict(x=x, it=torch.tensor(it), nrm=nrm.to(torch.float64),
                 rh=rh, flag=torch.tensor(RUNNING))
    return _finish(spec, tol, final)


@register_solver("gmres_quad")
def gmres_quad(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    return _gmres_core_dd(A, b, x0, M, spec, flexible=False)


@register_solver("fgmres_quad")
def fgmres_quad(A, b, x0, M, spec: SolverSpec) -> SolverOutput:
    return _gmres_core_dd(A, b, x0, M, spec, flexible=True)
