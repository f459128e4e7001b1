"""IDR(s) and IDR(1) — induced dimension reduction.

Port of ``lis_tpu/solvers/idrs.py`` (reference lis_idrs,
src/solver/lis_solver_idrs.c:526, and lis_idr1, :223), right-
preconditioned (the reference's PRE_RIGHT build default, :50).

The s-dimensional shadow space P is drawn on the host by numpy's MT19937
with the reference's init_by_array seed {0x123, 0x234, 0x345, 0x456}
(lis_solver_idrs.c:538) and orthonormalised the reference's way
(lis_idrs_orth, :202), so it is bit for bit lis_tpu's.  The prepare hook
(``-irestart`` s for idrs, 1 for idr1) hands it to the solver, which
casts it once to the vectors' dtype (the products P·v promote in
lis_tpu).

The dX and dR difference stacks (s, n) and the s×s matrix P·dR are on
the operator's device, written in place; once a step has left the loop
they are not read again, so they need no mask.
The s start steps run masked, as in lis_tpu, and the host then reads the
iteration count once: from there ``it`` advances by one per step, so the
host knows which stack slot a step writes and whether it refreshes omega
(it mod (s+1) == s, lis_tpu's ``lax.cond``) without reading the device.
The s×s system solves with ``torch.linalg.solve_ex`` without its error
check, which would read the device every step: a singular system gives
inf/NaN, as ``jnp.linalg.solve`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from lis_tpu_torch.core import vector as v
from lis_tpu_torch.solvers.base import (RUNNING, SolverOutput, SolverSpec,
                                        init_residual, krylov_loop,
                                        loop_output, loop_scalar,
                                        new_rhistory, print_rhistory, record,
                                        register_prepare, register_solver,
                                        residual_norm)


def shadow_space(s: int, n: int) -> np.ndarray:
    """P (s, n), float64: MT19937 draws (genrand_real1 = u32/(2³²−1)),
    then the reference's normalize-then-project Gram-Schmidt."""
    rs = np.random.RandomState(np.array([0x123, 0x234, 0x345, 0x456],
                                        dtype=np.uint32))
    draws = rs.randint(0, 2**32, size=(s, n),
                       dtype=np.uint64).astype(np.float64)
    P = draws / 4294967295.0
    for j in range(s):
        P[j] /= np.linalg.norm(P[j])
        for i in range(j + 1, s):
            P[i] -= (P[j] @ P[i]) * P[j]
    return P


def _prepare(s: int, A) -> torch.Tensor:
    return torch.from_numpy(shadow_space(s, A.nrows)).to(A.device)


@register_prepare("idrs")
def prepare_idrs(A, spec):
    return _prepare(spec.irestart, A)


@register_prepare("idr1")
def prepare_idr1(A, spec):
    return _prepare(1, A)


def _pmat(P, vec, axis_name):
    """P @ vec, all-reduced over the mesh (the s shadow dots of a sharded
    vector; lis_tpu ``_pmat``)."""
    out = P @ vec
    return out if axis_name is None else axis_name.all_reduce(out)


def _idrs_core(A, b, x0, M, spec: SolverSpec, P) -> SolverOutput:
    s = P.shape[0]
    n = b.shape[0]
    dt = b.dtype
    P = P.to(dt)
    r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
    rh = new_rhistory(spec, nrm0, b.real.dtype)
    one = torch.ones((), dtype=dt, device=b.device)
    top = spec.maxiter + 1          # the last slot of the history

    # ---- s start steps, masked once the residual meets tol: dX, dR, Mmat
    dX = torch.zeros((s, n), dtype=dt, device=b.device)
    dR = torch.zeros_like(dX)
    Mmat = torch.zeros((s, s), dtype=dt, device=b.device)
    x, nrm = x0, nrm0
    done = nrm0 <= tol_eff
    itk = loop_scalar(0, b)
    for k in range(s):
        active = ~done
        dx = M.psolve(r)
        dr = A.matvec(dx)
        h = v.dot(dr, dr, spec.axis_name)
        om = v.dot(dr, r, spec.axis_name) / torch.where(h == 0, one, h)
        dx = om * dx
        dr = -om * dr
        x = torch.where(active, x + dx, x)
        r = torch.where(active, r + dr, r)
        # once done the loop below does not run: the stacks are not read
        dX[k], dR[k] = dx, dr
        nrm = torch.where(active, residual_norm(r, bnrm_inv, spec), nrm)
        slot = min(k + 1, top)
        rh[slot] = torch.where(active, nrm, rh[slot])
        Mmat[:, k] = _pmat(P, dr, spec.axis_name)
        itk = torch.where(active, itk + 1, itk)
        done = done | (nrm <= tol_eff)
    host_it = int(itk)              # the one read of the start phase
    if spec.live_print:
        print_rhistory(rh, 0, host_it, it_done=True)

    oldest = 0                      # the stack slot the next step writes

    def step(st):
        nonlocal host_it, oldest
        c = torch.linalg.solve_ex(Mmat, st["m"], check_errors=False).result
        vvec = st["r"] - c @ dR
        av = M.psolve(vvec)
        if host_it % (s + 1) == s:      # refresh omega
            t = A.matvec(av)
            h = v.dot(t, t, spec.axis_name)
            om = v.dot(t, vvec, spec.axis_name) / torch.where(h == 0, one, h)
            dx = om * av - c @ dX
            dr = -om * t - c @ dR
        else:
            om = st["om"]
            dx = om * av - c @ dX
            dr = -A.matvec(dx)
        h = _pmat(P, dr, spec.axis_name)
        dX[oldest], dR[oldest], Mmat[:, oldest] = dx, dr, h
        r = st["r"] + dr
        it = st["it"] + 1
        nrm = residual_norm(r, bnrm_inv, spec)
        host_it += 1
        oldest = (oldest + 1) % s
        return dict(it=it, flag=st["flag"], x=st["x"] + dx, r=r,
                    m=st["m"] + h, om=om, nrm=nrm,
                    rh=record(st["rh"], torch.clamp(it, max=top), nrm))

    state = dict(it=itk, flag=loop_scalar(RUNNING, b), x=x, r=r,
                 m=_pmat(P, r, spec.axis_name),
                 om=one, nrm=nrm, rh=rh)
    final = krylov_loop(spec, tol_eff, state, step, it_done=True)
    final["it"] = final["it"] + 1   # loop_output's it - 1 convention
    return loop_output(spec, tol_eff, final)


@register_solver("idrs")
def idrs(A, b, x0, M, spec: SolverSpec, aux=None) -> SolverOutput:
    return _idrs_core(A, b, x0, M, spec, aux)


@register_solver("idr1")
def idr1(A, b, x0, M, spec: SolverSpec, aux=None) -> SolverOutput:
    return _idrs_core(A, b, x0, M, spec, aux)
