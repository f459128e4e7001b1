"""Stationary solvers: Jacobi, Gauss-Seidel, SOR.

Port of ``lis_tpu/solvers/stationary.py`` (reference lis_jacobi,
src/solver/lis_solver_jacobi.c:113, lis_gs, lis_solver_gs.c:113, lis_sor,
lis_solver_sor.c:123).  All three are right-preconditioned
defect-correction loops: s = M⁻¹x, r = b − As, x += W r, exiting with x =
M⁻¹x.  W is D⁻¹ (Jacobi), (D + L)⁻¹ (GS) or (D/ω + L)⁻¹ (SOR, -omega,
default 1.9).  The lower solve is set up on the host by the prepare hook
(the reference's lis_matrix_split and WD setup): on a DIA operator with
ω ≤ 1.5, three relaxed sweeps of its strict-lower diagonals (kernel H);
otherwise a level-scheduled plan (kernel K).  Convergence reads the raw
‖r‖₂/‖b‖₂ whatever -conv_cond says, as the reference does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lis_tpu_torch.core import vector as v
from lis_tpu_torch.matrix.base import TensorFields, static
from lis_tpu_torch.matrix.dia import DIAMatrix
from lis_tpu_torch.ops.trisolve import make_plan, sweep_series, trisolve
from lis_tpu_torch.solvers.base import (RUNNING, SolverOutput, SolverSpec,
                                        krylov_loop, loop_output,
                                        loop_scalar, new_rhistory, record,
                                        register_prepare, register_solver)


def _stationary(A, b, x0, M, spec, apply_w):
    bn = v.nrm2(b, spec.axis_name)
    one = torch.ones_like(bn)
    bnrm_inv = torch.where(bn == 0, one, 1.0 / torch.where(bn == 0, one, bn))
    r0 = b - A.matvec(M.psolve(x0))
    nrm0 = v.nrm2(r0, spec.axis_name) * bnrm_inv
    rh = new_rhistory(spec, nrm0, b.real.dtype)

    state = dict(it=loop_scalar(1, b), flag=loop_scalar(RUNNING, b),
                 x=x0, nrm=nrm0, rh=rh)

    def step(s):
        r = b - A.matvec(M.psolve(s["x"]))
        nrm = v.nrm2(r, spec.axis_name) * bnrm_inv
        return dict(it=s["it"] + 1, flag=s["flag"], x=s["x"] + apply_w(r),
                    nrm=nrm, rh=record(s["rh"], s["it"], nrm))

    final = krylov_loop(spec, spec.tol, state, step)
    out = loop_output(spec, spec.tol, final)
    # exit through psolve, as the reference does (x = M⁻¹x on return)
    return out._replace(x=M.psolve(out.x))


@dataclasses.dataclass(frozen=True, eq=False)
class _LowerSweep(TensorFields):
    """(D/ω + L)⁻¹ by Jacobi-relaxed sweeps of the strict-lower diagonals
    (lis_tpu ``_LowerSweep``, stationary.py:52-65): y = r·wd, then nsweeps
    × y = (r − L·y)·wd, each one launch of kernel H."""
    L: DIAMatrix
    wd: torch.Tensor
    nsweeps: int = static()

    def apply(self, r):
        return sweep_series(self.L, r, self.nsweeps, w=self.wd)


def _lower_plan(A, w: float = 1.0):
    """The (D/ω + L) solve: WD = (D/ω)⁻¹.  A DIA operator with ω ≤ 1.5 gets
    the relaxed sweeps; every other case a level plan.  The truncated
    sweeps' Neumann terms decay like (ω·|L|/D)^k, which SOR's default 1.9
    barely does on Poisson-class operators, hence lis_tpu's gate."""
    if getattr(A, "format_name", None) == "dia" and w <= 1.5:
        from lis_tpu_torch.precon.ssor import _inv_where, _split_dia
        L, _, d = _split_dia(A)
        return _LowerSweep(L=L, wd=_inv_where(d, w), nsweeps=3)
    from lis_tpu_torch.matrix.split import split_matrix
    s = split_matrix(A)
    ptr, index, value = s.L.to_csr_arrays()
    d = s.D.cpu().numpy()
    with np.errstate(divide="ignore"):
        dinv = np.where(d != 0, w / np.where(d != 0, d, 1), 1.0)
    return make_plan(ptr, index, value, dinv, lower=True, device=A.device)


@register_prepare("gs")
def prepare_gs(A, spec):
    return _lower_plan(A, 1.0)


@register_prepare("sor")
def prepare_sor(A, spec):
    return _lower_plan(A, spec.omega)


@register_solver("jacobi")
def jacobi(A, b, x0, M, spec: SolverSpec, aux=None) -> SolverOutput:
    d = A.get_diagonal()
    one = torch.ones_like(d)
    dinv = torch.where(d != 0, 1.0 / torch.where(d != 0, d, one), one)
    return _stationary(A, b, x0, M, spec, lambda r: dinv * r)


def _w_apply(aux):
    if isinstance(aux, _LowerSweep):
        return aux.apply
    return lambda r: trisolve(aux, r)


@register_solver("gs")
def gs(A, b, x0, M, spec: SolverSpec, aux=None) -> SolverOutput:
    return _stationary(A, b, x0, M, spec, _w_apply(aux))


@register_solver("sor")
def sor(A, b, x0, M, spec: SolverSpec, aux=None) -> SolverOutput:
    return _stationary(A, b, x0, M, spec, _w_apply(aux))
