"""SSOR preconditioner.

Port of ``lis_tpu/precon/ssor.py`` (reference lis_precon_create_ssor /
lis_psolve_ssor, src/precon/lis_precon_ssor.c:58,99): M = (D/ω + L)(I +
ωD⁻¹U), applied by a forward and a backward sweep with WD = (D/ω)⁻¹.
Options: -ssor_omega ω (default 1), -ssor_sweeps (relaxed sweeps, 2).

Two forms, chosen by the operator's format as in lis_tpu:

- ``SSORRelaxPrecon`` on a DIA operator: each triangular solve is
  replaced by a few Jacobi-relaxed sweeps over the strict triangle's
  diagonals, the dependency-dropping scheme the reference's own OpenMP
  solve uses across threads (src/matrix/lis_matrix_csr.c:1577-1605).  The
  triangles are row slices of the operator's diagonals (views: the port
  keeps DIA offsets sorted), and every sweep is one launch of kernel H
  (psolve) or I (psolveh), so a psolve is 2·nsweeps launches: the start
  vector of each series and the multiply by D/ω between the two are
  computed inside the sweeps.
- ``SSORPrecon`` on every other format: exact level-scheduled solves
  (``ops/trisolve.py``, kernel K), the backward one as (D/ω + U)x = (D/ω)y.
  psolveh solves Mᴴ with the transposed triangles.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from lis_tpu_torch.matrix.base import TensorFields, static
from lis_tpu_torch.matrix.dia import DIAMatrix
from lis_tpu_torch.matrix.split import split_matrix
from lis_tpu_torch.ops.trisolve import (TriSolvePlan, make_plan,
                                        sweep_series, trisolve)
from lis_tpu_torch.precon.base import register_precon
from lis_tpu_torch.utils.trace import psolve_span


@dataclasses.dataclass(frozen=True, eq=False)
class SSORPrecon(TensorFields):
    fwd: TriSolvePlan         # (D/ω + L)
    bwd: TriSolvePlan         # (D/ω + U)
    fwd_t: TriSolvePlan       # (I + ωUᴴD̄⁻¹)
    bwd_t: TriSolvePlan       # (D̄/ω + Lᴴ)
    dtil: torch.Tensor        # D/ω

    @psolve_span
    def psolve(self, r):
        y = trisolve(self.fwd, r)
        return trisolve(self.bwd, y, rs=self.dtil)

    @psolve_span
    def psolveh(self, r):
        z = trisolve(self.fwd_t, r)
        return trisolve(self.bwd_t, z)


@dataclasses.dataclass(frozen=True, eq=False)
class SSORRelaxPrecon(TensorFields):
    """SSOR by relaxed sweeps over the split DIA operator (lis_tpu
    ``SSORRelaxPrecon``, ssor.py:45-84), in lis_tpu's order of operations:

        fwd:  y = r·wd, then nsweeps × y = (r − L·y)·wd
        bwd:  with f = fwd(r)·dtil: z = f·wd, then nsweeps × z = (f − U·z)·wd
        psolveh: with w̄ = conj(wd): y = r, nsweeps × y = r − Uᴴ(w̄·y);
              z = y·w̄, nsweeps × z = (y − Lᴴz)·w̄
    """
    L: DIAMatrix              # strict-lower diagonals
    U: DIAMatrix              # strict-upper diagonals
    wd: torch.Tensor          # (D/ω)⁻¹
    dtil: torch.Tensor        # D/ω
    nsweeps: int = static()

    @psolve_span
    def psolve(self, r):
        ns, wd, dtil = self.nsweeps, self.wd, self.dtil
        if ns == 0:
            return (r * wd * dtil) * wd
        y = sweep_series(self.L, r, ns, w=wd)
        # the backward series on rhs = y·dtil, which each sweep forms itself
        return sweep_series(self.U, y, ns, w=wd, rs=dtil)

    @psolve_span
    def psolveh(self, r):
        ns, wd = self.nsweeps, self.wd
        if wd.is_complex():
            wd = wd.conj().resolve_conj()
        if ns == 0:
            return r * wd
        y = sweep_series(self.U, r, ns, y=r, s=wd, trans=True)
        return sweep_series(self.L, y, ns, w=wd, trans=True)


def _split_dia(A: DIAMatrix):
    """Strict-lower DIA, strict-upper DIA and the diagonal of a DIA matrix.
    With sorted offsets the triangles are row slices of ``A.value`` (no
    copy, as lis_tpu's zero-copy split intends); each triangle's nnz is
    counted with one host read."""
    offs = A.offsets
    low = [k for k, o in enumerate(offs) if o < 0]
    up = [k for k, o in enumerate(offs) if o > 0]
    return A.diagonals(low), A.diagonals(up), A.get_diagonal()


def _inv_where(d, w: float):
    """w/d where d != 0, else 1 (lis_tpu's WD)."""
    one = torch.ones_like(d)
    nz = d != 0
    return torch.where(nz, w / torch.where(nz, d, one), one)


@register_precon("ssor")
def create_ssor(A, opts):
    w = getattr(opts, "ssor_omega", 1.0)
    if getattr(A, "format_name", None) == "dia":
        ns = getattr(opts, "ssor_sweeps", 2)
        L, U, d = _split_dia(A)
        wd = _inv_where(d, w)
        dtil = torch.where(wd != 0, 1.0 / wd, torch.ones_like(wd))
        return SSORRelaxPrecon(L=L, U=U, wd=wd, dtil=dtil, nsweeps=int(ns))
    s = split_matrix(A)
    n = A.nrows
    dev = A.device
    d = s.D.cpu().numpy()
    with np.errstate(divide="ignore"):
        wd = np.where(d != 0, w / np.where(d != 0, d, 1), 1.0)   # (D/ω)⁻¹
    dtil = np.where(wd != 0, 1.0 / wd, 1.0)                      # D/ω

    lp, li, lv = s.L.to_csr_arrays()
    up, ui, uv = s.U.to_csr_arrays()
    fwd = make_plan(lp, li, lv, wd, lower=True, device=dev)
    bwd = make_plan(up, ui, uv, wd, lower=False, device=dev)

    # conjugate-transposed triangles for psolveh
    Lt = sp.csr_matrix((lv, li, lp), shape=A.shape).T.tocsr()
    Ut = sp.csr_matrix((uv, ui, up), shape=A.shape).T.tocsr()
    Lt.sort_indices()
    Ut.sort_indices()
    # (I + ωUᴴD̄⁻¹): strictly lower conj(Uᵀ·ω/d[col]), unit diagonal
    # multiplier; then (D̄/ω + Lᴴ) with conj(WD)
    utv = np.conj(Ut.data * (w / d[Ut.indices]))
    fwd_t = make_plan(Ut.indptr, Ut.indices, utv, np.ones(n), lower=True,
                      device=dev)
    bwd_t = make_plan(Lt.indptr, Lt.indices, np.conj(Lt.data), np.conj(wd),
                      lower=False, device=dev)
    return SSORPrecon(fwd=fwd, bwd=bwd, fwd_t=fwd_t, bwd_t=bwd_t,
                      dtil=torch.from_numpy(dtil).to(dev))
