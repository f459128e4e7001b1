"""SA-AMG — smoothed-aggregation algebraic multigrid preconditioner.

Port of ``lis_tpu/precon/saamg.py`` (reference: the Fortran-90 AMG of
src/fortran/amg/: independent-set aggregation, lis_m_aggregate_mod.F90:45;
smoothed prolongator and Galerkin coarse operators,
lis_m_data_creation_AMGCG.F90:61; a V-cycle with symmetric Gauss-Seidel
smoothing and a direct coarsest solve, lis_m_solver_AMGCG.F90:50+).
Options: -saamg_theta (strength threshold, 0.05), -saamg_unsym
(Petrov-Galerkin restriction), -saamg_smoother sgs|jacobi, -saamg_lattice
(the lattice path, default true).  The reference's AMG is real-only, so
complex operators raise NotImplementedError.

The hierarchy is built once on the host with scipy.  Two paths, as in
lis_tpu:

- **Lattice** (a structured operator whose band offsets give its lattice
  dims, ``detect_lattice``): aggregates are 3x boxes per dimension, every
  level keeps the lattice, and its operator routes to DIA.  The smoothed
  prolongator P, which scipy forms for the Galerkin product, is kept on
  the device with its transpose (``LatticeTransfer``, where lis_tpu
  applies it without forming it): the prolongation is one launch of
  kernel J and the restriction one of kernel L (``ops/amg.py``).  The SGS
  smoother runs relaxed sweeps of the level's DIA triangles (kernel H)
  and each residual b − A·x is one launch of H over all of A's
  diagonals.
- **Graph** (anything else, -saamg_lattice false, -saamg_unsym): greedy
  aggregation on the strength graph, explicit prolongators as multi-BES
  slabs where they fit (kernels Q and R, as lis_tpu's
  ``_fast_prolongator``) and as CSR otherwise, level operators through
  ``auto_storage`` (which may pick BES too), and exact level-scheduled SGS
  (kernel K).  With -saamg_unsym the adjoint cycle runs on the transposed
  hierarchy.

The coarsest level (at most 4096 rows) applies a dense inverse with
``torch.matmul``, as lis_tpu applies ``coarse_inv @ b`` outside any Pallas
kernel.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from lis_tpu_torch.matrix.base import TensorFields, static
from lis_tpu_torch.matrix.csr import CSRMatrix
from lis_tpu_torch.matrix.dia import DIAMatrix, dia_relax, dia_relaxh
from lis_tpu_torch.ops.amg import (OMEGA, LatticeTransfer, lattice_prolong,
                                   lattice_restrict)
from lis_tpu_torch.ops.trisolve import (TriSolvePlan, make_plan,
                                        sweep_series, trisolve)
from lis_tpu_torch.precon.base import register_precon
from lis_tpu_torch.utils.trace import psolve_span

COARSE_MAX = 4096             # rows the dense coarsest solve may have


@dataclasses.dataclass(frozen=True, eq=False)
class AMGLevel(TensorFields):
    A: object                 # the level operator (DIA on a lattice level)
    dinv: torch.Tensor        # 1/diag(A) (1 where the diagonal is 0)
    transfer: LatticeTransfer = None  # lattice: P and Pᵀ for J and L
    P: object = None          # graph: the prolongator l+1 -> l (BES/CSR)
    R: CSRMatrix = None       # -saamg_unsym: the restriction (else Pᵀ)
    Ls: DIAMatrix = None      # strict-lower DIA (relaxed-sweep SGS)
    Us: DIAMatrix = None      # strict-upper DIA
    fwd: TriSolvePlan = None  # (D+L) plan for the exact SGS
    bwd: TriSolvePlan = None  # (D+U)
    fwdh: TriSolvePlan = None  # (D+U)ᵀ and (D+L)ᵀ: the unsym adjoint cycle
    bwdh: TriSolvePlan = None


def _residual(A, b, x, herm: bool = False):
    """b − A·x (Aᴴ with ``herm``): one launch of kernel H (I) over all of
    a square DIA's diagonals, else A's product and a subtraction."""
    if isinstance(A, DIAMatrix) and A.nrows == A.ncols:
        return (dia_relaxh if herm else dia_relax)(A, b, x)
    return b - (A.matvech(x) if herm else A.matvec(x))


def _coarse(Ainv, b):
    dt = torch.promote_types(Ainv.dtype, b.dtype)
    return torch.matmul(Ainv.to(dt), b.to(dt))


@dataclasses.dataclass(frozen=True, eq=False)
class SAAMGPrecon(TensorFields):
    levels: tuple             # AMGLevel, finest first
    coarse_inv: torch.Tensor  # dense inverse of the coarsest operator
    smoother: str = static()  # "sgs" (reference parity) | "jacobi"

    def _gs(self, level, b, lower, nsweeps=2):
        """One Gauss-Seidel half-sweep solve (D+T)x = b: relaxed sweeps of
        the DIA triangle, x = b·dinv then nsweeps × x = (b − T·x)·dinv
        (kernel H), or the exact level-scheduled solve (kernel K)."""
        if level.Ls is not None:
            return sweep_series(level.Ls if lower else level.Us, b, nsweeps,
                                w=level.dinv)
        return trisolve(level.fwd if lower else level.bwd, b)

    def _presmooth(self, level, b):
        if self.smoother == "jacobi":
            x = OMEGA * level.dinv * b
            return x + OMEGA * level.dinv * _residual(level.A, b, x)
        x = self._gs(level, b, lower=True)
        return x + self._gs(level, _residual(level.A, b, x), lower=False)

    def _postsmooth(self, level, x, b):
        if self.smoother == "jacobi":
            x = x + OMEGA * level.dinv * _residual(level.A, b, x)
            return x + OMEGA * level.dinv * _residual(level.A, b, x)
        x = x + self._gs(level, _residual(level.A, b, x), lower=True)
        return x + self._gs(level, _residual(level.A, b, x), lower=False)

    def _cycle(self, lev: int, b):
        if lev == len(self.levels):
            return _coarse(self.coarse_inv, b)
        level = self.levels[lev]
        x = self._presmooth(level, b)
        # the coarse-grid correction
        r = _residual(level.A, b, x)
        if level.transfer is not None:
            rc = lattice_restrict(level.transfer, r)
            ec = self._cycle(lev + 1, rc)
            x = lattice_prolong(level.transfer, ec, x)
        else:
            rc = (level.R.matvec(r) if level.R is not None
                  else level.P.matvech(r))
            x = x + level.P.matvec(self._cycle(lev + 1, rc))
        return self._postsmooth(level, x, b)

    # ---- the adjoint cycle.  The -saamg_unsym Petrov-Galerkin hierarchy
    # makes M nonsymmetric, so the BiCG family's psolveh must apply M⁻ᴴ.
    # Post-smoothing is two corrections of the smoother that pre-smoothing
    # applies, so the adjoint of the V-cycle is a V-cycle of the same shape
    # on the transposed hierarchy: A -> Aᵀ, prolongation Rᵀ, restriction
    # Pᵀ, and the SGS half-sweeps swap triangles.
    def _gs_h(self, level, b, lower, nsweeps=2):
        if level.Ls is not None:
            # the transpose of the truncated sweeps: z = b, nsweeps ×
            # z = b − Tᴴ(dinv·z), then dinv·z (kernel I); unreached while
            # -saamg_unsym takes the graph path, as in lis_tpu
            z = sweep_series(level.Us if lower else level.Ls, b, nsweeps,
                             y=b, s=level.dinv, trans=True)
            return level.dinv * z
        return trisolve(level.fwdh if lower else level.bwdh, b)

    def _presmooth_h(self, level, b):
        if self.smoother == "jacobi":
            x = OMEGA * level.dinv * b
            return x + OMEGA * level.dinv * _residual(level.A, b, x, True)
        x = self._gs_h(level, b, lower=True)
        return x + self._gs_h(level, _residual(level.A, b, x, True),
                              lower=False)

    def _postsmooth_h(self, level, x, b):
        if self.smoother == "jacobi":
            x = x + OMEGA * level.dinv * _residual(level.A, b, x, True)
            return x + OMEGA * level.dinv * _residual(level.A, b, x, True)
        x = x + self._gs_h(level, _residual(level.A, b, x, True), lower=True)
        return x + self._gs_h(level, _residual(level.A, b, x, True),
                              lower=False)

    def _cycle_h(self, lev: int, b):
        if lev == len(self.levels):
            return _coarse(self.coarse_inv.mT, b)
        level = self.levels[lev]
        x = self._presmooth_h(level, b)
        r = _residual(level.A, b, x, True)
        ec = self._cycle_h(lev + 1, level.P.matvech(r))   # restriction Pᵀ
        x = x + level.R.matvech(ec)                       # prolongation Rᵀ
        return self._postsmooth_h(level, x, b)

    @psolve_span
    def psolve(self, r):
        return self._cycle(0, r)

    @psolve_span
    def psolveh(self, r):
        # with R = Pᵀ and a symmetric A the cycle is its own adjoint; the
        # Petrov-Galerkin hierarchy runs the transposed cycle
        if any(level.R is not None for level in self.levels):
            return self._cycle_h(0, r)
        return self._cycle(0, r)


# ---- host set-up -------------------------------------------------------------

def _aggregate(S: sp.csr_matrix) -> np.ndarray:
    """Greedy independent-set aggregation (the reference's aggregate_mod
    scheme): roots whose strong neighbourhood is unaggregated take it, then
    leftovers join a neighbouring aggregate.  The native ``amg_aggregate``,
    with this Python loop as the fallback."""
    from lis_tpu_torch import _native
    out = _native.amg_aggregate(S.indptr, S.indices)
    if out is not None:
        return out[1].astype(np.int64)
    n = S.shape[0]
    agg = np.full(n, -1, dtype=np.int64)
    nagg = 0
    for i in range(n):
        if agg[i] != -1:
            continue
        neigh = S.indices[S.indptr[i]:S.indptr[i + 1]]
        if (agg[neigh] == -1).all():
            agg[i] = nagg
            agg[neigh] = nagg
            nagg += 1
    for i in range(n):
        if agg[i] != -1:
            continue
        neigh = S.indices[S.indptr[i]:S.indptr[i + 1]]
        hit = neigh[agg[neigh] != -1]
        if len(hit):
            agg[i] = agg[hit[0]]
        else:
            agg[i] = nagg
            nagg += 1
    return agg


def _strength(A: sp.csr_matrix, theta: float) -> sp.csr_matrix:
    d = np.abs(A.diagonal())
    d[d == 0] = 1.0
    C = A.tocoo()
    keep = (np.abs(C.data) > theta * np.sqrt(d[C.row] * d[C.col])) \
        & (C.row != C.col)
    return sp.csr_matrix((np.ones(keep.sum()),
                          (C.row[keep], C.col[keep])), shape=A.shape)


def detect_lattice(A_csr: sp.csr_matrix, max_band: int = 13):
    """The tensor-lattice dims (slowest..fastest) of a lexicographic
    stencil operator, recovered from its band offsets, or None (lis_tpu
    ``detect_lattice``).  The positive offsets cluster around the strides
    {1, L, L·M}; gap-splitting extracts them, and every offset must then
    decompose into small digits."""
    n = A_csr.shape[0]
    if A_csr.shape[0] != A_csr.shape[1] or n < 27:
        return None
    C = A_csr.tocoo()
    # np.unique(col − row) by counting: the same sorted offsets, without
    # sorting every entry
    seen = np.bincount(C.col.astype(np.int64) - C.row + (n - 1),
                       minlength=2 * n - 1)
    offs = np.flatnonzero(seen) - (n - 1)
    if len(offs) > 343:
        return None
    pos = offs[offs > 0]
    if len(pos) == 0:
        return None
    groups = [[int(pos[0])]]
    for o in pos[1:]:
        if o - groups[-1][-1] > max(2, groups[-1][-1]):
            groups.append([int(o)])
        else:
            groups[-1].append(int(o))
    if len(groups) > 3:
        return None
    if groups[0][0] > max_band:
        return None                      # no unit-stride band
    r1 = groups[0][-1]
    if r1 > max_band:
        return None
    strides = [1]
    for g in groups[1:]:
        strides.append(int(round(float(np.mean(g)))))
    for a, b in zip(strides, strides[1:]):
        if b % a != 0:
            return None
    if n % strides[-1] != 0:
        return None
    dims = []
    prev = n
    for s in reversed(strides):
        dims.append(prev // s)
        prev = s
    if any(d < 3 for d in dims):
        return None
    sts = list(reversed(strides))
    for o in offs:
        rem = int(o)
        for s in sts:
            d = int(round(rem / s))      # the nearest digit (an offset can
            rem -= d * s                 # be -(LM+L+1): digits -1, -1, -1)
            if abs(d) > max(2, r1):
                return None
        if rem != 0:
            return None
    return tuple(int(d) for d in dims)


def _lattice_agg(fdims, cdims):
    """The box (3x decimation) of every fine index."""
    coords = np.unravel_index(np.arange(int(np.prod(fdims))), fdims)
    return np.ravel_multi_index([c // 3 for c in coords], cdims)


def _dinv_of(A: sp.csr_matrix) -> np.ndarray:
    d = A.diagonal()
    return 1.0 / np.where(d != 0, d, 1.0)


def lattice_prolongator(A: sp.csr_matrix, dims):
    """The smoothed prolongator of one lattice level (lis_tpu's
    ``build_hierarchy_lattice`` step): P = (I − ω D⁻¹A)·Pt for the 3x box
    decimation Pt of ``dims``.  Returns (P, cdims, wc, dinv)."""
    cdims = tuple((d + 2) // 3 for d in dims)
    agg = _lattice_agg(dims, cdims)
    nc = int(np.prod(cdims))
    wc = 1.0 / np.sqrt(np.bincount(agg, minlength=nc).astype(float))
    Pt = sp.csr_matrix((wc[agg], (np.arange(A.shape[0]), agg)),
                       shape=(A.shape[0], nc))
    dinv = _dinv_of(A)
    P = (Pt - OMEGA * sp.diags(dinv) @ (A @ Pt)).tocsr()
    return P, cdims, wc, dinv


def build_hierarchy_lattice(A_csr: sp.csr_matrix, fdims,
                            max_levels: int = 12, coarse_size: int = 300):
    """The box-decimation hierarchy on a detected lattice (lis_tpu
    ``build_hierarchy_lattice``): the Galerkin operator of a 3x box
    decimation is again a stencil on the coarse lattice, so every level
    keeps the lattice.  Returns ([(A, P, dims, cdims, wc, dinv)], the
    coarsest operator)."""
    levels = []
    A = A_csr.tocsr()
    dims = tuple(fdims)
    while (A.shape[0] > coarse_size and min(dims) >= 3
           and len(levels) < max_levels - 1):
        P, cdims, wc, dinv = lattice_prolongator(A, dims)
        Ac = (P.T @ A @ P).tocsr()
        Ac.sort_indices()
        levels.append((A, P, dims, cdims, wc, dinv))
        A = Ac
        dims = cdims
    return levels, A


def build_hierarchy(A_csr: sp.csr_matrix, theta: float = 0.05,
                    max_levels: int = 10, coarse_size: int = 32,
                    unsym: bool = False):
    """Aggregation, smoothed prolongator and Galerkin product per level
    (lis_tpu ``build_hierarchy``).  A theta above the operator's
    off-diagonal strength ratio leaves every node isolated, so theta is
    relaxed (÷4) until the aggregation coarsens.  ``unsym`` is
    -saamg_unsym (reference data_creation_unsym_ssi_amg,
    lis_m_data_creation_AMGCG.F90:158): strength on the symmetrised graph
    and R = ((I − ω D⁻¹Aᵀ)Pt)ᵀ, so the coarse operators are R·A·P.
    Returns ([(A, P, R or None)], the coarsest operator)."""
    levels = []
    A = A_csr.tocsr()
    while A.shape[0] > coarse_size and len(levels) < max_levels - 1:
        th = theta
        Astr = (0.5 * (abs(A) + abs(A.T.tocsr()))).tocsr() if unsym else A
        while True:
            agg = _aggregate(_strength(Astr, th))
            nc = int(agg.max()) + 1
            if nc < A.shape[0] or th < 1e-4:
                break
            th = th / 4.0
        if nc >= A.shape[0]:      # the aggregation stalled even at theta ~0
            break
        counts = np.bincount(agg, minlength=nc).astype(float)
        Pt = sp.csr_matrix((1.0 / np.sqrt(counts[agg]),
                            (np.arange(A.shape[0]), agg)),
                           shape=(A.shape[0], nc))
        dinv = _dinv_of(A)
        P = (Pt - OMEGA * sp.diags(dinv) @ (A @ Pt)).tocsr()
        if unsym:
            W = (Pt - OMEGA * sp.diags(dinv) @ (A.T.tocsr() @ Pt))
            R = W.T.tocsr()
            Ac = (R @ A @ P).tocsr()
        else:
            R = None
            Ac = (P.T @ A @ P).tocsr()
        Ac.sort_indices()
        levels.append((A, P, R))
        A = Ac
    return levels, A


def _sgs_plans(A: sp.csr_matrix, device):
    """Level plans of (D+L) and (D+U) with multiplier 1/diag."""
    n = A.shape[0]
    C = A.tocoo()
    d = np.zeros(n)
    dm = C.row == C.col
    np.add.at(d, C.row[dm], C.data[dm])
    with np.errstate(divide="ignore"):
        dinv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 1.0)

    def tri(mask, lower):
        r, c, v = C.row[mask], C.col[mask], C.data[mask]
        order = np.lexsort((c, r))
        r, c, v = r[order], c[order], v[order]
        ptr = np.zeros(n + 1, dtype=np.int32)
        np.add.at(ptr, r + 1, 1)
        ptr = np.cumsum(ptr).astype(np.int32)
        return make_plan(ptr, c.astype(np.int32), v, dinv, lower=lower,
                         device=device)

    return tri(C.row > C.col, True), tri(C.row < C.col, False)


def _level_op(m: sp.csr_matrix, device, fine=None):
    """The level operator through ``auto_storage`` (DIA, HDI, BES, CST or CSS
    where the structure allows, else the CSR), as lis_tpu routes it.  The
    finest level reuses the solve's operator when that is already DIA."""
    if fine is not None and getattr(fine, "format_name", None) == "dia":
        return fine
    from lis_tpu_torch.solvers.driver import auto_storage
    return auto_storage(CSRMatrix.from_csr_arrays(
        m.indptr, m.indices, m.data, m.shape, device=device))


def _lattice_levels(raw_levels, smoother, A_fine):
    """Device levels of the lattice hierarchy: DIA level operators (H runs
    the level's residuals on the diagonals: an operator routed elsewhere
    gets a DIA copy, which a lattice's at most 343 offsets always allow),
    the assembled transfers of J and L, and the DIA triangles of the SGS
    sweeps (level plans if the operator did not route to DIA)."""
    dev = A_fine.device
    levels = []
    for k, (Al, P, _fd, _cd, _wc, dinv) in enumerate(raw_levels):
        Aop = _level_op(Al, dev, A_fine if k == 0 else None)
        routed = getattr(Aop, "format_name", None) == "dia"
        D = Aop if routed else DIAMatrix.from_csr_arrays(
            Al.indptr, Al.indices, Al.data, Al.shape, device=dev)
        kw = {}
        if smoother != "jacobi":
            if routed:
                from lis_tpu_torch.precon.ssor import _split_dia
                kw["Ls"], kw["Us"], _ = _split_dia(D)
            else:
                kw["fwd"], kw["bwd"] = _sgs_plans(Al, dev)
        levels.append(AMGLevel(
            A=D, dinv=torch.from_numpy(dinv).to(dev),
            transfer=LatticeTransfer.from_scipy(P, dev), **kw))
    return levels


def _fast_prolongator(m: sp.csr_matrix, device):
    """The prolongator as multi-BES slabs (lis_tpu ``_fast_prolongator``,
    saamg.py:518-539): its columns track the rows at slope ncols/nrows in
    one affine band per plane neighbour of the fine stencil, so up to 12
    strided windows under a 2 GiB budget, accepted at fill blowup <= 512
    and remainder <= 20 % of the nnz; else the CSR.  Only the builder's
    own ``NothingCovers`` (an empty P) is caught."""
    from lis_tpu_torch.matrix.bes import fitting_multi_bes
    bp = fitting_multi_bes(m.indptr, m.indices, m.data, m.shape, 512, 0.2,
                           max_windows=12, max_bytes=2 << 30)
    if bp is not None:
        return bp.to(device)
    return CSRMatrix.from_csr_arrays(m.indptr, m.indices, m.data, m.shape,
                                     device=device)


def _graph_levels(raw_levels, A_fine):
    dev = A_fine.device
    levels = []
    for k, (Al, Pl, Rl) in enumerate(raw_levels):
        fwd, bwd = _sgs_plans(Al, dev)
        Al.sort_indices()
        Pl.sort_indices()
        kw = {}
        if Rl is not None:
            Rl.sort_indices()
            kw["R"] = CSRMatrix.from_csr_arrays(Rl.indptr, Rl.indices,
                                                Rl.data, Rl.shape, device=dev)
            # plans of the adjoint cycle: the triangles of Aᵀ
            kw["fwdh"], kw["bwdh"] = _sgs_plans(Al.T.tocsr(), dev)
        levels.append(AMGLevel(
            A=_level_op(Al, dev, A_fine if k == 0 else None),
            dinv=torch.from_numpy(_dinv_of(Al)).to(dev),
            P=_fast_prolongator(Pl, dev),
            fwd=fwd, bwd=bwd, **kw))
    return levels


@register_precon("saamg")
def create_saamg(A, opts):
    ptr, index, value = A.to_csr_arrays()
    if np.iscomplexobj(value):
        raise NotImplementedError(
            "saamg does not support complex operators (the reference's "
            "F90 AMG is real-only)")
    A_sp = sp.csr_matrix((value, index, ptr), shape=A.shape)
    smoother = getattr(opts, "saamg_smoother", "sgs")
    unsym = bool(getattr(opts, "saamg_unsym", False))

    fdims = detect_lattice(A_sp) if getattr(opts, "saamg_lattice", True) \
        and not unsym else None
    if fdims is not None:
        raw_levels, A_coarse = build_hierarchy_lattice(A_sp, fdims)
        if raw_levels and A_coarse.shape[0] <= COARSE_MAX:
            return SAAMGPrecon(
                levels=tuple(_lattice_levels(raw_levels, smoother, A)),
                coarse_inv=_coarse_inv(A_coarse, A.device),
                smoother=smoother)

    raw_levels, A_coarse = build_hierarchy(
        A_sp, theta=getattr(opts, "saamg_theta", 0.05), unsym=unsym)
    if A_coarse.shape[0] > COARSE_MAX:
        raise ValueError(
            f"saamg: hierarchy failed to coarsen (coarsest level "
            f"{A_coarse.shape[0]} rows); the operator has no usable "
            "strength structure — use -p ssor/ilu instead")
    return SAAMGPrecon(levels=tuple(_graph_levels(raw_levels, A)),
                       coarse_inv=_coarse_inv(A_coarse, A.device),
                       smoother=smoother)


def _coarse_inv(A_coarse: sp.csr_matrix, device) -> torch.Tensor:
    return torch.from_numpy(np.linalg.inv(A_coarse.toarray())).to(device)
