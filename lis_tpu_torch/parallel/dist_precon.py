"""Distributed (block-local) preconditioners.

Port of ``lis_tpu/parallel/dist_precon.py``.  The reference's MPI
behaviour for ILU, SSOR and the other local preconditioners is block
Jacobi: each rank factors and sweeps only its owned diagonal block
(lis_precon_iluk.c: the factor loops run over local rows; the OpenMP
triangular solve drops out-of-block columns,
src/matrix/lis_matrix_csr.c:1577-1605).  lis_tpu extracts every shard's
block on the host, factors each with the serial create function and
stacks the plans for ``shard_map``; here each rank factors its own block
with the port's serial create function and applies it as it is (kernels
H, I, K of the serial preconditioners).  The blocks are lis_tpu's
exactly: ``nlocal`` rows, the padding rows of the last rank given a unit
diagonal.

The hybrid preconditioner's inner solve runs on the global sharded
system with the mesh as its ``axis_name`` (lis_precon_hybrid.c:165 under
MPI).  SA-AMG keeps lis_tpu's design: level 0 sharded (block-local SGS,
the distributed operator for residuals, the smoothed prolongator as the
rank's row slab, restriction one all-reduce), coarse levels above
``-saamg_shard_rows`` × p rows as row slabs with replicated vectors, and
the small tail replicated.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from lis_tpu_torch.matrix.base import TensorFields, static
from lis_tpu_torch.matrix.csr import CSRMatrix
from lis_tpu_torch.ops.trisolve import trisolve
from lis_tpu_torch.utils.trace import psolve_span


def _block_scipy(rows, cols, vals, lo, hi, nl) -> sp.csr_matrix:
    """The nl x nl diagonal block [lo, hi) of global triplets, padding
    rows past the true size given a unit diagonal."""
    m = (rows >= lo) & (rows < hi) & (cols >= lo) & (cols < hi)
    r, c, v = rows[m] - lo, cols[m] - lo, vals[m]
    npad = nl - (hi - lo)
    if npad > 0:
        r = np.concatenate([r, np.arange(hi - lo, nl)])
        c = np.concatenate([c, np.arange(hi - lo, nl)])
        v = np.concatenate([v, np.ones(npad, dtype=v.dtype)])
    b = sp.coo_matrix((v, (r, c)), shape=(nl, nl)).tocsr()
    b.sum_duplicates()
    b.sort_indices()
    return b


def local_diag_block(A) -> CSRMatrix:
    """This rank's diagonal block of a distributed matrix (any layout) as
    a CSRMatrix on the mesh's device (lis_tpu ``local_diag_blocks``, one
    block: no collective)."""
    rows, cols, vals = A._triplets()
    lo = min(A.k0, A.gn)
    hi = min(A.k0 + A.nlocal, A.gn)
    b = _block_scipy(rows, cols, vals, lo, hi, A.nlocal)
    return CSRMatrix.from_csr_arrays(b.indptr, b.indices, b.data,
                                     (A.nlocal, A.nlocal),
                                     device=A.mesh.device)


def make_dist_block_precon(A, mesh, opts, name=None):
    """Block-Jacobi version of any local preconditioner (the reference's
    MPI semantics for ILU/SSOR/SAINV/I+S): the rank's diagonal block
    factored by the serial create function.  ``-p ilu -storage bsr``
    factors it as BSR (block ILU), like the reference's per-rank BSR
    conversion before lis_precon_create (lis_solver.c:741)."""
    from lis_tpu_torch.precon.base import PRECON_REGISTRY
    name = name or opts.precon
    blk = local_diag_block(A)
    if name == "ilu" and getattr(opts, "storage", 0) == 7:
        from lis_tpu_torch.matrix.convert import convert_matrix
        blk = convert_matrix(blk, "bsr", device=blk.device,
                             bnr=getattr(opts, "storage_block", 2) or 2)
    return PRECON_REGISTRY[name](blk, opts)


@dataclasses.dataclass(frozen=True, eq=False)
class _TransposedOp(TensorFields):
    """Aᴴ as an operator view (matvec and matvech swapped): the
    distributed hybrid's psolveh inner solve without a transposed sharded
    matrix."""
    A: object

    def matvec(self, x):
        return self.A.matvech(x)

    def matvech(self, x):
        return self.A.matvec(x)

    def get_diagonal(self):
        d = self.A.get_diagonal()
        return d.conj() if d.is_complex() else d


def make_dist_hybrid(A, mesh, opts):
    """Distributed hybrid preconditioner: the inner solver runs on the
    global sharded system, its reductions over the mesh.  SOR and GS as
    the inner solver become CG (they would need block-local sweep plans),
    as in lis_tpu; -hybrid_p is not applied, as in lis_tpu."""
    from lis_tpu_torch.precon.hybrid import HybridPrecon
    from lis_tpu_torch.solvers.base import SolverSpec
    inner = getattr(opts, "hybrid_i", "sor")
    if inner in ("sor", "gs"):
        inner = "cg"
    spec = SolverSpec(solver=inner, tol=getattr(opts, "hybrid_tol", 1e-3),
                      maxiter=getattr(opts, "hybrid_maxiter", 25),
                      restart=getattr(opts, "hybrid_restart", 40),
                      ell=getattr(opts, "hybrid_ell", 2),
                      omega=getattr(opts, "hybrid_omega", 1.5),
                      conv_cond=0, axis_name=mesh)
    return HybridPrecon(A=A, At=_TransposedOp(A), aux=None, aux_t=None,
                        M=None, spec=spec)


# ---- SA-AMG over the mesh ---------------------------------------------------

def _slab(M: sp.csr_matrix, lo: int, nloc: int, dev) -> CSRMatrix:
    """Rows [lo, lo + nloc) of M as an nloc x ncols CSRMatrix (rows past
    M's end empty)."""
    M = M.tocsr()
    hi = min(lo + nloc, M.shape[0])
    part = M[lo:hi] if hi > lo else sp.csr_matrix((0, M.shape[1]))
    part = sp.vstack([part, sp.csr_matrix((nloc - part.shape[0],
                                           M.shape[1]))]).tocsr()
    part.sort_indices()
    return CSRMatrix.from_csr_arrays(part.indptr, part.indices, part.data,
                                     (nloc, M.shape[1]), device=dev)


def _sgs_of_block(M: sp.csr_matrix, lo: int, nloc: int, dev):
    """SGS level plans of M's nloc-sized diagonal block at lo (unit
    diagonal on padding rows)."""
    from lis_tpu_torch.precon.saamg import _sgs_plans
    C = M.tocoo()
    n = M.shape[0]
    blk = _block_scipy(C.row.astype(np.int64), C.col.astype(np.int64),
                       C.data, min(lo, n), min(lo + nloc, n), nloc)
    return _sgs_plans(blk, dev)


@dataclasses.dataclass(frozen=True, eq=False)
class DistAMGMidLevel(TensorFields):
    """One mesh-sharded coarse level (lis_tpu ``DistAMGMidLevel``; the
    reference's per-level distributed AMG data,
    lis_m_data_structure_for_AMG.F90:36): the rank's row slabs of A_l and
    P_l and block-local SGS plans; the level's vectors are replicated, so
    a slab product is local and one all-gather."""
    A: CSRMatrix              # (nloc, n) rows of the level operator
    P: CSRMatrix              # (nloc, nc) rows of the prolongator
    fwd: object
    bwd: object
    mesh: object = static()
    n: int = static()
    nc: int = static()
    nloc: int = static()

    def local(self, x):
        lo = self.mesh.rank * self.nloc
        out = x.new_zeros(self.nloc)
        have = x[lo:min(lo + self.nloc, self.n)]
        out[: have.shape[0]] = have
        return out

    def gather(self, x_loc):
        return self.mesh.all_gather(x_loc)[: self.n]

    def matvec(self, x):
        return self.gather(self.A.matvec(x))

    def gs(self, b, lower):
        return trisolve(self.fwd if lower else self.bwd, self.local(b))

    def restrict(self, r):
        return self.mesh.all_reduce(self.P.matvech(self.local(r)))

    def prolong_local(self, ec):
        return self.P.matvec(ec)


@dataclasses.dataclass(frozen=True, eq=False)
class DistSAAMGPrecon(TensorFields):
    """Distributed smoothed-aggregation AMG (lis_tpu ``DistSAAMGPrecon``):
    level 0 on the rank's rows (block-local SGS, residuals through the
    distributed operator, the prolongator's row slab ``P0``), restriction
    one all-reduce of the coarse vector, then the sharded mid levels and
    the replicated tail (a serial ``SAAMGPrecon``)."""
    A0: object
    P0: CSRMatrix             # (nlocal, n1) rows of the level-0 prolongator
    fwd: object
    bwd: object
    mids: tuple
    coarse: object
    mesh: object = static()

    def _smooth(self, x, b):
        x = x + trisolve(self.fwd, b - self.A0.matvec(x))
        return x + trisolve(self.bwd, b - self.A0.matvec(x))

    def _mid_cycle(self, i, b):
        if i == len(self.mids):
            return self.coarse.psolve(b)
        m = self.mids[i]
        x_loc = m.gs(b, lower=True)
        x = m.gather(x_loc)
        x_loc = x_loc + m.gs(b - m.matvec(x), lower=False)
        x = m.gather(x_loc)
        rc = m.restrict(b - m.matvec(x))
        ec = self._mid_cycle(i + 1, rc)
        x_loc = x_loc + m.prolong_local(ec)
        x = m.gather(x_loc)
        x_loc = x_loc + m.gs(b - m.matvec(x), lower=True)
        x = m.gather(x_loc)
        x_loc = x_loc + m.gs(b - m.matvec(x), lower=False)
        return m.gather(x_loc)

    @psolve_span
    def psolve(self, r):
        x = trisolve(self.fwd, r)
        x = x + trisolve(self.bwd, r - self.A0.matvec(x))
        rc = self.mesh.all_reduce(self.P0.matvech(r - self.A0.matvec(x)))
        ec = self._mid_cycle(0, rc)
        x = x + self.P0.matvec(ec)
        return self._smooth(x, r)

    @psolve_span
    def psolveh(self, r):
        return self.psolve(r)               # symmetric hierarchy


def make_dist_saamg(A, mesh, opts) -> DistSAAMGPrecon:
    """The hierarchy of lis_tpu's ``make_dist_saamg``: the graph
    aggregation of the global operator (collected from the shards; every
    rank builds the same hierarchy on the host), the symmetric variant."""
    from lis_tpu_torch.parallel.dist import _global_scipy
    from lis_tpu_torch.precon.saamg import (AMGLevel, SAAMGPrecon,
                                            _dinv_of, _sgs_plans,
                                            build_hierarchy)
    gs = _global_scipy(A)
    raw, A_coarse = build_hierarchy(gs, theta=getattr(opts, "saamg_theta",
                                                      0.05))
    if not raw:
        raise ValueError("saamg: operator too small to build a hierarchy; "
                         "use -p jacobi or a direct solve")
    p, nl, dev = mesh.size, A.nlocal, mesh.device
    lo = mesh.rank * nl
    A0, P0, _ = raw[0]
    fwd, bwd = _sgs_of_block(A0.tocsr(), lo, nl, dev)

    shard_rows = int(getattr(opts, "saamg_shard_rows", 256))
    lvl, mids = 1, []
    while lvl < len(raw) and raw[lvl][0].shape[0] > shard_rows * p:
        Al, Pl, _ = raw[lvl]
        n_l = Al.shape[0]
        nloc = -(-n_l // p)
        f_l, b_l = _sgs_of_block(Al.tocsr(), mesh.rank * nloc, nloc, dev)
        mids.append(DistAMGMidLevel(
            A=_slab(Al, mesh.rank * nloc, nloc, dev),
            P=_slab(Pl, mesh.rank * nloc, nloc, dev), fwd=f_l, bwd=b_l,
            mesh=mesh, n=n_l, nc=Pl.shape[1], nloc=nloc))
        lvl += 1

    levels = []
    for Al, Pl, _ in raw[lvl:]:
        f, b = _sgs_plans(Al, dev)
        Al, Pl = Al.tocsr(), Pl.tocsr()
        Al.sort_indices()
        Pl.sort_indices()
        levels.append(AMGLevel(
            A=CSRMatrix.from_csr_arrays(Al.indptr, Al.indices, Al.data,
                                        Al.shape, device=dev),
            dinv=torch.from_numpy(_dinv_of(Al)).to(dev),
            P=CSRMatrix.from_csr_arrays(Pl.indptr, Pl.indices, Pl.data,
                                        Pl.shape, device=dev),
            fwd=f, bwd=b))
    coarse = SAAMGPrecon(levels=tuple(levels), coarse_inv=torch.from_numpy(
        np.linalg.inv(A_coarse.toarray())).to(dev), smoother="sgs")
    return DistSAAMGPrecon(A0=A, P0=_slab(P0, lo, nl, dev), fwd=fwd,
                           bwd=bwd, mids=tuple(mids), coarse=coarse,
                           mesh=mesh)

