"""SA-AMG's coarse-grid transfers on a lattice: kernels J and L.

Port of the lattice prolongator of ``lis_tpu/precon/saamg.py``
(``LatticeTent``, :298-327, and ``ImplicitP``, :330-352).  On a lattice
of dims f (slowest to fastest) the aggregates are boxes of 3 points per
dimension (cropped at the far edges), c = ceil(f/3) of them per dimension.
The tentative prolongator Pt broadcasts a coarse value over its box,
scaled by wc = 1/sqrt(|box|), and the smoothed prolongator is
P = (I − ω·D⁻¹A)·Pt (ω = 2/3).

lis_tpu applies P without forming it (``ImplicitP``: a broadcast, a DIA
product of A and a box sum, fused by XLA), which rides the TPU's streaming
DIA product.  On the H100 that reads A's 27 diagonals for every fine row,
about four times the bytes of P itself, while a gather from a coarse
vector that sits in L2 is cheap.  So the port assembles P on the host at
set-up (scipy already forms it for the Galerkin product) and keeps it on
the level's device as a ``LatticeTransfer``: P and Pᵀ as CSR arrays with
int32 columns.

- J ``lattice_prolong``: x + P·ec over P's rows;
- L ``lattice_restrict``: Pᵀ·r over Pᵀ's rows.

On a CPU tensor each takes its plain version below (a gather and a sum
over the same arrays, in the kernel's order), which is also the oracle on
the card; both kernels round every product and sum on its own, so on real
and complex data they equal it bit for bit.  lis_tpu's implicit form
stays here as the reference (``LatticeTent``, ``implicit_prolong``,
``implicit_restrict``): the tests and ``chip_smoke.py`` hold the
assembled P against it.  Nothing on the solve path calls it.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from lis_tpu_torch.matrix.base import TensorFields, static
from lis_tpu_torch.matrix.dia import _REAL_OF, _spmv_plain, _spmvh_plain
from lis_tpu_torch.ops import _cuda

OMEGA = 2.0 / 3.0             # the prolongator's Jacobi smoothing weight
MAX_ROW = 8                   # entries a row of P may hold: J stages that
                              # many a row (csrc/amg.cu kStage); a lattice
                              # row of P touches at most 2^3 boxes


# ---- the transfer operator, assembled at set-up -----------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class LatticeTransfer(TensorFields):
    """The smoothed prolongator P (n × nc) of one lattice level and its
    transpose, as CSR arrays on the level's device: int32 row pointers and
    columns, values of the level's real type.  Built from the scipy P of
    the hierarchy by ``from_scipy``, which holds P's rows to ``MAX_ROW``
    entries, as kernel J needs."""
    pptr: torch.Tensor        # (n + 1,) int32
    pcol: torch.Tensor        # (nnz,) int32, sorted within a row
    pval: torch.Tensor        # (nnz,)
    rptr: torch.Tensor        # (nc + 1,) int32: Pᵀ
    rcol: torch.Tensor        # (nnz,) int32
    rval: torch.Tensor        # (nnz,)

    @classmethod
    def from_scipy(cls, P, device=None):
        """Pack the scipy sparse P (n × nc) and its transpose; raises when
        n or P's entries reach 2^31 (the kernels index with int32) or a row
        of P holds more than ``MAX_ROW`` entries."""
        import scipy.sparse as sp
        if P.shape[0] >= 2 ** 31 or P.nnz >= 2 ** 31:
            raise ValueError(f"LatticeTransfer: {P.shape[0]} fine rows and "
                             f"{P.nnz} entries; the kernels take fewer than "
                             f"2^31")
        P = sp.csr_matrix(P)
        P.sort_indices()
        width = int(np.diff(P.indptr).max()) if P.shape[0] else 0
        if width > MAX_ROW:
            raise ValueError(f"LatticeTransfer: a row of P holds {width} "
                             f"entries; kernel J takes at most {MAX_ROW}")
        R = P.T.tocsr()
        R.sort_indices()

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
                device)
        return cls(pptr=put(P.indptr, np.int32),
                   pcol=put(P.indices, np.int32),
                   pval=put(P.data, np.float64),
                   rptr=put(R.indptr, np.int32),
                   rcol=put(R.indices, np.int32),
                   rval=put(R.data, np.float64))

    @property
    def n(self) -> int:
        return self.pptr.shape[0] - 1

    @property
    def nc(self) -> int:
        return self.rptr.shape[0] - 1

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (
            self.pptr, self.pcol, self.pval, self.rptr, self.rcol, self.rval))


def _products(val, v, col):
    """val[t] · v[col[t]] for every entry, each rounded on its own; a
    complex v is multiplied part by part, as the kernels do (no complex
    product of val + 0i)."""
    g = v.index_select(0, col)
    if v.is_complex():
        return val[:, None] * torch.view_as_real(g)
    return val * g


def _prolong_plain(T: LatticeTransfer, ec, x):
    """x + P·ec in kernel J's order: each row sums its products from 0 in
    column order, then x[i] + sum."""
    ec, x = ec.resolve_conj(), x.resolve_conj()
    prod = _products(T.pval, ec, T.pcol)
    last = max(prod.shape[0] - 1, 0)
    start, end = T.pptr[:-1].long(), T.pptr[1:].long()
    width = int((end - start).max()) if T.n else 0
    acc = torch.zeros((T.n,) + prod.shape[1:], dtype=prod.dtype,
                      device=prod.device)
    for k in range(width):
        ok = start + k < end
        term = prod[(start + k).clamp(max=last)]
        acc = torch.where(ok if prod.dim() == 1 else ok[:, None],
                          acc + term, acc)
    if x.is_complex():
        return torch.view_as_complex(torch.view_as_real(x) + acc)
    return x + acc


def _restrict_plain(T: LatticeTransfer, r):
    """Pᵀ·r in kernel L's order: lane l of a row's warp sums entries l,
    l + 32, ... from 0, then the 32 lane sums fold in halves (lane l + 16
    onto l, then 8, 4, 2, 1)."""
    r = r.resolve_conj()
    prod = _products(T.rval, r, T.rcol)
    last = max(prod.shape[0] - 1, 0)
    start = T.rptr[:-1].long()[:, None] + torch.arange(32, device=r.device)
    end = T.rptr[1:].long()[:, None]
    rounds = -(-int((end[:, 0] - start[:, 0]).max()) // 32) if T.nc else 0
    acc = torch.zeros((T.nc, 32) + prod.shape[1:], dtype=prod.dtype,
                      device=prod.device)
    for m in range(rounds):
        idx = start + 32 * m
        ok = idx < end
        acc = torch.where(ok if prod.dim() == 1 else ok[..., None],
                          acc + prod[idx.clamp(max=last)], acc)
    for half in (16, 8, 4, 2, 1):
        acc = acc[:, :half] + acc[:, half:2 * half]
    out = acc[:, 0]
    return torch.view_as_complex(out.contiguous()) if r.is_complex() \
        else out


def _check(name, T: LatticeTransfer, vecs):
    """Types the kernels take; returns the vectors' dtype and the real type
    of the transfer's values."""
    vt = T.pval.dtype
    if vt not in (torch.float32, torch.float64) or T.rval.dtype != vt:
        raise ValueError(f"{name}: P's and Pᵀ's values must share one real "
                         f"type, got {T.pval.dtype} and {T.rval.dtype}")
    if any(t.dtype != torch.int32 for t in (T.pptr, T.pcol, T.rptr,
                                            T.rcol)):
        raise ValueError(f"{name}: int32 row pointers and columns")
    dt = vecs[0].dtype
    if _REAL_OF.get(dt, dt) != vt or any(v.dtype != dt for v in vecs):
        raise ValueError(f"{name}: vectors of {dt} with a {vt} transfer")
    return dt, vt


def _ops(*ts):
    for t in ts:
        if t.is_conj():
            t = t.resolve_conj()
        yield t.contiguous()


def lattice_prolong(T: LatticeTransfer, ec, x):
    """``x + P·ec`` over the assembled prolongator of ``T``.

    Kernel J (``csrc/amg.cu``): one thread per fine row; a warp stages the
    products of its 32 rows' entries (coalesced, ec gathered from L1/L2)
    in shared memory, then each lane sums its row in column order.
    lis_tpu leaves this to XLA (precon/saamg.py:102, :341-343).  Bound on
    the H100: bytes, P's entries, its row pointers, ec, x and the result
    once each."""
    if ec.shape != (T.nc,) or x.shape != (T.n,):
        raise ValueError(f"lattice_prolong: ec {tuple(ec.shape)} and x "
                         f"{tuple(x.shape)} for {T.nc} coarse and {T.n} "
                         f"fine points")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"no kernel or plain path for {x.device}")
        _check("lattice_prolong", T, (ec, x))
        return _prolong_plain(T, ec, x)
    dt, vt = _check("lattice_prolong", T, (ec, x))
    ec, x = _ops(ec, x)
    for name, t in (("pptr", T.pptr), ("pcol", T.pcol), ("pval", T.pval),
                    ("ec", ec), ("x", x)):
        _cuda.check(t, name, aligned=False)
    out = torch.empty_like(x)
    _cuda.launch("lis_lattice_prolong", _cuda.DTYPE_CODE[vt],
                 _cuda.DTYPE_CODE[dt], T.pptr.data_ptr(), T.pcol.data_ptr(),
                 T.pval.data_ptr(), ec.data_ptr(), x.data_ptr(),
                 out.data_ptr(), T.n, T.nc, T.pcol.shape[0], _cuda.stream())
    lattice_prolong.launches += 1
    return out


lattice_prolong.launches = 0


def lattice_restrict(T: LatticeTransfer, r):
    """``Pᵀ·r`` over the assembled transpose of ``T``.

    Kernel L (``csrc/amg.cu``): a warp per coarse row, in lexicographic
    order, so the blocks in flight share a few fine planes of r in L2;
    lane l sums entries l, l + 32, ... (coalesced, r gathered), then the
    lanes fold in halves.  No atomics: the result is the same every run.
    lis_tpu leaves this to XLA (saamg.py:312-323, :345-347).  Bound on the
    H100: bytes, Pᵀ's entries and row pointers, r and the result once
    each."""
    if r.shape != (T.n,):
        raise ValueError(f"lattice_restrict: r {tuple(r.shape)} for "
                         f"{T.n} fine points")
    if not r.is_cuda:
        if r.device.type != "cpu":
            raise ValueError(f"no kernel or plain path for {r.device}")
        _check("lattice_restrict", T, (r,))
        return _restrict_plain(T, r)
    dt, vt = _check("lattice_restrict", T, (r,))
    (r,) = _ops(r)
    for name, t in (("rptr", T.rptr), ("rcol", T.rcol), ("rval", T.rval),
                    ("r", r)):
        _cuda.check(t, name, aligned=False)
    out = torch.empty(T.nc, dtype=dt, device=r.device)
    _cuda.launch("lis_lattice_restrict", _cuda.DTYPE_CODE[vt],
                 _cuda.DTYPE_CODE[dt], T.rptr.data_ptr(), T.rcol.data_ptr(),
                 T.rval.data_ptr(), r.data_ptr(), out.data_ptr(), T.nc, T.n,
                 T.rcol.shape[0], _cuda.stream())
    lattice_restrict.launches += 1
    return out


lattice_restrict.launches = 0


# ---- lis_tpu's implicit form: the reference ---------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class LatticeTent(TensorFields):
    """The tentative prolongator of a 3x-per-dimension box decimation:
    Pt[i, c] = wc[c] when box(i) == c (lis_tpu ``LatticeTent``)."""
    wc: torch.Tensor          # (nc,) 1/sqrt(|box|)
    fdims: tuple = static()   # fine dims, slowest..fastest
    cdims: tuple = static()   # coarse dims

    @property
    def n(self) -> int:
        return int(np.prod(self.fdims))

    def matvec(self, ec):
        """Pt·ec: the broadcast, in lis_tpu's order (ec·wc, then repeat and
        crop)."""
        z = (ec * self.wc.to(ec.dtype)).reshape(self.cdims)
        for ax in range(len(self.cdims)):
            z = torch.repeat_interleave(z, 3, dim=ax)
        return z[tuple(slice(0, f) for f in self.fdims)].reshape(-1)

    def matvech(self, r):
        """Ptᵀ·r: each box's sum in lexicographic order within the box,
        times wc."""
        pad = []
        for f, c in reversed(list(zip(self.fdims, self.cdims))):
            pad += [0, 3 * c - f]
        rp = torch.nn.functional.pad(r.reshape(self.fdims), pad)
        shape = []
        for c in self.cdims:
            shape += [c, 3]
        rp = rp.reshape(shape)
        acc = None
        for digits in itertools.product(range(3), repeat=len(self.cdims)):
            term = rp[tuple(x for d in digits for x in (slice(None), d))]
            acc = term if acc is None else acc + term
        return acc.reshape(-1) * self.wc.to(r.dtype)


def implicit_prolong(A, dinv, tent: LatticeTent, ec, x):
    """x + P·ec without forming P, lis_tpu's order of operations
    (``x + ImplicitP.matvec(ec)``, saamg.py:102, :341-343): z = Pt·ec,
    then z − (ω·dinv)·(A·z) on the level's DIA ``A``."""
    z = tent.matvec(ec)
    Az = _spmv_plain(A.value, A.offsets, z, A.ncols)
    return x + (z - (OMEGA * dinv.to(z.dtype)) * Az)


def implicit_restrict(A, dinv, tent: LatticeTent, r):
    """Pᵀ·r without forming P, lis_tpu's ``ImplicitP.matvech`` (:345-347):
    z = r − ω·Aᵀ(dinv ⊙ r), then the tent's box sums times wc."""
    z = r - OMEGA * _spmvh_plain(A.value, A.offsets, dinv.to(r.dtype) * r,
                                 A.ncols)
    return tent.matvech(z)
