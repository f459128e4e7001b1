"""SAINV — stabilized approximate-inverse preconditioner.

Port of ``lis_tpu/precon/sainv.py`` (reference lis_precon_create_sainv,
src/precon/lis_precon_sainv.c:59, and lis_psolve_sainv :735):
M⁻¹ = Z D⁻¹ Wᴴ from A-biconjugation with post-dropping (-sainv_drop,
0.05).  The factorisation runs on the host at creation: sparse and
right-looking, in the native ``sainv_factor`` for real data and in the
Python loop below for complex data.  The apply is two CSR products of
torch operations and a diagonal scale on the device (Wᴴr, D⁻¹, Z·t); an
approximate inverse needs no triangular solve.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lis_tpu_torch.matrix.base import TensorFields
from lis_tpu_torch.matrix.csr import CSRMatrix
from lis_tpu_torch.precon.base import register_precon
from lis_tpu_torch.utils.trace import psolve_span


@dataclasses.dataclass(frozen=True, eq=False)
class SAINVPrecon(TensorFields):
    W: CSRMatrix              # biconjugation left factor (unit diagonal)
    Z: CSRMatrix              # right factor (unit diagonal)
    dinv: torch.Tensor

    @psolve_span
    def psolve(self, r):
        return self.Z.matvec(self.dinv * self.W.matvech(r))

    @psolve_span
    def psolveh(self, r):
        d = self.dinv.conj() if self.dinv.is_complex() else self.dinv
        return self.W.matvec(d * self.Z.matvech(r))


def _factor_sainv_py(ptr, index, value, n, tol):
    """Sparse right-looking biconjugation, the Python fallback of the
    native ``sainv_factor`` (lis_tpu ``_factor_sainv_py``): l = A·Z_i,
    u = W_iᵀ·A, only the columns j > i where l_j or u_j is nonzero are
    updated, and update terms below ``tol`` are dropped.  Output as the
    native one's: Z and W as row-wise CSR, and dinv."""
    import scipy.sparse as sp
    Acsr = sp.csr_matrix((value, index, ptr), shape=(n, n))
    Acsc = Acsr.tocsc()

    Zc = [{i: 1.0} for i in range(n)]
    Wc = [{i: 1.0} for i in range(n)]
    dinv = np.ones(n, dtype=value.dtype)

    def update_col(C, j, i, coef):
        cj = C[j]
        for r, v in C[i].items():
            t = coef * v
            if abs(t) < tol:
                continue
            nv = cj.get(r, 0.0) - t
            if nv == 0.0 and r != j:
                cj.pop(r, None)
            else:
                cj[r] = nv

    for i in range(n):
        l = {}
        for r, zv in Zc[i].items():
            for p in range(Acsc.indptr[r], Acsc.indptr[r + 1]):
                l[Acsc.indices[p]] = l.get(Acsc.indices[p], 0.0) \
                    + Acsc.data[p] * zv
        u = {}
        for r, wv in Wc[i].items():
            for p in range(Acsr.indptr[r], Acsr.indptr[r + 1]):
                u[Acsr.indices[p]] = u.get(Acsr.indices[p], 0.0) \
                    + wv * Acsr.data[p]
        dd = sum(u.get(r, 0.0) * zv for r, zv in Zc[i].items())
        if dd == 0.0:
            dinv[i] = 1.0
            continue
        dinv[i] = 1.0 / dd
        for j, lj in l.items():
            if j > i and lj != 0.0:
                update_col(Wc, j, i, lj / dd)
        for j, uj in u.items():
            if j > i and uj != 0.0:
                update_col(Zc, j, i, uj / dd)

    def emit(C):
        r_, c_, v_ = [], [], []
        for j in range(n):
            for r, v in C[j].items():
                r_.append(r)
                c_.append(j)
                v_.append(v)
        m = sp.coo_matrix((v_, (r_, c_)), shape=(n, n)).tocsr()
        m.sort_indices()
        return m.indptr.astype(np.int32), m.indices.astype(np.int32), m.data

    return emit(Zc), emit(Wc), dinv


@register_precon("sainv")
def create_sainv(A, opts):
    drop = getattr(opts, "sainv_drop", 0.05)
    n = A.nrows
    ptr, index, value = A.to_csr_arrays()
    out = None
    if not np.iscomplexobj(value):
        from lis_tpu_torch import _native
        out = _native.sainv_factor(ptr, index, value, drop)
    if out is None:
        out = _factor_sainv_py(np.asarray(ptr), np.asarray(index),
                               np.asarray(value), n, drop)
    (zp, zi, zv), (wp, wi, wv), dinv = out
    dev = A.device
    return SAINVPrecon(
        W=CSRMatrix.from_csr_arrays(wp, wi, wv, (n, n), device=dev),
        Z=CSRMatrix.from_csr_arrays(zp, zi, zv, (n, n), device=dev),
        dinv=torch.from_numpy(np.asarray(dinv)).to(dev))
