"""Hybrid DIA + remainder storage ("HDI").

Port of ``lis_tpu/matrix/hybrid.py``.  Not a reference format: its
closest precedents are MSR (diagonal split off,
src/matrix/lis_matrix_msr.c) and the GPU "HYB" (ELL+COO) layout.  A matrix
that is mostly banded with a few stragglers streams its dominant
diagonals (DIA, kernels E and F on the card) and pays the gather only for
the stragglers (a CSR remainder).  ``auto_storage`` routes here when the
strict DIA fill guard fails but the dominant diagonals cover most of the
nonzeros.
"""

from __future__ import annotations

import numpy as np

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import SparseMatrix, matrix_format, static, host
from lis_tpu_torch.matrix.csr import CSRMatrix
from lis_tpu_torch.matrix.dia import DIAMatrix, MAX_NND


@matrix_format("hdi")
class HybridMatrix(SparseMatrix):
    dia: object                    # DIAMatrix: the dominant diagonals
    rem: object                    # CSRMatrix: remainder entries
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()

    def matvec(self, x):
        return self.dia.matvec(x) + self.rem.matvec(x)

    def matvech(self, x):
        return self.dia.matvech(x) + self.rem.matvech(x)

    def get_diagonal(self):
        return self.dia.get_diagonal() + self.rem.get_diagonal()

    def to_csr_arrays(self):
        import scipy.sparse as sp
        dp, di, dv = self.dia.to_csr_arrays()
        rp, ri, rv = self.rem.to_csr_arrays()
        a = (sp.csr_matrix((dv, di, dp), shape=self.shape)
             + sp.csr_matrix((rv, ri, rp), shape=self.shape)).tocsr()
        a.sort_indices()
        return a.indptr, a.indices, a.data

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape, device=None, **kw):
        """convert_matrix hook: always succeeds — when no worthwhile
        diagonal split exists, everything lands in the CSR remainder."""
        h = cls.try_split(ptr, index, value, shape, device=device, **kw)
        if h is not None:
            return h
        n, m = shape
        device = resolve_device(device)
        value = host(value)
        rem = CSRMatrix.from_csr_arrays(ptr, index, value, shape,
                                        device=device)
        dia = DIAMatrix.from_diagonals(np.zeros((1, n), dtype=value.dtype),
                                       (0,), shape, nnz=0, device=device)
        return cls(dia=dia, rem=rem, nrows=n, ncols=m, nnz=len(value))

    @classmethod
    def try_split(cls, ptr, index, value, shape, min_density: float = 0.5,
                  max_remainder: float = 0.25, device=None):
        """Split into dominant diagonals (per-offset density >=
        min_density) + CSR remainder; returns None if the remainder would
        exceed max_remainder of the nnz (not worth it)."""
        import scipy.sparse as sp
        ptr, index, value = host(ptr), host(index), host(value)
        n, m = shape
        nnz = len(value)
        if nnz == 0 or n != m:
            return None
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
        offs_all = index.astype(np.int64) - rows
        uoffs, counts = np.unique(offs_all, return_counts=True)
        dense = uoffs[counts >= min_density * n]
        if len(dense) == 0 or len(dense) > MAX_NND:
            return None
        on_dia = np.isin(offs_all, dense)
        n_rem = nnz - int(on_dia.sum())
        if n_rem > max_remainder * nnz:
            return None

        device = resolve_device(device)
        dval = np.zeros((len(dense), n), dtype=value.dtype)
        pos = np.searchsorted(dense, offs_all[on_dia])
        np.add.at(dval, (pos, rows[on_dia]), value[on_dia])
        dia = DIAMatrix.from_diagonals(dval, dense, shape,
                                       nnz=int(np.count_nonzero(dval)),
                                       device=device)
        remmask = ~on_dia
        remc = sp.coo_matrix(
            (value[remmask], (rows[remmask], index[remmask])),
            shape=shape).tocsr()
        remc.sort_indices()
        rem = CSRMatrix.from_csr_arrays(remc.indptr, remc.indices, remc.data,
                                        shape, device=device)
        return cls(dia=dia, rem=rem, nrows=n, ncols=m, nnz=nnz)
