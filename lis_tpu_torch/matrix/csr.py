"""CSR — the hub storage format.

Port of ``lis_tpu/matrix/csr.py`` (reference: src/matrix/lis_matrix_csr.c,
SpMV src/matvec/lis_matvec_csr.c:53).  The row loop is a gather of ``x``
at the column indices times the values, then a row segment-sum
(``index_add_`` over the precomputed row ids).  Plain torch on every
device: lis_tpu has no Pallas kernel here either.  On a GPU ``index_add_``
sums with atomics, so the order of a row's terms may change from run to
run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import (SparseMatrix, conj, host,
                                       matrix_format, scatter_add, static)


@matrix_format("csr")
class CSRMatrix(SparseMatrix):
    ptr: torch.Tensor         # (n+1,) int32
    index: torch.Tensor       # (nnz,) int32 column indices
    value: torch.Tensor       # (nnz,)
    row_ids: torch.Tensor     # (nnz,) int32, row of each entry (sorted)
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape,
                        device=None) -> "CSRMatrix":
        """Build from host arrays on ``device`` (None: the default device,
        the card; ``"cpu"`` keeps it on the host)."""
        ptr = np.asarray(host(ptr), dtype=np.int32)
        index = np.asarray(host(index), dtype=np.int32)
        value = np.ascontiguousarray(host(value))
        row_ids = np.repeat(np.arange(shape[0], dtype=np.int32),
                            np.diff(ptr))
        out = cls(ptr=torch.from_numpy(ptr), index=torch.from_numpy(index),
                  value=torch.from_numpy(value),
                  row_ids=torch.from_numpy(row_ids),
                  nrows=int(shape[0]), ncols=int(shape[1]),
                  nnz=int(len(value)))
        object.__setattr__(out, "_host_csr", (ptr, index, value))
        return out.to(resolve_device(device))

    def to_csr_arrays(self):
        cached = getattr(self, "_host_csr", None)
        if cached is not None:
            return cached
        out = (host(self.ptr), host(self.index), host(self.value))
        object.__setattr__(self, "_host_csr", out)
        return out

    def matvec(self, x):
        return scatter_add(self.nrows, self.row_ids,
                           self.value * x.index_select(0, self.index))

    def matvech(self, x):
        return scatter_add(self.ncols, self.index,
                           conj(self.value) * x.index_select(0, self.row_ids))

    def transpose(self) -> "CSRMatrix":
        """Aᴴ as a CSR on the same device (lis_tpu ``transpose``,
        matrix/csr.py:79-86: conjugated on complex data), built on the
        host."""
        import scipy.sparse as sp
        ptr, index, value = self.to_csr_arrays()
        at = sp.csr_matrix((value, index, ptr), shape=self.shape).T.tocsr()
        at.sort_indices()
        return CSRMatrix.from_csr_arrays(at.indptr, at.indices,
                                         np.conj(at.data),
                                         (self.ncols, self.nrows),
                                         device=self.device)

    def get_diagonal(self):
        contrib = torch.where(self.index == self.row_ids, self.value,
                              torch.zeros((), dtype=self.value.dtype,
                                          device=self.value.device))
        y = torch.zeros(self.nrows, dtype=self.value.dtype,
                        device=self.value.device)
        return y.index_add_(0, self.row_ids, contrib)


def csr_scaled(m: CSRMatrix, row_d=None, col_d=None) -> CSRMatrix:
    """Row and column scaling of a CSRMatrix on its device (lis_tpu
    ``matrix/css.py::_csr_scaled``): value times row_d at each entry's row
    and col_d at its column.  The CST and CSS grids scale their remainder
    with it."""
    v = m.value
    if row_d is not None:
        v = v * row_d.index_select(0, m.row_ids).to(v.dtype)
    if col_d is not None:
        v = v * col_d.index_select(0, m.index).to(v.dtype)
    return dataclasses.replace(m, value=v)
