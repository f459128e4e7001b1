"""CSC — compressed sparse column.

Port of ``lis_tpu/matrix/csc.py`` (reference: src/matrix/lis_matrix_csc.c).
The CSC arrays of A are the CSR arrays of Aᵀ: the matvec scatters into the
rows (``index_add_`` over the row indices, with atomics on a GPU), and
the matvech is the sorted segment-sum over the precomputed column ids,
the mirror of the CSR matvec.  Torch operations, as lis_tpu leaves them to
XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import (SparseMatrix, as_tensor, conj, host,
                                       matrix_format, scatter_add, static)


@matrix_format("csc")
class CSCMatrix(SparseMatrix):
    ptr: torch.Tensor         # (ncols+1,) int32
    index: torch.Tensor       # (nnz,) int32 row indices
    value: torch.Tensor       # (nnz,)
    col_ids: torch.Tensor     # (nnz,) int32, column of each entry (sorted)
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()

    @classmethod
    def from_csc_arrays(cls, ptr, index, value, shape,
                        device=None) -> "CSCMatrix":
        """Build from host CSC arrays on ``device``."""
        ptr, value = host(ptr), host(value)
        col_ids = np.repeat(np.arange(shape[1], dtype=np.int32), np.diff(ptr))
        return cls(ptr=as_tensor(ptr, np.int32),
                   index=as_tensor(index, np.int32), value=as_tensor(value),
                   col_ids=as_tensor(col_ids), nrows=int(shape[0]),
                   ncols=int(shape[1]), nnz=len(value)
                   ).to(resolve_device(device))

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape,
                        device=None) -> "CSCMatrix":
        import scipy.sparse as sp
        a = sp.csr_matrix((host(value), host(index), host(ptr)),
                          shape=shape).tocsc()
        a.sort_indices()
        return cls.from_csc_arrays(a.indptr, a.indices, a.data, shape,
                                   device=device)

    def to_csr_arrays(self):
        def build():
            import scipy.sparse as sp
            a = sp.csc_matrix((host(self.value), host(self.index),
                               host(self.ptr)), shape=self.shape).tocsr()
            a.sort_indices()
            return (a.indptr.astype(np.int32), a.indices.astype(np.int32),
                    a.data)
        return self._cached_csr(build)

    def matvec(self, x):
        return scatter_add(self.nrows, self.index,
                           self.value * x.index_select(0, self.col_ids))

    def matvech(self, x):
        return scatter_add(self.ncols, self.col_ids,
                           conj(self.value) * x.index_select(0, self.index))
