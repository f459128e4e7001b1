"""MSR — modified CSR with the diagonal split off.

Port of ``lis_tpu/matrix/msr.py`` (reference: src/matrix/lis_matrix_msr.c).
The diagonal lives in its own length-n vector (duplicates on it summed, as
``np.add.at`` sums them), the strictly off-diagonal part in CSR arrays;
the matvec is diag·x plus the off-diagonal gather and row sum
(``index_add_``, with atomics on a GPU).  The split diagonal is also the
matrix's ``get_diagonal``.
"""

from __future__ import annotations

import numpy as np
import torch

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import (SparseMatrix, as_tensor, conj, host,
                                       matrix_format, scatter_add, static)


@matrix_format("msr")
class MSRMatrix(SparseMatrix):
    diag: torch.Tensor        # (n,)
    ptr: torch.Tensor         # (n+1,) int32 over off-diagonal entries
    index: torch.Tensor       # (ndz,) int32
    value: torch.Tensor       # (ndz,)
    row_ids: torch.Tensor     # (ndz,) int32
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape,
                        device=None) -> "MSRMatrix":
        ptr, index, value = host(ptr), host(index), host(value)
        n = shape[0]
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
        isdiag = index == rows
        diag = np.zeros(n, dtype=value.dtype)
        np.add.at(diag, rows[isdiag], value[isdiag])
        off = ~isdiag
        orow, oidx, oval = rows[off], index[off], value[off]
        optr = np.zeros(n + 1, dtype=np.int32)
        np.add.at(optr, orow + 1, 1)
        return cls(diag=as_tensor(diag),
                   ptr=as_tensor(np.cumsum(optr), np.int32),
                   index=as_tensor(oidx, np.int32), value=as_tensor(oval),
                   row_ids=as_tensor(orow, np.int32), nrows=int(n),
                   ncols=int(shape[1]), nnz=len(value)
                   ).to(resolve_device(device))

    def to_csr_arrays(self):
        def build():
            import scipy.sparse as sp
            off = sp.csr_matrix((host(self.value), host(self.index),
                                 host(self.ptr)), shape=self.shape)
            d = sp.diags(host(self.diag), shape=self.shape, format="csr")
            a = (off + d).tocsr()
            a.sort_indices()
            return (a.indptr.astype(np.int32), a.indices.astype(np.int32),
                    a.data)
        return self._cached_csr(build)

    def matvec(self, x):
        yoff = scatter_add(self.nrows, self.row_ids,
                           self.value * x.index_select(0, self.index))
        return self.diag * x[:self.nrows] + yoff

    def matvech(self, x):
        y = scatter_add(self.ncols, self.index,
                        conj(self.value) * x.index_select(0, self.row_ids))
        y[:self.nrows] += conj(self.diag) * x
        return y

    def get_diagonal(self):
        return self.diag
