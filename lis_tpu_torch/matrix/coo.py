"""COO triplet format.

Port of ``lis_tpu/matrix/coo.py`` (reference: src/matrix/lis_matrix_coo.c).
The natural assembly format: the matvec is a gather of x at the columns
times the values, summed into the rows with ``index_add_`` (on a GPU with
atomics, so the order of a row's terms may vary from run to run).  lis_tpu
leaves it to XLA, so it stays torch operations here.
"""

from __future__ import annotations

import numpy as np
import torch

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import (SparseMatrix, as_tensor, conj, host,
                                       matrix_format, scatter_add, static)


@matrix_format("coo")
class COOMatrix(SparseMatrix):
    row: torch.Tensor         # (nnz,) int32
    col: torch.Tensor         # (nnz,) int32
    value: torch.Tensor       # (nnz,)
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()

    @classmethod
    def from_arrays(cls, row, col, value, shape, device=None) -> "COOMatrix":
        """Build from host triplets (duplicates kept) on ``device``."""
        value = host(value)
        return cls(row=as_tensor(row, np.int32), col=as_tensor(col, np.int32),
                   value=as_tensor(value), nrows=int(shape[0]),
                   ncols=int(shape[1]), nnz=len(value)
                   ).to(resolve_device(device))

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape,
                        device=None) -> "COOMatrix":
        row = np.repeat(np.arange(shape[0], dtype=np.int32),
                        np.diff(host(ptr)))
        return cls.from_arrays(row, index, value, shape, device=device)

    def to_csr_arrays(self):
        def build():
            import scipy.sparse as sp
            a = sp.coo_matrix((host(self.value),
                               (host(self.row), host(self.col))),
                              shape=self.shape).tocsr()
            a.sum_duplicates()
            a.sort_indices()
            return (a.indptr.astype(np.int32), a.indices.astype(np.int32),
                    a.data)
        return self._cached_csr(build)

    def matvec(self, x):
        return scatter_add(self.nrows, self.row,
                           self.value * x.index_select(0, self.col))

    def matvech(self, x):
        return scatter_add(self.ncols, self.col,
                           conj(self.value) * x.index_select(0, self.row))
