"""ELL (ELLPACK) format.

Port of ``lis_tpu/matrix/ell.py`` (reference: src/matrix/lis_matrix_ell.c,
kernel src/matvec/lis_matvec_ell.c:50).  Rows padded to ``maxnzr`` entries
give an (n, maxnzr) index/value pair, padded with column 0 and value 0,
so the matvec is one gather of x times the values and a row sum, in a
fixed order.  The padding is not masked: 0·x[0] is NaN where x[0] is, as
in lis_tpu.  The matvech scatters (``index_add_``, with atomics on a
GPU).  ``to_csr_arrays`` drops entries by the value mask, explicit zeros
with the padding, as lis_tpu's does.
"""

from __future__ import annotations

import numpy as np
import torch

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import (SparseMatrix, as_tensor, conj, host,
                                       matrix_format, scatter_add, static)


@matrix_format("ell")
class ELLMatrix(SparseMatrix):
    index: torch.Tensor       # (n, maxnzr) int32, padded with 0
    value: torch.Tensor       # (n, maxnzr), padded with 0
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()
    maxnzr: int = static()

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape,
                        device=None) -> "ELLMatrix":
        ptr, index, value = host(ptr), host(index), host(value)
        n = shape[0]
        lens = np.diff(ptr)
        maxnzr = int(lens.max()) if n else 0
        eidx = np.zeros((n, maxnzr), dtype=np.int32)
        eval_ = np.zeros((n, maxnzr), dtype=value.dtype)
        rows = np.repeat(np.arange(n), lens)
        pos = np.arange(len(index)) - np.repeat(ptr[:-1], lens)
        eidx[rows, pos] = index
        eval_[rows, pos] = value
        return cls(index=as_tensor(eidx), value=as_tensor(eval_),
                   nrows=int(n), ncols=int(shape[1]), nnz=len(value),
                   maxnzr=maxnzr).to(resolve_device(device))

    def to_csr_arrays(self):
        def build():
            idx, val = host(self.index), host(self.value)
            mask = val != 0
            ptr = np.concatenate([[0], np.cumsum(mask.sum(axis=1))])
            return _sort_rows(ptr.astype(np.int32),
                              idx[mask].astype(np.int32), val[mask])
        return self._cached_csr(build)

    def matvec(self, x):
        g = x.index_select(0, self.index.reshape(-1)).view(self.index.shape)
        return (self.value * g).sum(dim=1)

    def matvech(self, x):
        prod = conj(self.value) * x[:, None]
        return scatter_add(self.ncols, self.index.reshape(-1),
                           prod.reshape(-1))


def _sort_rows(ptr, index, value):
    """Sort column indices within each CSR row (host: one stable lexsort
    by (row, column))."""
    rows = np.repeat(np.arange(len(ptr) - 1, dtype=np.int64), np.diff(ptr))
    o = np.lexsort((index, rows))
    return ptr, index[o], value[o]
