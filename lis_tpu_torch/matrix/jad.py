"""JAD — jagged diagonal format.

Port of ``lis_tpu/matrix/jad.py`` (reference: src/matrix/lis_matrix_jad.c,
kernel src/matvec/lis_matvec_jad.c:50).  Rows are permuted by descending
nonzero count, then stored as ``maxnzr`` jagged columns of length n,
padded with column 0 and value 0 (ELL over the permuted rows, column
major).  The matvec is one gather of x times the values, a sum over the
jagged columns in a fixed order, and the inverse row permutation; the
matvech scatters (``index_add_``, with atomics on a GPU).  The padding is
not masked, as in lis_tpu.

``to_csr_arrays`` drops entries by the value mask, as lis_tpu's does, and
is vectorised: lis_tpu walks the n rows in a Python loop (884,736 at
96³), and the diagonal, scaling and every CSR-based preconditioner read
it.  The result is cached on the matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import (SparseMatrix, as_tensor, conj, host,
                                       matrix_format, scatter_add, static)
from lis_tpu_torch.matrix.ell import _sort_rows


@matrix_format("jad")
class JADMatrix(SparseMatrix):
    perm: torch.Tensor        # (n,) int32: sorted position -> original row
    inv_perm: torch.Tensor    # (n,) int32: original row -> sorted position
    index: torch.Tensor       # (maxnzr, n) int32, padded with 0
    value: torch.Tensor       # (maxnzr, n), padded with 0
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()
    maxnzr: int = static()

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape,
                        device=None) -> "JADMatrix":
        ptr, index, value = host(ptr), host(index), host(value)
        n = shape[0]
        lens = np.diff(ptr)
        perm = np.argsort(-lens, kind="stable").astype(np.int32)
        inv_perm = np.empty(n, dtype=np.int32)
        inv_perm[perm] = np.arange(n, dtype=np.int32)
        maxnzr = int(lens.max()) if n else 0
        jidx = np.zeros((maxnzr, n), dtype=np.int32)
        jval = np.zeros((maxnzr, n), dtype=value.dtype)
        rows = np.repeat(np.arange(n), lens)
        pos = np.arange(len(index)) - np.repeat(ptr[:-1], lens)
        jidx[pos, inv_perm[rows]] = index
        jval[pos, inv_perm[rows]] = value
        return cls(perm=as_tensor(perm), inv_perm=as_tensor(inv_perm),
                   index=as_tensor(jidx), value=as_tensor(jval),
                   nrows=int(n), ncols=int(shape[1]), nnz=len(value),
                   maxnzr=maxnzr).to(resolve_device(device))

    def to_csr_arrays(self):
        def build():
            idx, val = host(self.index), host(self.value)
            perm = host(self.perm)
            mask = val != 0
            lens = np.zeros(self.nrows, dtype=np.int64)
            lens[perm] = mask.sum(axis=0)
            ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
            # the kept entries by sorted position, then jagged column: the
            # stable sort by (row, column) puts them where lis_tpu's row
            # loop and its own sort do
            k, j = np.nonzero(mask.T)
            rows = perm[k].astype(np.int64)
            cols = idx[j, k].astype(np.int32)
            o = np.lexsort((cols, rows))
            return ptr, cols[o], val[j, k][o]
        return self._cached_csr(build)

    def matvec(self, x):
        g = x.index_select(0, self.index.reshape(-1)).view(self.index.shape)
        return (self.value * g).sum(dim=0).index_select(0, self.inv_perm)

    def matvech(self, x):
        prod = conj(self.value) * x.index_select(0, self.perm)[None, :]
        return scatter_add(self.ncols, self.index.reshape(-1),
                           prod.reshape(-1))
