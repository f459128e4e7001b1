"""VBR — variable block row.

Port of ``lis_tpu/matrix/vbr.py`` (reference src/matrix/lis_matrix_vbr.c):
the row and column partitions and the block pointers of the reference's
struct (lis.h:641-657) for the block ILU and the conversions, while the
products run on a CSR view of the same arrays.  Where the partition is
uniform (every block k×k, k > 1, rows and columns alike) the matrix is
exactly a BSR, and ``fast`` holds that BSR, whose windowed slabs serve the
products.  The default partition is the reference's automatic one
(``auto_rowcol``, lis_matrix_get_vbr_rowcol, lis_matrix_vbr.c:262).
"""

from __future__ import annotations

import numpy as np
import torch

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import (SparseMatrix, as_tensor, conj, host,
                                       matrix_format, scatter_add, static)


def auto_rowcol(ptr, index, n) -> tuple:
    """The reference's automatic VBR partition: a boundary wherever any
    row's contiguous column run starts or ends, so that blocks are the
    maximal column intervals no row's run crosses (one partition for rows
    and columns)."""
    ptr = np.asarray(ptr)
    index = np.asarray(index, dtype=np.int64)
    if len(index):  # run detection needs sorted columns per row
        rows = np.repeat(np.arange(len(ptr) - 1, dtype=np.int64),
                         np.diff(ptr))
        index = index[np.lexsort((index, rows))]
    iw = np.zeros(n + 2, dtype=bool)
    if len(index):
        nz_rows = np.diff(ptr) > 0
        first = ptr[:-1][nz_rows]
        last = ptr[1:][nz_rows] - 1
        starts = np.ones(len(index), dtype=bool)
        starts[1:] = index[1:] != index[:-1] + 1
        starts[first] = True
        ends = np.ones(len(index), dtype=bool)
        ends[:-1] = index[:-1] != index[1:] - 1
        ends[last] = True
        iw[index[starts]] = True
        iw[index[ends] + 1] = True
    iw[0] = False
    bounds = np.flatnonzero(iw)
    return (0,) + tuple(int(b) for b in bounds) + \
        ((n,) if (len(bounds) == 0 or bounds[-1] != n) else ())


@matrix_format("vbr")
class VBRMatrix(SparseMatrix):
    ptr: torch.Tensor         # the CSR view
    index: torch.Tensor
    value: torch.Tensor
    row_ids: torch.Tensor
    fast: object              # BSRMatrix of the same matrix, or None
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()
    row_part: tuple = static()    # row partition boundaries, nr + 1
    col_part: tuple = static()    # column partition boundaries, nc + 1
    bptr: np.ndarray = static()   # block-row pointers into bindex (host)
    bindex: np.ndarray = static()  # block column of each stored block

    def _rebuild_kwargs(self):
        return {"row_part": tuple(self.row_part),
                "col_part": tuple(self.col_part)}

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape, row_part=None,
                        col_part=None, block: int | None = None,
                        device=None) -> "VBRMatrix":
        """With no partition and no ``block`` (a square matrix), the
        reference's automatic partition; ``block`` gives a uniform one."""
        ptr, index, value = host(ptr), host(index), host(value)
        n, m = shape
        if row_part is None and col_part is None and block is None and n == m:
            row_part = col_part = auto_rowcol(ptr, index, n)
        if block is None:
            block = 2
        if row_part is None:
            row_part = tuple(range(0, n, block)) + (n,)
        if col_part is None:
            col_part = tuple(range(0, m, block)) + (m,)
        row_part = tuple(int(v) for v in dict.fromkeys(row_part))
        col_part = tuple(int(v) for v in dict.fromkeys(col_part))
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
        brow = np.searchsorted(np.asarray(row_part), rows, side="right") - 1
        bcol = np.searchsorted(np.asarray(col_part), index, side="right") - 1
        nr, ncb = len(row_part) - 1, len(col_part) - 1
        pairs = np.unique(brow * ncb + bcol)
        bindex = (pairs % ncb).astype(np.int64)
        bptr = np.zeros(nr + 1, dtype=np.int64)
        np.add.at(bptr, pairs // ncb + 1, 1)
        bptr = np.cumsum(bptr)
        # a uniform partition makes the matrix exactly a BSR, whose slabs
        # serve the products; the CSR view stays beside it, since it alone
        # holds the exact pattern (the BSR adds in-block zeros, which would
        # change the fill of an ILU)
        fast = None
        rs, cs = np.diff(np.asarray(row_part)), np.diff(np.asarray(col_part))
        if (len(rs) > 1 and rs.max() == rs.min()
                and np.array_equal(rs, cs) and rs[0] > 1):
            from lis_tpu_torch.matrix.bsr import BSRMatrix
            fast = BSRMatrix.from_csr_arrays(ptr, index, value, shape,
                                             bnr=int(rs[0]), device="cpu")
        out = cls(ptr=as_tensor(ptr, np.int32), index=as_tensor(index, np.int32),
                  value=as_tensor(value), row_ids=as_tensor(rows, np.int32),
                  fast=fast, nrows=int(n), ncols=int(m),
                  nnz=int(len(value)), row_part=row_part, col_part=col_part,
                  bptr=bptr, bindex=bindex)
        object.__setattr__(out, "_host_csr", (np.asarray(ptr, np.int32),
                                              np.asarray(index, np.int32),
                                              value))
        return out.to(resolve_device(device))

    def to_csr_arrays(self):
        return self._cached_csr(lambda: (host(self.ptr), host(self.index),
                                         host(self.value)))

    def matvec(self, x):
        if self.fast is not None:
            return self.fast.matvec(x)
        return scatter_add(self.nrows, self.row_ids,
                           self.value * x.index_select(0, self.index))

    def matvech(self, x):
        if self.fast is not None:
            return self.fast.matvech(x)
        return scatter_add(self.ncols, self.index,
                           conj(self.value) * x.index_select(0, self.row_ids))
