"""BSC — block sparse column.

Port of ``lis_tpu/matrix/bsc.py`` (reference src/matrix/lis_matrix_bsc.c):
the mirror of BSR.  The blocks are those of BSR(Aᵀ), transposed back;
``matvec`` gathers x blocks by block column and scatters the block
products into their block rows (``index_add_``), and ``matvech`` is the
sorted segment sum over the block columns.  Torch operations, as in
lis_tpu (no Pallas kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import (SparseMatrix, as_tensor, conj, host,
                                       matrix_format, static)
from lis_tpu_torch.matrix.bsr import _padded


@matrix_format("bsc")
class BSCMatrix(SparseMatrix):
    bptr: torch.Tensor        # (nc+1,) int32 over block columns
    bindex: torch.Tensor      # (bnnz,) int32 block rows
    value: torch.Tensor       # (bnnz, bnr, bnc)
    bcol_ids: torch.Tensor    # (bnnz,) int32
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()
    bnr: int = static()
    bnc: int = static()
    nr: int = static()
    nc: int = static()

    def _rebuild_kwargs(self):
        return {"bnr": self.bnr, "bnc": self.bnc}

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape, bnr: int = 2,
                        bnc: int | None = None, device=None) -> "BSCMatrix":
        import scipy.sparse as sp
        bnc = bnc or bnr
        ptr, index, value = host(ptr), host(index), host(value)
        n, m = shape
        nr, nc = -(-n // bnr), -(-m // bnc)
        a = sp.csr_matrix((value, index, ptr), shape=shape)
        a.resize((nr * bnr, nc * bnc))
        bt = sp.bsr_matrix(a.T.tocsr(), blocksize=(bnc, bnr))
        bt.sort_indices()
        bcol_ids = np.repeat(np.arange(nc, dtype=np.int32), np.diff(bt.indptr))
        out = cls(bptr=as_tensor(bt.indptr, np.int32),
                  bindex=as_tensor(bt.indices, np.int32),
                  value=as_tensor(np.transpose(bt.data, (0, 2, 1))),
                  bcol_ids=as_tensor(bcol_ids), nrows=int(n), ncols=int(m),
                  nnz=int(len(value)), bnr=int(bnr), bnc=int(bnc), nr=nr,
                  nc=nc)
        return out.to(resolve_device(device))

    def to_csr_arrays(self):
        return self._cached_csr(self._csr_of)

    def _csr_of(self):
        import scipy.sparse as sp
        bt = sp.bsr_matrix((np.transpose(host(self.value), (0, 2, 1)),
                            host(self.bindex), host(self.bptr)),
                           shape=(self.nc * self.bnc, self.nr * self.bnr))
        a = bt.T.tocsr()
        a.resize(self.shape)
        a = a.tocsr()
        a.eliminate_zeros()
        a.sort_indices()
        return a.indptr.astype(np.int32), a.indices.astype(np.int32), a.data

    def matvec(self, x):
        xb = _padded(x, self.nc * self.bnc).view(self.nc, self.bnc)
        xg = xb.index_select(0, self.bcol_ids)
        dt = torch.promote_types(xg.dtype, self.value.dtype)
        yb = torch.einsum("kij,kj->ki", self.value.to(dt), xg.to(dt))
        y = torch.zeros(self.nr, self.bnr, dtype=dt, device=yb.device)
        return y.index_add_(0, self.bindex, yb).reshape(-1)[: self.nrows]

    def matvech(self, x):
        xb = _padded(x, self.nr * self.bnr).view(self.nr, self.bnr)
        xg = xb.index_select(0, self.bindex)
        dt = torch.promote_types(xg.dtype, self.value.dtype)
        yb = torch.einsum("kij,ki->kj", conj(self.value).to(dt), xg.to(dt))
        y = torch.zeros(self.nc, self.bnc, dtype=dt, device=yb.device)
        return y.index_add_(0, self.bcol_ids, yb).reshape(-1)[: self.ncols]
