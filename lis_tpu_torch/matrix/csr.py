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

import numpy as np
import torch

from lis_tpu_torch.matrix.base import SparseMatrix, matrix_format, static, host


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
    def from_csr_arrays(cls, ptr, index, value, shape) -> "CSRMatrix":
        """Build on the CPU from host arrays; ``.to(device)`` moves it."""
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
        return out

    def to(self, device=None, dtype=None):
        out = super().to(device, dtype)
        cached = getattr(self, "_host_csr", None)
        if cached is not None and dtype is None:
            # host arrays are unchanged by a device move: keep them so
            # to_csr_arrays() needs no device-to-host copy
            object.__setattr__(out, "_host_csr", cached)
        return out

    def to_csr_arrays(self):
        cached = getattr(self, "_host_csr", None)
        if cached is not None:
            return cached
        out = (host(self.ptr), host(self.index), host(self.value))
        object.__setattr__(self, "_host_csr", out)
        return out

    def matvec(self, x):
        prod = self.value * x.index_select(0, self.index)
        y = torch.zeros(self.nrows, dtype=prod.dtype, device=prod.device)
        return y.index_add_(0, self.row_ids, prod)

    def matvech(self, x):
        v = self.value.conj() if self.value.is_complex() else self.value
        prod = v * x.index_select(0, self.row_ids)
        y = torch.zeros(self.ncols, dtype=prod.dtype, device=prod.device)
        return y.index_add_(0, self.index, prod)

    def get_diagonal(self):
        contrib = torch.where(self.index == self.row_ids, self.value,
                              torch.zeros((), dtype=self.value.dtype,
                                          device=self.value.device))
        y = torch.zeros(self.nrows, dtype=self.value.dtype,
                        device=self.value.device)
        return y.index_add_(0, self.row_ids, contrib)
