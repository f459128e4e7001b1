"""DNS — dense storage.

Port of ``lis_tpu/matrix/dns.py`` (reference: src/matrix/lis_matrix_dns.c),
stored row-major (n, m).  The matvec is a dense matrix-vector product:
lis_tpu computes it outside any Pallas kernel (``value @ x``), so here it
is ``torch.mv`` (cuBLAS on the card).  n² elements: 2 GiB in f64 at
n = 16384.
"""

from __future__ import annotations

import numpy as np
import torch

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import (SparseMatrix, as_tensor, host,
                                       matrix_format, static)


@matrix_format("dns")
class DNSMatrix(SparseMatrix):
    value: torch.Tensor       # (n, m) dense
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape,
                        device=None) -> "DNSMatrix":
        import scipy.sparse as sp
        value = host(value)
        a = sp.csr_matrix((value, host(index), host(ptr)), shape=shape)
        return cls(value=as_tensor(a.toarray()), nrows=int(shape[0]),
                   ncols=int(shape[1]), nnz=len(value)
                   ).to(resolve_device(device))

    @classmethod
    def from_dense(cls, dense, device=None) -> "DNSMatrix":
        d = host(dense)
        return cls(value=as_tensor(d), nrows=d.shape[0], ncols=d.shape[1],
                   nnz=int((d != 0).sum())).to(resolve_device(device))

    def to_csr_arrays(self):
        def build():
            import scipy.sparse as sp
            a = sp.csr_matrix(host(self.value))
            a.sort_indices()
            return (a.indptr.astype(np.int32), a.indices.astype(np.int32),
                    a.data)
        return self._cached_csr(build)

    def to_dense(self):
        return host(self.value)

    def _mv(self, a, x):
        dt = torch.promote_types(a.dtype, x.dtype)
        return torch.mv(a.to(dt), x.to(dt))

    def matvec(self, x):
        return self._mv(self.value, x)

    def matvech(self, x):
        return self._mv(self.value.mH, x)

    def get_diagonal(self):
        return torch.diagonal(self.value).clone()
