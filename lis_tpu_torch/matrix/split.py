"""L/D/U matrix splitting.

Port of ``lis_tpu/matrix/split.py`` (reference lis_matrix_split,
src/matrix/lis_matrix_ops.c:860): A = L + D + U with L strictly lower, D
the diagonal and U strictly upper, for the stationary solvers and the
level-scheduled SSOR, and ``merge_matrix``, its inverse.  The split runs
on the host CSR arrays (``to_csr_arrays``, cached by the CSR and DIA
builds); the parts are built on the matrix's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lis_tpu_torch.matrix.base import SparseMatrix, TensorFields
from lis_tpu_torch.matrix.csr import CSRMatrix


@dataclasses.dataclass(frozen=True, eq=False)
class SplitMatrix(TensorFields):
    L: CSRMatrix              # strictly lower
    U: CSRMatrix              # strictly upper
    D: torch.Tensor           # diagonal vector
    Dinv: torch.Tensor        # 1/diagonal (0 where the diagonal is 0)

    @property
    def n(self) -> int:
        return self.L.nrows


def split_matrix(matrix: SparseMatrix) -> SplitMatrix:
    ptr, index, value = matrix.to_csr_arrays()
    n = matrix.nrows
    dev = matrix.device
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    diag = np.zeros(n, dtype=value.dtype)
    isd = index == rows
    np.add.at(diag, rows[isd], value[isd])

    def build(mask):
        sel_rows, sel_idx, sel_val = rows[mask], index[mask], value[mask]
        p = np.zeros(n + 1, dtype=np.int32)
        np.add.at(p, sel_rows + 1, 1)
        p = np.cumsum(p).astype(np.int32)
        return CSRMatrix.from_csr_arrays(p, sel_idx, sel_val, matrix.shape,
                                         device=dev)

    with np.errstate(divide="ignore"):
        dinv = np.where(diag != 0, 1.0 / np.where(diag != 0, diag, 1), 0.0)
    return SplitMatrix(L=build(index < rows), U=build(index > rows),
                       D=torch.from_numpy(diag).to(dev),
                       Dinv=torch.from_numpy(dinv).to(dev))


def merge_matrix(s: SplitMatrix, shape=None) -> CSRMatrix:
    """Reassemble A = L + D + U from a split (lis_matrix_merge,
    src/matrix/lis_matrix_ops.c:1052) as a CSR on the split's device,
    summed on the host."""
    import scipy.sparse as sp
    lp, li, lv = s.L.to_csr_arrays()
    up, ui, uv = s.U.to_csr_arrays()
    shape = shape or s.L.shape
    a = (sp.csr_matrix((lv, li, lp), shape=shape)
         + sp.csr_matrix((uv, ui, up), shape=shape)
         + sp.diags(s.D.detach().cpu().numpy(), shape=shape)).tocsr()
    a.sort_indices()
    return CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data, shape,
                                     device=s.L.device)
