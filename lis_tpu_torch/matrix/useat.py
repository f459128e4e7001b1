"""Explicit-transpose operator (-use_at).

Port of ``lis_tpu/matrix/useat.py`` (reference: the BiCG family may
materialise Aᵀ so the transpose product runs the row-oriented kernel
instead of the scatter direction, LIS_USE_AT_TYPE,
src/solver/lis_solver.c:163-166,836-843).  ``At`` is Aᴴ as a CSR
(conjugated on complex data), so ``matvech`` is its gather matvec.  The
wrapper's ``format_name`` is "use_at": SSOR and ILU take their general
(level-scheduled) path on it, even over DIA, as in lis_tpu.
"""

from __future__ import annotations

import dataclasses

from lis_tpu_torch.matrix.base import SparseMatrix


@dataclasses.dataclass(frozen=True, eq=False)
class WithTranspose(SparseMatrix):
    A: SparseMatrix           # the operator
    At: SparseMatrix          # explicit Aᴴ in CSR

    format_name = "use_at"

    @property
    def nrows(self):
        return self.A.nrows

    @property
    def ncols(self):
        return self.A.ncols

    @property
    def nnz(self):
        return self.A.nnz

    def matvec(self, x):
        return self.A.matvec(x)

    def matvech(self, x):
        return self.At.matvec(x)

    def to_csr_arrays(self):
        return self.A.to_csr_arrays()

    def get_diagonal(self):
        return self.A.get_diagonal()


def with_explicit_transpose(A) -> WithTranspose:
    """A with Aᴴ built beside it as a CSR on A's device."""
    from lis_tpu_torch.matrix.convert import convert_matrix
    At = convert_matrix(A, "csr", device=A.device).transpose()
    return WithTranspose(A=A, At=At)
