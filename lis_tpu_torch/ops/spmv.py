"""SpMV dispatch — the lis_matvec / lis_matvech interface.

Port of ``lis_tpu/ops/spmv.py``.  The reference dispatches on
A->matrix_type (src/matvec/lis_matvec.c:55-345); here dispatch is a
method call on the format object, which launches the format's kernel on
the card (DIA: E and F, CST: A-D, BES: Q and R) or runs its torch
operations.
"""

from __future__ import annotations

from lis_tpu_torch.matrix.base import SparseMatrix


def matvec(a: SparseMatrix, x):
    """y = A x."""
    return a.matvec(x)


def matvech(a: SparseMatrix, x):
    """y = Aᴴ x."""
    return a.matvech(x)
