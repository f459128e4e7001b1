"""Format conversion with CSR as the hub.

Port of ``lis_tpu/matrix/convert.py`` (reference lis_matrix_convert,
src/matrix/lis_matrix_ops.c:128-326): conversion routes through canonical
CSR arrays on the host, and the result lands on the device of the matrix
converted.  Only ``csr`` and ``cst`` are ported so far; every other
target raises and names the ROADMAP item that ports it.
"""

from __future__ import annotations

import numpy as np

from lis_tpu_torch.matrix.base import SparseMatrix, get_format
from lis_tpu_torch.matrix import csr as _csr    # noqa: F401 (registers 'csr')
from lis_tpu_torch.matrix import cst as _cst    # noqa: F401 (registers 'cst')

# where each lis_tpu format lands in ROADMAP.md's queue 1
_ROADMAP = {
    "dia": "queue 1 item 2 (DIA and auto_storage)",
    "css": "queue 1 item 3 (kernel #1, CST scaling and CSS)",
}


def convert_matrix(matrix: SparseMatrix, target: str, **kw) -> SparseMatrix:
    """Convert ``matrix`` to the ``target`` format name (csr or cst)."""
    target = target.lower()
    if matrix.format_name == target and not kw:
        return matrix
    try:
        cls = get_format(target)
    except KeyError:
        item = _ROADMAP.get(target, "queue 1 item 8 (remaining formats)")
        raise NotImplementedError(
            f"storage format {target!r} is not ported to lis_tpu_torch yet "
            f"(ROADMAP.md {item}); have csr, cst") from None
    ptr, index, value = matrix.to_csr_arrays()
    return cls.from_csr_arrays(ptr, index, value, matrix.shape,
                               **kw).to(matrix.device)


def diag_profile(A):
    """(offsets, nnz) of the matrix's diagonal structure — host-side."""
    ptr, index, value = A.to_csr_arrays()
    nnz = len(value)
    if nnz == 0 or A.nrows != A.ncols:
        return None, nnz
    rows = np.repeat(np.arange(A.nrows, dtype=np.int64), np.diff(ptr))
    offs = np.unique(np.asarray(index).astype(np.int64) - rows)
    return offs, nnz


def is_banded(A, max_nnd: int = 512, max_fill: float = 4.0):
    """True when A's nonzeros lie on few enough diagonals for DIA storage
    (nnd <= max_nnd and padding <= max_fill x nnz)."""
    offs, nnz = diag_profile(A)
    return (offs is not None and len(offs) <= max_nnd
            and len(offs) * A.nrows <= max_fill * nnz)
