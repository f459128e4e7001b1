"""Format conversion with CSR as the hub.

Port of ``lis_tpu/matrix/convert.py`` (reference lis_matrix_convert,
src/matrix/lis_matrix_ops.c:128-326): conversion routes through canonical
CSR arrays on the host, and the result lands on ``device`` (None: the
default device, the card; ``solve()`` passes the device of its matrix).
The scalar formats ``csr``, ``coo``, ``csc``, ``msr``, ``ell``, ``jad``,
``dns``, ``dia`` and ``hdi``, and ``css`` and ``cst`` are ported; the
block formats ``bsr``, ``bsc`` and ``vbr`` and BES raise and name the
ROADMAP item that ports them.
"""

from __future__ import annotations

import numpy as np

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import SparseMatrix, get_format
from lis_tpu_torch.matrix import coo as _coo    # noqa: F401 (registers 'coo')
from lis_tpu_torch.matrix import csc as _csc    # noqa: F401 (registers 'csc')
from lis_tpu_torch.matrix import csr as _csr    # noqa: F401 (registers 'csr')
from lis_tpu_torch.matrix import cst as _cst    # noqa: F401 (registers 'cst')
from lis_tpu_torch.matrix import dia as _dia    # noqa: F401 (registers 'dia')
from lis_tpu_torch.matrix import dns as _dns    # noqa: F401 (registers 'dns')
from lis_tpu_torch.matrix import ell as _ell    # noqa: F401 (registers 'ell')
from lis_tpu_torch.matrix import hybrid as _hdi  # noqa: F401 (registers 'hdi')
from lis_tpu_torch.matrix import css as _css    # noqa: F401 (registers 'css')
from lis_tpu_torch.matrix import jad as _jad    # noqa: F401 (registers 'jad')
from lis_tpu_torch.matrix import msr as _msr    # noqa: F401 (registers 'msr')

# the formats still to port, and the ROADMAP item of each
_NOT_PORTED = {"bsr": "item 8b (block formats)",
               "bsc": "item 8b (block formats)",
               "vbr": "item 8b (block formats)",
               "bes": "item 8c (BES)"}


def convert_matrix(matrix: SparseMatrix, target: str, device=None,
                   **kw) -> SparseMatrix:
    """Convert ``matrix`` to the ``target`` format name (csr, coo, csc,
    msr, ell, jad, dns, dia, hdi, css or cst); the result lives on
    ``device`` (None: the default device)."""
    target = target.lower()
    device = resolve_device(device)
    if matrix.format_name == target and not kw:
        return matrix if matrix.device == device else matrix.to(device)
    try:
        cls = get_format(target)
    except KeyError:
        item = _NOT_PORTED.get(target, "item 8 (remaining formats)")
        raise NotImplementedError(
            f"storage format {target!r} is not ported to lis_tpu_torch yet "
            f"(ROADMAP.md queue 1 {item})") from None
    ptr, index, value = matrix.to_csr_arrays()
    return cls.from_csr_arrays(ptr, index, value, matrix.shape,
                               device=device, **kw)


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
