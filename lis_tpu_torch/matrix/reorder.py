"""Bandwidth-reducing reordering (reverse Cuthill-McKee).

Port of ``lis_tpu/matrix/reorder.py``.  ``-reorder rcm`` makes the solver
driver solve the symmetrically permuted system (P A Pᵀ)(P x) = P b, so the
gather-free formats (DIA, HDI) see the locality RCM exposes.  The
permutation is computed on the host (scipy); the driver permutes b and x0
once at entry and x once at exit, on the device.
"""

from __future__ import annotations

import numpy as np


def rcm_permutation(A) -> np.ndarray:
    """Reverse-Cuthill-McKee permutation of A's symmetrised graph."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    ptr, index, value = A.to_csr_arrays()
    g = sp.csr_matrix((np.ones(len(value)), index, ptr), shape=A.shape)
    g = g + g.T
    return np.asarray(reverse_cuthill_mckee(g, symmetric_mode=True))


def permute_symmetric(A, perm: np.ndarray):
    """P A Pᵀ (rows and columns reordered by perm) in A's format, on A's
    device."""
    a = A._scipy()
    return A._rebuilt_scipy(a[perm][:, perm])


def bandwidth(A) -> int:
    """max |col - row| over the nonzeros (host-side)."""
    ptr, index, _ = A.to_csr_arrays()
    if len(index) == 0:
        return 0
    rows = np.repeat(np.arange(A.nrows, dtype=np.int64), np.diff(ptr))
    return int(np.abs(np.asarray(index, dtype=np.int64) - rows).max())
