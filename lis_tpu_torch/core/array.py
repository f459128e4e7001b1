"""Small dense-matrix kernels (analogue of src/array/lis_array.c).

Port of ``lis_tpu/core/array.py``.  The reference keeps a private
mini-BLAS/LAPACK for the small dense problems of its ``lis_array_*``
calls (lis_array_ge / lis_array_solve :960, cgs/mgs :1029,1084, the QR
iteration lis_array_qr :1136).  Here they are torch operations on the
operands' device; a host array is taken as a CPU tensor.  Each returns
tensors.
"""

from __future__ import annotations

import torch


def _t(a) -> torch.Tensor:
    return torch.as_tensor(a)


def matvec(a, x):
    """Dense y = A x (lis_array_matvec)."""
    return _t(a) @ _t(x)


def matvech(a, x):
    """Dense y = Aᴴ x."""
    a = _t(a)
    return (a.conj() if a.is_complex() else a).T @ _t(x)


def matmat(a, b):
    """Dense C = A B (lis_array_matmat)."""
    return _t(a) @ _t(b)


def solve(a, b):
    """Dense solve via LU (lis_array_solve / lis_array_ge)."""
    return torch.linalg.solve(_t(a), _t(b))


def invert(a):
    """Dense inverse (lis_array_ge computes the explicit inverse)."""
    return torch.linalg.inv(_t(a))


def cgs(a):
    """Classical Gram-Schmidt QR (lis_array_cgs, src/array/lis_array.c:1029).

    Returns (Q, R) with A = Q R.  Classical (not modified) to match the
    reference routine; use ``mgs`` for the better-conditioned variant.
    """
    a = _t(a)
    n = a.shape[1]
    q = torch.zeros_like(a)
    r = torch.zeros((n, n), dtype=a.dtype, device=a.device)
    for j in range(n):
        v = a[:, j]
        rj = q.T.conj() @ v          # projections against all previous q's
        rj = torch.where(torch.arange(n, device=a.device) < j, rj,
                         torch.zeros_like(rj))
        v = v - q @ rj
        nrm = torch.linalg.vector_norm(v)
        q[:, j] = v / nrm
        r[:, j] = rj
        r[j, j] = nrm
    return q, r


def mgs(a):
    """Modified Gram-Schmidt QR (lis_array_mgs, src/array/lis_array.c:1084)."""
    a = _t(a)
    n = a.shape[1]
    q = a.clone()
    r = torch.zeros((n, n), dtype=a.dtype, device=a.device)
    for j in range(n):
        nrm = torch.linalg.vector_norm(q[:, j])
        r[j, j] = nrm
        qj = q[:, j] / nrm
        q[:, j] = qj
        proj = qj.conj() @ q          # row of projections
        mask = torch.arange(n, device=a.device) > j
        r[j, :] = torch.where(mask, proj, r[j, :])
        q = q - torch.outer(qj, torch.where(mask, proj,
                                            torch.zeros_like(proj)))
    return q, r


def qr_eigen(a, maxiter: int = 200, tol: float = 1e-12):
    """Unshifted QR iteration for eigenvalues of a small dense matrix.

    Analogue of lis_array_qr (src/array/lis_array.c:1136), which runs plain
    QR steps until the subdiagonal decays.  Returns (eigenvalue vector,
    iterations).  Like the reference, complex pairs are not split — for
    real symmetric / tridiagonal inputs (Lanczos) the diagonal converges
    to the spectrum.
    """
    t = _t(a).clone()
    it, off = 0, float("inf")
    while it < maxiter and off > tol:
        q, r = torch.linalg.qr(t)
        t = r @ q
        off = float(torch.sqrt(torch.sum(torch.tril(t, -1) ** 2)))
        it += 1
    return torch.diagonal(t), it
