"""scipy.sparse.linalg-compatible bindings.

Port of ``lis_tpu/interop/scipy_compat.py``.  Signatures follow
scipy.sparse.linalg (cg/bicgstab/gmres/...):
``x, info = cg(A, b, x0=None, rtol=1e-5, atol=0.0, maxiter=None, M=None,
callback=None)`` where info = 0 on success, >0 = no convergence in maxiter
iterations.  A may be a scipy sparse matrix, a dense ndarray, or a
lis_tpu_torch SparseMatrix; a matrix built here lives on the default
device, the card.  M (if given) must be a preconditioner name string
("jacobi", "ilu", "ssor", ...) or a preconditioner object with .psolve.
x comes back as a host numpy array.

``callback`` is called once, with the final iterate, as lis_tpu calls it
(its iteration is one compiled loop).  The port's loop runs in Python and
could call it every iteration, but that would be a feature lis_tpu lacks.

This is the analogue of the reference's Fortran bindings layer
(src/fortran/lisf_solver.c): a thin adapter from another ecosystem's
calling convention onto the native driver.
"""

from __future__ import annotations

import numpy as np
import torch

from lis_tpu_torch.matrix.base import host


def from_scipy(A, matrix_type: str = "csr", device=None):
    """Convert a scipy sparse matrix (or dense ndarray) to a port format
    object on ``device`` (None: the default device)."""
    from lis_tpu_torch.matrix.base import SparseMatrix
    from lis_tpu_torch.matrix.csr import CSRMatrix
    from lis_tpu_torch.matrix.convert import convert_matrix
    if isinstance(A, SparseMatrix):
        m = A if device is None else A.to(device)
    else:
        import scipy.sparse as sp
        a = A.tocsr() if hasattr(A, "tocsr") else sp.csr_matrix(np.asarray(A))
        a.sort_indices()
        m = CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape,
                                      device=device)
    if matrix_type != "csr" or not isinstance(m, CSRMatrix):
        m = convert_matrix(m, matrix_type, device=m.device)
    return m


def to_scipy(m):
    """Port matrix → scipy.sparse.csr_matrix."""
    import scipy.sparse as sp
    ptr, index, value = m.to_csr_arrays()
    return sp.csr_matrix((np.asarray(value), np.asarray(index),
                          np.asarray(ptr)), shape=m.shape)


def aslinearoperator(m):
    """Port matrix → scipy LinearOperator (matvec/rmatvec on the matrix's
    device, numpy in and out)."""
    from scipy.sparse.linalg import LinearOperator

    def on_device(x):
        return torch.from_numpy(np.ascontiguousarray(x).ravel()).to(m.device)

    return LinearOperator(
        shape=m.shape,
        matvec=lambda x: host(m.matvec(on_device(x))),
        rmatvec=lambda x: host(m.matvech(on_device(x))),
        dtype=host(m.get_diagonal()).dtype)


def _run(solver: str, A, b, x0, rtol, atol, maxiter, M, callback,
         conv_cond: str = "nrm2_b", **extra):
    from lis_tpu_torch.solvers.driver import solve
    m = from_scipy(A)
    b = np.asarray(b).ravel()
    if not np.iscomplexobj(b):
        b = b.astype(np.float64)
    # scipy convergence: ||r|| <= max(rtol*||b||, atol).  solve()'s
    # nrm2_b criterion is ||r||/||b|| <= tol; fold atol in via the max.
    bnrm = float(np.linalg.norm(b))
    tol = max(float(rtol), float(atol) / bnrm if bnrm > 0 else 0.0)
    opts = f"-i {solver} -tol {tol} -conv_cond {conv_cond}"
    if maxiter is not None:
        opts += f" -maxiter {int(maxiter)}"
    for k, v in extra.items():
        opts += f" -{k} {v}"
    precon = None
    if isinstance(M, str):
        opts += f" -p {M}"
    elif M is not None:
        precon = M
    res = solve(m, b, x0=None if x0 is None else np.asarray(x0).ravel(),
                options=opts, M=precon)
    x = res.x.to("cpu", copy=True).numpy()
    if callback is not None:
        # as lis_tpu: once, with the final iterate (use
        # SolveResult.rhistory via lis_tpu_torch.solve for residual traces)
        callback(x)
    info = 0 if res.status == 0 else (res.iters if res.iters else -1)
    return x, info


def cg(A, b, x0=None, *, rtol=1e-5, atol=0.0, maxiter=None, M=None,
       callback=None):
    return _run("cg", A, b, x0, rtol, atol, maxiter, M, callback)


def bicg(A, b, x0=None, *, rtol=1e-5, atol=0.0, maxiter=None, M=None,
         callback=None):
    return _run("bicg", A, b, x0, rtol, atol, maxiter, M, callback)


def bicgstab(A, b, x0=None, *, rtol=1e-5, atol=0.0, maxiter=None, M=None,
             callback=None):
    return _run("bicgstab", A, b, x0, rtol, atol, maxiter, M, callback)


def cgs(A, b, x0=None, *, rtol=1e-5, atol=0.0, maxiter=None, M=None,
        callback=None):
    return _run("cgs", A, b, x0, rtol, atol, maxiter, M, callback)


def gmres(A, b, x0=None, *, rtol=1e-5, atol=0.0, restart=None, maxiter=None,
          M=None, callback=None, callback_type=None):
    restart = int(restart) if restart else 20   # scipy's default restart
    # scipy counts maxiter in restart CYCLES; solve() counts total
    # (inner) iterations like the reference — convert.
    if maxiter is not None:
        maxiter = int(maxiter) * restart
    return _run("gmres", A, b, x0, rtol, atol, maxiter, M, callback,
                restart=restart)


def minres(A, b, x0=None, *, shift=0.0, rtol=1e-5, maxiter=None, M=None,
           callback=None):
    if shift != 0.0:
        raise NotImplementedError("minres shift != 0")
    return _run("minres", A, b, x0, rtol, 0.0, maxiter, M, callback)
