"""The new Krylov solvers over a prebuilt CST, against lis_tpu and scipy.

A real CST of the nonsymmetric a − 0.5·aᵀ + 4k·I (tests/test_torch_nonsym.py's
system) at n = 2^12, k = 5, is built once in each package without a
transpose grid, as the router builds it for every solver but bicg/bicr:
CRS, GPBiCR and BiCRSafe then apply Aᴴ once, at setup, through the
scatter.  Solves with ``-storage cst`` (``-scale 1`` scales the grid
itself) give equal iteration counts and statuses, x to rtol 1e-9 and
rhistory to rtol 1e-9 above 16 eps of its largest entry
(``assert_same`` of test_torch_krylov.py).

On complex data lis_tpu's scatter returns conj(Aᵀx) in place of Aᴴx
(lis_tpu/matrix/cst.py:347), so its shadow vector differs from the
port's.  Complex CRS, GPBiCR and BiCRSafe over CST are held to scipy:
SUCCESS and a true residual at the tolerance.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lis_tpu
import lis_tpu_torch
from lis_tpu.matrix.cst import CSTMatrix as JCST
from lis_tpu_torch.matrix.cst import CSTMatrix as TCST
from tests.test_torch_krylov import assert_same
from tests.test_torch_nonsym import nonsym

N, K = 1 << 12, 5
_BUILT = {}


def built(kind):
    """(scipy matrix, lis_tpu CST or None, port CST, b), once per module:
    "real" the nonsymmetric system, "complex" the same with a random phase
    on every off-diagonal entry (port only)."""
    if kind not in _BUILT:
        a = nonsym(N, K)
        rng = np.random.default_rng(N + K)
        b = rng.standard_normal(N)
        if kind == "complex":
            c = a.tocoo()
            ph = np.where(c.row == c.col, 1.0,
                          np.exp(1j * rng.standard_normal(c.nnz)))
            a = sp.csr_matrix((c.data * ph, (c.row, c.col)), shape=a.shape)
            a.sort_indices()
            b = b + 1j * rng.standard_normal(N)
        args = (a.indptr, a.indices, a.data, a.shape)
        J = None if kind == "complex" else \
            JCST.from_csr_arrays(*args, transpose=False)
        T = TCST.from_csr_arrays(*args, transpose=False, device="cpu")
        _BUILT[kind] = (a, J, T, b)
    return _BUILT[kind]


@pytest.mark.parametrize("opts", [
    "-i crs -p jacobi", "-i gpbicr -p jacobi", "-i bicrsafe -p jacobi",
    "-i cgs -p jacobi -scale 1", "-i tfqmr -p none",
    "-i bicgstabl -ell 4 -p jacobi", "-i idrs -irestart 4 -p jacobi",
    "-i gpbicg -p jacobi -scale 1"])
def test_prebuilt_cst_solve_matches_lis_tpu(opts):
    a, J, T, b = built("real")
    assert T.at is None
    opts += " -storage cst -tol 1e-10"
    rj, rt = lis_tpu.solve(J, b, options=opts), \
        lis_tpu_torch.solve(T, b, options=opts)
    assert rj.status == lis_tpu.LIS_SUCCESS
    assert_same(rj, rt, rtol=1e-9, last="tfqmr" not in opts, ulps=16)


@pytest.mark.parametrize("solver", ["crs", "gpbicr", "bicrsafe"])
def test_complex_cst_shadow_by_scatter_solves_to_scipy(solver):
    a, _, T, b = built("complex")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(N)
                         + 1j * np.random.default_rng(4).standard_normal(N))
    np.testing.assert_allclose(T.matvech(x).numpy(),
                               a.conj().T @ x.numpy(), rtol=1e-12,
                               atol=1e-12)
    r = lis_tpu_torch.solve(T, b, options=f"-i {solver} -p jacobi "
                            "-storage cst -tol 1e-10")
    assert r.status == lis_tpu_torch.LIS_SUCCESS
    assert r.x.dtype == torch.complex128
    res = np.linalg.norm(a @ r.x.numpy() - b) / np.linalg.norm(b)
    assert res <= 1e-9 and r.true_resid <= 1e-9
