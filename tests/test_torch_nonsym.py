"""Nonsymmetric solves over a prebuilt CST, and CST scaling, against
lis_tpu.

A CST grid is built once per module in both packages and handed to
``solve()`` with ``-storage cst``: ``-scale 1`` then scales the grid
itself (``scale_rows``, transpose grid included) instead of rebuilding
it, and the CG + Jacobi upgrade turns it into ``scale_symm``.  Solves
must give equal iteration counts and statuses, and rhistory and x to
rtol 1e-9 (summation orders differ).  Scaled grids must equal lis_tpu's
bit for bit (val, diag, remainder; on A's grid and on the transpose grid)
and apply D·A·D / D·A as scipy does, to rtol 1e-12.

The system is a − 0.5·aᵀ + 4k·I with k random columns per row: the
sparsity pattern of tests/test_torch_cst.py's SPD system, at its grids
n = 2^15, k = 5 and n = 2^16, k = 8.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import lis_tpu
import lis_tpu_torch
from lis_tpu.matrix.css import _csr_scaled
from lis_tpu.matrix.cst import CSTMatrix as JCST
from lis_tpu_torch.matrix.csr import csr_scaled
from lis_tpu_torch.matrix.cst import CSTMatrix as TCST
from tests.test_torch_cst import spd
from tests.test_torch_solve import assert_same

GRIDS = [(1 << 15, 5), (1 << 16, 8)]
SOLVERS = ["bicg", "bicr", "bicgstab", "bicrstab"]


def nonsym(n, k, seed=0):
    """a − 0.5·aᵀ + 4k·I with k random standard-normal columns per row."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, size=n * k)
    a = sp.coo_matrix((rng.standard_normal(n * k), (rows, cols)),
                      shape=(n, n)).tocsr()
    a = (a - 0.5 * a.T + sp.eye(n) * (4 * k)).tocsr()
    a.sort_indices()
    return a


_BUILT = {}


def built(kind, n, k):
    """(scipy matrix, lis_tpu CST, port CST, b) for ``kind`` in nonsym,
    spd, built once per process."""
    if (kind, n, k) not in _BUILT:
        a = {"nonsym": nonsym, "spd": spd}[kind](n, k)
        args = (a.indptr, a.indices, a.data, a.shape)
        b = np.random.default_rng(n + k).standard_normal(n)
        _BUILT[kind, n, k] = (a, JCST.from_csr_arrays(*args),
                              TCST.from_csr_arrays(*args, device="cpu"), b)
    return _BUILT[kind, n, k]


def both(grid, opts, kind="nonsym"):
    a, J, T, b = built(kind, *grid)
    return lis_tpu.solve(J, b, options=opts), \
        lis_tpu_torch.solve(T, b, options=opts)


def assert_scaled_equal(t, j):
    for name in ("val", "diag"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)),
                                      err_msg=name)
    assert (t.rem is None) == (j.rem is None)
    if t.rem is not None:
        np.testing.assert_array_equal(t.rem.value.numpy(),
                                      np.asarray(j.rem.value))


@pytest.mark.parametrize("grid", GRIDS, ids=["n15k5", "n16k8"])
@pytest.mark.parametrize("mode", ["rows", "symm"])
def test_scaling_matches_lis_tpu_and_scipy(grid, mode):
    a, J, T, b = built("nonsym", *grid)
    n = a.shape[0]
    d = np.random.default_rng(7).uniform(0.5, 2.0, n)
    Ts = getattr(T, f"scale_{mode}")(torch.from_numpy(d))
    Js = getattr(J, f"scale_{mode}")(jnp.asarray(d))
    assert_scaled_equal(Ts, Js)
    assert_scaled_equal(Ts.at, Js.at)
    D = sp.diags(d)
    ref = D @ a @ D if mode == "symm" else D @ a
    x = np.random.default_rng(8).standard_normal(n)
    np.testing.assert_allclose(Ts.matvec(torch.from_numpy(x)).numpy(),
                               ref @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Ts.matvech(torch.from_numpy(x)).numpy(),
                               ref.T @ x, rtol=1e-12, atol=1e-12)
    # the unscaled grid is left as it was
    np.testing.assert_array_equal(T.val.numpy(), np.asarray(J.val))


def test_csr_scaled_matches_lis_tpu():
    a, J, T, b = built("nonsym", *GRIDS[0])
    assert T.rem is not None
    rng = np.random.default_rng(9)
    dr, dc = rng.standard_normal(a.shape[0]), rng.standard_normal(a.shape[1])
    got = csr_scaled(T.rem, torch.from_numpy(dr), torch.from_numpy(dc))
    want = _csr_scaled(J.rem, jnp.asarray(dr), jnp.asarray(dc))
    np.testing.assert_array_equal(got.value.numpy(), np.asarray(want.value))
    assert got.index is T.rem.index and got.row_ids is T.rem.row_ids


@pytest.mark.parametrize("precon", ["jacobi", "none"])
@pytest.mark.parametrize("scale", [0, 1])
@pytest.mark.parametrize("solver", SOLVERS)
def test_prebuilt_cst_solve_matches_lis_tpu(solver, scale, precon):
    rj, rt = both(GRIDS[0], f"-i {solver} -p {precon} -storage cst "
                  f"-scale {scale} -tol 1e-10")
    assert rj.status == lis_tpu.LIS_SUCCESS
    assert_same(rj, rt, rtol=1e-9)


@pytest.mark.parametrize("solver", ["bicg", "bicrstab"])
def test_prebuilt_cst_solve_larger_grid(solver):
    """The 5-pass plan of the larger grid, with Aᴴ every step (BiCG) and
    once at setup (BiCRSTAB)."""
    rj, rt = both(GRIDS[1], f"-i {solver} -p jacobi -storage cst -scale 1 "
                  "-tol 1e-10")
    assert rj.status == lis_tpu.LIS_SUCCESS
    assert_same(rj, rt, rtol=1e-9)


@pytest.mark.parametrize("solver", SOLVERS)
def test_prebuilt_cst_maxiter_matches_lis_tpu(solver):
    rj, rt = both(GRIDS[0], f"-i {solver} -p jacobi -storage cst -scale 1 "
                  "-tol 1e-14 -maxiter 3")
    assert rt.status == lis_tpu_torch.LIS_MAXITER and rt.iters == 3
    assert_same(rj, rt, rtol=1e-9)


@pytest.mark.parametrize("grid", GRIDS, ids=["n15k5", "n16k8"])
def test_prebuilt_spd_cst_cg_jacobi_scale1(grid):
    """CG + Jacobi upgrades -scale 1 to symmetric scaling, which runs
    CSTMatrix.scale_symm on the prebuilt grid."""
    rj, rt = both(grid, "-i cg -p jacobi -storage cst -scale 1 -tol 1e-10",
                  kind="spd")
    assert rj.status == lis_tpu.LIS_SUCCESS
    assert_same(rj, rt, rtol=1e-9)
