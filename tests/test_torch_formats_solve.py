"""solve() over the scalar storage formats against lis_tpu.

``-storage csc|msr|ell|jad|coo|dns`` (ids 2, 3, 5, 6, 10 and 11) with
CG + Jacobi, BiCGSTAB + ILU(0), GMRES + SSOR (both on the level-scheduled
path of a non-DIA operator) and CG with symmetric scaling: lis_tpu's
status and count, x to rtol 1e-9.  Under ``-f quad`` every format becomes
the ELL pair built from the same canonical CSR, so the count must equal
lis_tpu's and the port's own ``-storage csr`` count exactly.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import lis_tpu
import lis_tpu_torch

FORMATS = {"csc": 2, "msr": 3, "ell": 5, "jad": 6, "coo": 10, "dns": 11}
OPTIONS = ["-i cg -p jacobi -tol 1e-10", "-i bicgstab -p ilu -tol 1e-10",
           "-i gmres -p ssor -tol 1e-10", "-i cg -scale 2 -tol 1e-10"]

_SYSTEM = {}


def system():
    """A 2-D Laplacian on 13 x 11 points with random symmetric couplings
    of up to 6 points away and a diagonal shift: SPD, neither banded
    enough for routing nor structured, with rows of 3 to 9 entries."""
    if not _SYSTEM:
        rng = np.random.default_rng(12)
        nx, ny = 13, 11
        n = nx * ny
        lap = sp.kronsum(sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (nx, nx)),
                         sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (ny, ny)))
        i = rng.integers(0, n, 60)
        j = np.clip(i + rng.integers(-6, 7, 60), 0, n - 1)
        r = sp.coo_matrix((rng.uniform(-0.3, 0.3, 60), (i, j)), shape=(n, n))
        a = (lap + r + r.T + sp.eye(n) * 0.5).tocsr()
        a.sum_duplicates()
        a.eliminate_zeros()
        a.sort_indices()
        args = (a.indptr, a.indices, a.data, a.shape)
        _SYSTEM["v"] = (lis_tpu.CSRMatrix.from_csr_arrays(*args),
                        lis_tpu_torch.CSRMatrix.from_csr_arrays(
                            *args, device="cpu"),
                        rng.standard_normal(n))
    return _SYSTEM["v"]


def assert_same(rj, rt, rtol=1e-9):
    assert (rt.status, rt.iters) == (rj.status, rj.iters)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=rtol,
                               atol=rtol * np.abs(xj).max())
    np.testing.assert_allclose(rt.true_resid, rj.true_resid, rtol=1e-3,
                               atol=1e-15)


@pytest.mark.parametrize("opts", OPTIONS)
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_storage_solve_matches_lis_tpu(fmt, opts):
    J, T, b = system()
    # the format by name here, by id in half the cases
    storage = FORMATS[fmt] if "jacobi" in opts or "ssor" in opts else fmt
    opts = f"{opts} -storage {storage}"
    rj = lis_tpu.solve(J, b, options=opts)
    rt = lis_tpu_torch.solve(T, b, options=opts)
    assert rj.status == lis_tpu.LIS_SUCCESS
    assert lis_tpu_torch.transform_operator(
        T, rt.options).format_name == fmt
    assert_same(rj, rt)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_storage_quad_count_is_exact(fmt):
    J, T, b = system()
    opts = "-i bicgstab -p jacobi -f quad -tol 1e-12"
    rj = lis_tpu.solve(J, b, options=f"{opts} -storage {fmt}")
    rt = lis_tpu_torch.solve(T, b, options=f"{opts} -storage {fmt}")
    rc = lis_tpu_torch.solve(T, b, options=f"{opts} -storage csr")
    assert rj.status == lis_tpu.LIS_SUCCESS
    assert rt.iters == rj.iters == rc.iters
    assert_same(rj, rt)
    np.testing.assert_array_equal(rt.x.numpy(), rc.x.numpy())
