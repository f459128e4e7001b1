"""Complex operands in lis_tpu_torch against lis_tpu: the complex CST
matvec and its scaling, COCG/COCR, complex BiCG over the transpose grid,
-f single and symmetric scaling on complex data.

Solves go through both packages with the same system and option string:
equal iteration counts and statuses, and x to rtol 1e-9 (the residual
history looser on CST, see ``assert_same_complex``).  The
CST systems are complex symmetric, a + aᵀ + 4k·I with standard-normal
real and imaginary parts on tests/test_torch_cst.py's pattern and grids;
the CSR one is the 24 x 24 Hermitian positive definite system of
tests/test_complex.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import lis_tpu
import lis_tpu_torch
from lis_tpu.matrix.cst import CSTMatrix as JCST
from lis_tpu_torch.interop.state import from_numpy_state
from lis_tpu_torch.matrix.cst import CSTMatrix as TCST
from tests.test_torch_cst import to_state
from tests.test_torch_solve import assert_same

GRIDS = [(1 << 15, 5), (1 << 16, 8)]
IDS = ["n15k5", "n16k8"]


def csym(n, k, seed=0):
    """a + aᵀ + 4k·I, a with k random complex columns per row."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, size=n * k)
    vals = rng.standard_normal(n * k) + 1j * rng.standard_normal(n * k)
    a = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    a = (a + a.T + sp.eye(n) * (4 * k)).tocsr()
    a.sort_indices()
    return a


def cvec(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def assert_same_complex(rj, rt):
    """Equal counts and status, x to rtol 1e-9, rhistory to rtol 1e-5.
    The history is the loose one: COCR's recursive residual amplifies
    the last-bit differences of complex products (XLA rounds them with
    FMAs, torch without) about tenfold per step, to 2e-6 relative at the
    last step of the n = 2^15 COCR + Jacobi solve, whose x agrees to
    1e-15."""
    assert rt.iters == rj.iters and rt.status == rj.status
    np.testing.assert_allclose(rt.rhistory, np.asarray(rj.rhistory),
                               rtol=1e-5, atol=0)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=1e-9,
                               atol=1e-9 * np.abs(xj).max())
    np.testing.assert_allclose(rt.true_resid, rj.true_resid, rtol=1e-3)


_BUILT = {}


def built(n, k):
    """(scipy matrix, lis_tpu CST, port CST, b), once per process."""
    if (n, k) not in _BUILT:
        a = csym(n, k)
        args = (a.indptr, a.indices, a.data, a.shape)
        _BUILT[n, k] = (a, JCST.from_csr_arrays(*args),
                        TCST.from_csr_arrays(*args, device="cpu"),
                        cvec(n, n + k))
    return _BUILT[n, k]


@pytest.fixture(scope="module")
def hermitian():
    """tests/test_complex.py's Hermitian system, in both packages' CSR."""
    n = 24
    rng = np.random.RandomState(2)
    b = rng.randn(n, n) + 1j * rng.randn(n, n)
    h = sp.csr_matrix(b @ b.conj().T / n + np.diag(np.arange(1.0, n + 1)))
    h.sort_indices()
    args = (h.indptr, h.indices, h.data, h.shape)
    return (h, lis_tpu.CSRMatrix.from_csr_arrays(*args),
            lis_tpu_torch.CSRMatrix.from_csr_arrays(*args, device="cpu"),
            rng.randn(n) + 1j * rng.randn(n))


@pytest.mark.parametrize("opts", [
    "-i cg -tol 1e-10 -f single",
    "-i cg -p jacobi -scale 2 -tol 1e-10",
], ids=["single", "scale2"])
def test_hermitian_faults_repaired(hermitian, opts):
    """-f single keeps complex operands complex (it dropped their
    imaginary part), and symmetric scaling orders a complex diagonal as
    numpy does (it raised)."""
    h, J, T, b = hermitian
    opts += " -auto_storage false"
    rj = lis_tpu.solve(J, b, options=opts)
    rt = lis_tpu_torch.solve(T, b, options=opts)
    assert rt.x.dtype == torch.complex128
    assert rt.status == lis_tpu_torch.LIS_SUCCESS and rt.true_resid <= 1e-9
    np.testing.assert_allclose(np.linalg.norm(h @ rt.x.numpy() - b)
                               / np.linalg.norm(b), rt.true_resid, rtol=1e-6)
    assert_same(rj, rt, rtol=1e-9)


@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
def test_complex_cst_matvec(grid):
    a, J, T, b = built(*grid)
    x = cvec(a.shape[0], 3)
    got = T.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, a @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(J.matvec(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    goth = T.matvech(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(goth, a.conj().T @ x, rtol=1e-12, atol=1e-12)
    # a real vector against the complex grid promotes to complex
    xr = x.real.copy()
    np.testing.assert_allclose(T.matvec(torch.from_numpy(xr)).numpy(),
                               a @ xr, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("grid", GRIDS, ids=IDS)
@pytest.mark.parametrize("mode", ["rows", "symm"])
@pytest.mark.parametrize("factor", ["real_valued", "complex"])
def test_complex_cst_scaling(grid, mode, factor):
    """A real-valued factor (a Hermitian diagonal's) scales bit-equal to
    lis_tpu.  A complex factor agrees to 2 ulp: XLA contracts the complex
    product into FMAs (re = fma(a, c, -b·d)) and torch does not."""
    a, J, T, b = built(*grid)
    n = a.shape[0]
    d = np.random.default_rng(11).uniform(0.5, 2.0, n).astype(complex)
    if factor == "complex":
        d = d + 1j * np.random.default_rng(12).uniform(-1.0, 1.0, n)
    Ts = getattr(T, f"scale_{mode}")(torch.from_numpy(d))
    Js = getattr(J, f"scale_{mode}")(jnp.asarray(d))
    for t, j in ((Ts, Js), (Ts.at, Js.at)):
        pairs = [(t.val, j.val), (t.diag, j.diag)]
        if t.rem is not None:
            pairs.append((t.rem.value, j.rem.value))
        for got, want in pairs:
            if factor == "real_valued":
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=4.5e-16, atol=0)
    D = sp.diags(d)
    ref = D @ a @ D if mode == "symm" else D @ a
    x = cvec(n, 13)
    np.testing.assert_allclose(Ts.matvec(torch.from_numpy(x)).numpy(),
                               ref @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(Ts.matvech(torch.from_numpy(x)).numpy(),
                               ref.conj().T @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("opts", [
    "-i cocg -p jacobi", "-i cocg -p none", "-i cocr -p jacobi",
    "-i cocr -p none", "-i cocg -p jacobi -f single",
    "-i cocr -p none -scale 2", "-i bicg -p jacobi -scale 1",
    "-i bicrstab -p none",
])
def test_complex_prebuilt_cst_solve(opts):
    a, J, T, b = built(*GRIDS[0])
    opts += " -storage cst -tol 1e-10"
    rj = lis_tpu.solve(J, b, options=opts)
    rt = lis_tpu_torch.solve(T, b, options=opts)
    assert rj.status == lis_tpu.LIS_SUCCESS
    assert rt.x.dtype == torch.complex128
    assert_same_complex(rj, rt)


@pytest.mark.parametrize("solver", ["cocg", "cocr"])
def test_complex_prebuilt_cst_solve_larger_grid(solver):
    a, J, T, b = built(*GRIDS[1])
    opts = f"-i {solver} -p jacobi -storage cst -tol 1e-10"
    rj = lis_tpu.solve(J, b, options=opts)
    rt = lis_tpu_torch.solve(T, b, options=opts)
    assert rj.status == lis_tpu.LIS_SUCCESS
    assert_same_complex(rj, rt)


def test_scaled_complex_grid_through_from_numpy_state():
    """lis_tpu's scaled complex grid, carried over leaf by leaf (complex
    val, diag and remainder; the scaled transpose grid), applies the same
    operator in the port."""
    a, J, T, b = built(*GRIDS[0])
    d = cvec(a.shape[0], 14)
    Js = J.scale_rows(jnp.asarray(d))
    C = from_numpy_state(*to_state(Js), device="cpu")
    assert C.val.dtype == torch.complex128 and C.at.val.dtype == C.val.dtype
    np.testing.assert_array_equal(C.at.val.numpy(), np.asarray(Js.at.val))
    x = cvec(a.shape[0], 15)
    np.testing.assert_allclose(C.matvec(torch.from_numpy(x)).numpy(),
                               np.asarray(Js.matvec(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(C.matvech(torch.from_numpy(x)).numpy(),
                               (sp.diags(d) @ a).conj().T @ x,
                               rtol=1e-12, atol=1e-12)
