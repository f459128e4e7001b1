"""lis_tpu_torch DIA, HDI and CSS against lis_tpu and scipy, on the CPU.

The same host arrays, made from a seed with numpy, go through both
packages.  Build arrays (diagonals, offsets, counts, CSS grids) must be
equal exactly: the host builds are the same code.  Products are compared
to rtol 1e-13 at double and 1e-5 at single: the port's plain versions sum
a row's terms in the order of the offsets, as lis_tpu does, so what is
left is the rounding of a fused multiply-add.  On the CPU the port runs
the plain versions of kernels E and F.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lis_tpu
from lis_tpu.matrix.css import CSSMatrix as JCSS
from lis_tpu.matrix.dia import DIAMatrix as JDIA
from lis_tpu.matrix.hybrid import HybridMatrix as JHDI
from lis_tpu.utils import testmat as jtm
import lis_tpu_torch
from lis_tpu_torch.interop.state import from_numpy_state
from lis_tpu_torch.matrix.css import CSSMatrix
from lis_tpu_torch.matrix.dia import DIAMatrix
from lis_tpu_torch.matrix.hybrid import HybridMatrix
from lis_tpu_torch.utils import testmat as ttm


def banded(n, offsets, seed, cplx=False, m=None):
    """scipy CSR with random values on ``offsets`` (n x m)."""
    rng = np.random.default_rng(seed)
    m = n if m is None else m
    diags = []
    for o in offsets:
        ln = min(n, m - o) - max(0, -o)
        d = rng.standard_normal(ln)
        if cplx:
            d = d + 1j * rng.standard_normal(ln)
        diags.append(d)
    a = sp.diags(diags, offsets, shape=(n, m)).tocsr()
    a.sort_indices()
    return a


def scipy_of(M):
    p, i, v = M.to_csr_arrays()
    return sp.csr_matrix((np.asarray(v), np.asarray(i), np.asarray(p)),
                         shape=M.shape)


MATRICES = {
    "poisson3d27": lambda: scipy_of(jtm.poisson3d27(6, 7, 8)),
    "poisson2d": lambda: scipy_of(jtm.poisson2d(31, 17)),
    "gamma": lambda: scipy_of(jtm.gamma_matrix(50)),
    "complex_banded": lambda: banded(203, (-150, -17, -1, 0, 3, 64, 202), 1,
                                     cplx=True),
    "wide": lambda: banded(97, (-60, 0, 5), 2, m=140),
    "tall": lambda: banded(140, (-60, 0, 5), 3, m=97),
}


def both(name, dtype=None):
    a = MATRICES[name]()
    if dtype is not None:
        a = a.astype(dtype)
    args = (a.indptr, a.indices, a.data, a.shape)
    return (a, JDIA.from_csr_arrays(*args),
            DIAMatrix.from_csr_arrays(*args, device="cpu"))


def vec(n, seed, cplx=False, dtype=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n)
    if cplx:
        x = x + 1j * rng.standard_normal(n)
    return x if dtype is None else x.astype(dtype)


def close(got, want, rtol):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("name", list(MATRICES))
def test_dia_build_arrays_equal(name):
    a, J, T = both(name)
    assert T.offsets == J.offsets
    assert (T.nrows, T.ncols, T.nnz) == (J.nrows, J.ncols, J.nnz)
    assert T.value.shape == (len(J.offsets), a.shape[0])
    np.testing.assert_array_equal(T.value_2d, J.value_2d)
    np.testing.assert_array_equal(T.off.numpy(), np.array(J.offsets))
    assert T.off.dtype == torch.int64 and T.device.type == "cpu"


@pytest.mark.parametrize("name", list(MATRICES))
def test_dia_to_csr_round_trip(name):
    a, J, T = both(name)
    for M in (T, T.to("cpu")):          # with and without the host cache
        p, i, v = M.to_csr_arrays()
        np.testing.assert_array_equal(p, a.indptr)
        np.testing.assert_array_equal(i, a.indices)
        np.testing.assert_array_equal(v, a.data)
    # without any cache: rebuilt from the diagonals
    U = DIAMatrix.from_diagonals(T.value, T.offsets, T.shape, T.nnz)
    assert getattr(U, "_host_csr", None) is None
    for got, want in zip(U.to_csr_arrays(), J.__class__(
            value=J.value, nrows=J.nrows, ncols=J.ncols, nnz=J.nnz,
            offsets=J.offsets).to_csr_arrays()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(MATRICES))
@pytest.mark.parametrize("kind", ["f64", "f32", "real_x_complex"])
def test_dia_matvec_matches(name, kind):
    cplx = name == "complex_banded"
    if kind == "f32":
        dtype, xdtype, rtol = (np.complex64 if cplx else np.float32,) * 2 \
            + (1e-5,)
    else:
        dtype, xdtype, rtol = None, None, 1e-13
    a, J, T = both(name, dtype)
    x = vec(a.shape[1], 5, cplx or kind == "real_x_complex", xdtype)
    close(T.matvec(torch.from_numpy(x)), J.matvec(x), rtol)
    close(T.matvec(torch.from_numpy(x)), a @ x, rtol)


@pytest.mark.parametrize("name", list(MATRICES))
@pytest.mark.parametrize("kind", ["f64", "f32", "real_x_complex"])
def test_dia_matvech_matches(name, kind):
    """Square: the shifted-stream branch (lis_tpu dia.py:136); wide and
    tall: the scatter branch (:147)."""
    cplx = name == "complex_banded"
    if kind == "f32":
        dtype, xdtype, rtol = (np.complex64 if cplx else np.float32,) * 2 \
            + (1e-5,)
    else:
        dtype, xdtype, rtol = None, None, 1e-13
    a, J, T = both(name, dtype)
    x = vec(a.shape[0], 6, cplx or kind == "real_x_complex", xdtype)
    close(T.matvech(torch.from_numpy(x)), J.matvech(x), rtol)
    close(T.matvech(torch.from_numpy(x)), a.conj().T @ x, rtol)


@pytest.mark.parametrize("name", ["poisson3d27", "gamma", "complex_banded"])
def test_dia_scaling_and_diagonal(name):
    a, J, T = both(name)
    n = a.shape[0]
    close(T.get_diagonal(), J.get_diagonal(), 0)
    d = np.random.default_rng(7).uniform(0.5, 2.0, n)
    x = vec(n, 8, name == "complex_banded")
    for op in ("scale_rows", "scale_symm"):
        Ts, Js = getattr(T, op)(torch.from_numpy(d)), getattr(J, op)(d)
        assert Ts.format_name == "dia" and Ts.offsets == T.offsets
        close(torch.from_numpy(Ts.value_2d), Js.value_2d, 1e-15)
        close(Ts.matvec(torch.from_numpy(x)), Js.matvec(x), 1e-13)
    want = sp.diags(d) @ a @ sp.diags(d)
    close(T.scale_symm(torch.from_numpy(d)).matvec(torch.from_numpy(x)),
          want @ x, 1e-13)
    # no zero offset: the diagonal is zero
    b = banded(20, (-2, 3), 9)
    Z = DIAMatrix.from_csr_arrays(b.indptr, b.indices, b.data, b.shape,
                                  device="cpu")
    assert torch.equal(Z.get_diagonal(), torch.zeros(20, dtype=torch.float64))


def test_dia_single_cast_keeps_offsets():
    """-f single casts the diagonals and leaves the int64 offsets; a
    device move keeps the host CSR cache, a cast drops it."""
    a, J, T = both("poisson2d")
    S = T.to(dtype=torch.float32)
    assert S.value.dtype == torch.float32 and S.off.dtype == torch.int64
    assert getattr(S, "_host_csr", None) is None
    assert getattr(T.to("cpu"), "_host_csr", None) is not None
    x = vec(a.shape[0], 1, dtype=np.float32)
    close(S.matvec(torch.from_numpy(x)), a.astype(np.float32) @ x, 1e-5)


def _same_csr(got, want):
    """Equal host CSR arrays: structure, dtype and values bit for bit."""
    for g, w in zip(got.to_csr_arrays(), want.to_csr_arrays()):
        assert g.dtype == w.dtype and np.array_equal(g, w)


SHIFTED = {"poisson2d": MATRICES["poisson2d"],
           "complex_banded": MATRICES["complex_banded"],
           "wide": MATRICES["wide"], "tall": MATRICES["tall"],
           "no_diagonal": lambda: banded(60, (-3, 1, 7), 4),
           "no_diagonal_complex": lambda: banded(60, (-3, 1, 7), 5,
                                                 cplx=True)}


@pytest.mark.parametrize("sigma", [0.0, 1.5, -0.25])
@pytest.mark.parametrize("name", sorted(SHIFTED))
def test_dia_shift_diagonal_on_the_device_equals_the_host_rebuild(name,
                                                                   sigma):
    """DIAMatrix.shift_diagonal subtracts σ from the offset-0 row (adding
    the row where A has none and σ ≠ 0): its CSR arrays equal those of
    the host rebuild (SparseMatrix.shift_diagonal: scipy, then a DIA from
    CSR) bit for bit, and its product is A·x − σx."""
    from lis_tpu_torch.matrix.base import SparseMatrix
    a = SHIFTED[name]()
    T = DIAMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape,
                                  device="cpu")
    got = T.shift_diagonal(sigma)
    assert isinstance(got, DIAMatrix) and got.device == T.device
    _same_csr(got, SparseMatrix.shift_diagonal(T, sigma))
    assert got.nnz == len(got.to_csr_arrays()[2])
    assert (0 in got.offsets) == (0 in T.offsets or sigma != 0)
    assert list(got.offsets) == sorted(got.offsets)
    x = vec(a.shape[1], 7, dtype=a.dtype)
    want = a @ x - sigma * np.eye(*a.shape, dtype=a.dtype) @ x
    close(got.matvec(torch.from_numpy(x)), want, 1e-13)


def test_dia_shift_diagonal_that_cancels_the_diagonal():
    """Entries that become 0 leave the CSR arrays, as in the host
    rebuild."""
    from lis_tpu_torch.matrix.base import SparseMatrix
    a = sp.diags([np.full(30, 2.0), np.ones(29)], [0, 1]).tocsr()
    T = DIAMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape,
                                  device="cpu")
    got = T.shift_diagonal(2.0)
    _same_csr(got, SparseMatrix.shift_diagonal(T, 2.0))
    assert got.nnz == 29


@pytest.mark.parametrize("alpha", [-0.7, 2.0])
@pytest.mark.parametrize("cplx", [False, True])
def test_dia_axpy_of_two_dias_equals_the_host_rebuild(alpha, cplx):
    """B.axpy(α, A) = A + αB (the generalized shift A − σB of II and RQI)
    on the union of the offsets, bit for bit as the host rebuild."""
    from lis_tpu_torch.matrix.base import SparseMatrix
    a = banded(80, (-5, -1, 0, 2), 6, cplx=cplx)
    b = banded(80, (-1, 0, 1, 9), 7, cplx=cplx)
    A, B = (DIAMatrix.from_csr_arrays(m.indptr, m.indices, m.data, m.shape,
                                      device="cpu") for m in (a, b))
    for X, Y in ((A, B), (B, A)):
        got = X.axpy(alpha, Y)
        assert isinstance(got, DIAMatrix)
        _same_csr(got, SparseMatrix.axpy(X, alpha, Y))
    x = vec(80, 8, dtype=a.dtype)
    close(B.axpy(alpha, A).matvec(torch.from_numpy(x)), (a + alpha * b) @ x,
          1e-13)


@pytest.mark.parametrize("shape", [(6, 7, 8), (2, 3, 4), (1, 5, 2),
                                   (9, 1, 1)])
def test_poisson3d27_dia_equals_converted(shape):
    """Built directly in DIA form, legs colliding on tiny grids included,
    against lis_tpu's and against the conversion of the CSR build."""
    D = ttm.poisson3d27_dia(*shape, device="cpu")
    J = jtm.poisson3d27_dia(*shape)
    C = lis_tpu_torch.convert_matrix(
        ttm.poisson3d27(*shape, device="cpu"), "dia", device="cpu")
    assert D.offsets == J.offsets and D.nnz == J.nnz == C.nnz
    np.testing.assert_array_equal(D.value_2d, J.value_2d)
    # the CSR build drops diagonals that are zero everywhere
    keep = [k for k, o in enumerate(D.offsets) if o in C.offsets]
    np.testing.assert_array_equal(D.value_2d[keep], C.value_2d)
    assert not D.value_2d[[k for k in range(len(D.offsets))
                           if k not in keep]].any()


@pytest.mark.parametrize("gen,args", [
    ("tridiag", (17,)), ("poisson2d", (5, 4)), ("poisson3d", (3, 4, 5)),
    ("poisson3d27", (3, 4, 5)), ("poisson3d_jump", (4, 4, 4)),
    ("gamma_matrix", (12,)), ("random_sparse", (40,)),
])
def test_testmat_generators_equal(gen, args):
    J = getattr(jtm, gen)(*args)
    T = getattr(ttm, gen)(*args, device="cpu")
    assert T.device.type == "cpu" and T.shape == J.shape
    for got, want in zip(T.to_csr_arrays(), J.to_csr_arrays()):
        np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("leaves", [True, False])
def test_from_numpy_state_carries_a_lis_tpu_dia(leaves):
    a, J, T = both("gamma")
    value = tuple(np.asarray(v) for v in J.value) if leaves else J.value_2d
    S = from_numpy_state("dia", {"value": value},
                         dict(nrows=J.nrows, ncols=J.ncols, nnz=J.nnz,
                              offsets=J.offsets), device="cpu")
    assert isinstance(S, DIAMatrix) and S.offsets == J.offsets
    x = vec(50, 3)
    close(S.matvec(torch.from_numpy(x)), J.matvec(x), 1e-13)


# ---- HDI ---------------------------------------------------------------------

def quasi_banded(n=400, stragglers=30, seed=0):
    """A tridiagonal matrix plus a few entries off the band."""
    rng = np.random.default_rng(seed)
    a = sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(n, n)).tolil()
    for _ in range(stragglers):
        i, j = rng.integers(0, n, 2)
        a[i, j] = rng.standard_normal()
    a = a.tocsr()
    a.sort_indices()
    return a


def test_hdi_try_split_accepts_and_matches():
    a = quasi_banded()
    args = (a.indptr, a.indices, a.data, a.shape)
    J, T = JHDI.try_split(*args), HybridMatrix.try_split(*args, device="cpu")
    assert T is not None and T.format_name == "hdi"
    assert T.dia.offsets == J.dia.offsets and T.dia.nnz == J.dia.nnz
    assert T.rem.nnz == J.rem.nnz and T.nnz == J.nnz
    np.testing.assert_array_equal(T.dia.value_2d, J.dia.value_2d)
    for got, want in zip(T.rem.to_csr_arrays(), J.rem.to_csr_arrays()):
        np.testing.assert_array_equal(got, np.asarray(want))
    x = vec(a.shape[0], 4)
    close(T.matvec(torch.from_numpy(x)), J.matvec(x), 1e-13)
    close(T.matvech(torch.from_numpy(x)), a.T @ x, 1e-13)
    close(T.get_diagonal(), a.diagonal(), 0)
    for got, want in zip(T.to_csr_arrays(), (a.indptr, a.indices, a.data)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["random", "rectangular", "empty"])
def test_hdi_try_split_rejects(case):
    if case == "random":
        a = sp.random(300, 300, density=0.03, format="csr",
                      random_state=np.random.default_rng(1))
    elif case == "rectangular":
        a = banded(50, (-1, 0, 1), 2, m=60)
    else:
        a = sp.csr_matrix((40, 40))
    a.sort_indices()
    args = (a.indptr, a.indices, a.data, a.shape)
    assert JHDI.try_split(*args) is None
    assert HybridMatrix.try_split(*args, device="cpu") is None


def test_hdi_convert_hook_always_succeeds():
    """convert_matrix(…, "hdi") on a matrix with no dense diagonal: all
    of it lands in the CSR remainder."""
    a = sp.random(120, 120, density=0.05, format="csr",
                  random_state=np.random.default_rng(2))
    a.sort_indices()
    A = lis_tpu_torch.CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data,
                                                a.shape, device="cpu")
    H = lis_tpu_torch.convert_matrix(A, "hdi", device="cpu")
    assert H.format_name == "hdi" and H.dia.nnz == 0 and H.rem.nnz == a.nnz
    x = vec(120, 5)
    close(H.matvec(torch.from_numpy(x)), a @ x, 1e-13)
    d = np.random.default_rng(3).uniform(0.5, 2, 120)
    Hs = H.scale_rows(torch.from_numpy(d))      # the base class round trip
    assert Hs.format_name == "hdi"
    close(Hs.matvec(torch.from_numpy(x)), sp.diags(d) @ a @ x, 1e-13)


# ---- CSS ---------------------------------------------------------------------

def power_law(n=3000, seed=0, cplx=False):
    """Hub columns attract most entries: some chunks overflow the cap."""
    rng = np.random.default_rng(seed)
    k = 6
    rows = np.repeat(np.arange(n), k)
    cols = np.minimum((rng.pareto(1.2, n * k) * 40).astype(np.int64), n - 1)
    vals = rng.standard_normal(n * k)
    if cplx:
        vals = vals + 1j * rng.standard_normal(n * k)
    a = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    a = (a + sp.eye(n) * 8).tocsr()
    a.sum_duplicates()
    a.sort_indices()
    return a


CSS_CASES = {
    "uniform": lambda: (sp.random(1500, 1500, density=0.004, format="csr",
                                  random_state=np.random.default_rng(4))
                        + sp.eye(1500)).tocsr(),
    "power_law": power_law,
    "power_law_complex": lambda: power_law(seed=5, cplx=True),
    "rectangular": lambda: sp.random(700, 1000, density=0.01, format="csr",
                                     random_state=np.random.default_rng(6)),
}


def css_both(name, **kw):
    a = CSS_CASES[name]().tocsr()
    a.sort_indices()
    args = (a.indptr, a.indices, a.data, a.shape)
    return (a, JCSS.from_csr_arrays(*args, **kw),
            CSSMatrix.from_csr_arrays(*args, device="cpu", **kw))


def assert_css_equal(T, J):
    assert (T.nrows, T.ncols, T.nnz, T.W) == (J.nrows, J.ncols, J.nnz, J.W)
    np.testing.assert_array_equal(T.val.numpy(), np.asarray(J.val))
    np.testing.assert_array_equal(T.lidx.numpy(), np.asarray(J.lidx))
    np.testing.assert_array_equal(T.rowf.numpy(), np.asarray(J.rowf))
    assert (T.rem is None) == (J.rem is None)
    if T.rem is not None:
        for got, want in zip(T.rem.to_csr_arrays(), J.rem.to_csr_arrays()):
            np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("name", list(CSS_CASES))
def test_css_build_arrays_equal_and_profile(name):
    a, J, T = css_both(name)
    assert_css_equal(T, J)
    assert_css_equal(T.at, J.at)
    assert T.at.at is None
    blowup, rem_frac = CSSMatrix.profile(a.indices, a.shape[1])
    assert (blowup, rem_frac) == JCSS.profile(a.indices, a.shape[1])
    assert blowup == T.fill_blowup
    assert rem_frac == (0 if T.rem is None else T.rem.nnz / a.nnz)
    for got, want in zip(T.to_csr_arrays(), (a.indptr, a.indices, a.data)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(CSS_CASES))
@pytest.mark.parametrize("transpose", [True, False])
def test_css_matvec_matches(name, transpose):
    """matvech through the transpose grid, and through the scatter
    fallback when there is none."""
    a, J, T = css_both(name, transpose=transpose)
    assert (T.at is None) == (not transpose)
    cplx = np.iscomplexobj(a.data)
    x, y = vec(a.shape[1], 1, cplx), vec(a.shape[0], 2, cplx)
    close(T.matvec(torch.from_numpy(x)), J.matvec(x), 1e-13)
    close(T.matvec(torch.from_numpy(x)), a @ x, 1e-13)
    close(T.matvech(torch.from_numpy(y)), a.conj().T @ y, 1e-13)
    if not cplx:
        z = vec(a.shape[1], 3, True)     # real matrix, complex vector
        close(T.matvec(torch.from_numpy(z)), a @ z, 1e-13)


@pytest.mark.parametrize("name", ["uniform", "power_law",
                                  "power_law_complex"])
def test_css_diagonal_and_scaling(name):
    a, J, T = css_both(name)
    n = a.shape[0]
    close(T.get_diagonal(), a.diagonal(), 1e-15)
    d = np.random.default_rng(8).uniform(0.5, 2.0, n)
    dt = torch.from_numpy(d)
    x = vec(n, 9, np.iscomplexobj(a.data))
    xt = torch.from_numpy(x)
    Tr, Ts = T.scale_rows(dt), T.scale_symm(dt)
    close(Tr.val, J.scale_rows(d).val, 1e-15)
    close(Ts.val, J.scale_symm(d).val, 1e-15)
    D = sp.diags(d)
    close(Tr.matvec(xt), D @ a @ x, 1e-13)
    close(Tr.matvech(xt), (D @ a).conj().T @ x, 1e-13)
    close(Ts.matvec(xt), D @ a @ D @ x, 1e-13)
    close(Ts.matvech(xt), (D @ a @ D).conj().T @ x, 1e-13)
    close(Ts.get_diagonal(), (D @ a @ D).diagonal(), 1e-14)


@pytest.mark.parametrize("target", ["dia", "hdi", "css"])
def test_convert_matrix_registers_the_new_formats(target):
    a = MATRICES["poisson2d"]()
    A = lis_tpu_torch.CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data,
                                                a.shape, device="cpu")
    M = lis_tpu_torch.convert_matrix(A, target, device="cpu")
    assert M.format_name == target and M.device.type == "cpu"
    x = vec(a.shape[0], 2)
    close(M.matvec(torch.from_numpy(x)), a @ x, 1e-13)
    back = lis_tpu_torch.convert_matrix(M, "csr", device="cpu")
    for got, want in zip(back.to_csr_arrays(), (a.indptr, a.indices, a.data)):
        np.testing.assert_array_equal(got, want)
