"""BES and multi-BES in both packages, on the CPU: the host build (W, c0,
the stride, the slab and the CSR remainder array for array), the plain
versions of kernels Q and R (matvec, matvech), the diagonal and both
scalings on the device to rtol 1e-13, routed solves (status, count, x to
rtol 1e-9), the double-double operators, the SA-AMG prolongators, and
the two faults of lis_tpu that the port does not copy:

- lis_tpu's BES matvec casts x to the slab's type, so a complex x on a
  real slab loses its imaginary part; the port promotes (held to scipy);
- lis_tpu gives BES its f64 accumulation under ``-f quad`` (f64 limbs),
  which is a plain f64 matvec; the port takes the ELL pair there, so
  ``-f quad`` on a BES route equals ``-f quad -storage csr``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lis_tpu
from lis_tpu.core import ddreal as jdd
from lis_tpu.matrix.bes import BESMatrix as JBES
from lis_tpu.matrix.bes import multi_bes_from_csr as jmulti
from lis_tpu.precon import saamg as js
import lis_tpu_torch
from lis_tpu_torch.core import ddreal as tdd
from lis_tpu_torch.interop.state import from_numpy_state
from lis_tpu_torch.matrix import bes as tb
from lis_tpu_torch.precon import saamg as ts
from lis_tpu_torch.runtime.options import SolverOptions as TOptions
from lis_tpu_torch.solvers import driver as tdrv
from tests.test_torch_route import windowed
from tests.test_torch_solve import assert_same


def _canon(a):
    a = sp.csr_matrix(a)
    a.sum_duplicates()
    a.sort_indices()
    return a


def with_far(n=3000, seed=3):
    """windowed(n, 50) plus 2 % of entries far from the diagonal: a BES
    with a CSR remainder."""
    rng = np.random.default_rng(seed)
    a = windowed(n, 50, seed=seed, symmetric=False)
    k = n // 50
    far = sp.coo_matrix((rng.standard_normal(k),
                         (rng.integers(0, n, k), rng.integers(0, n, k))),
                        shape=(n, n))
    return _canon(a + far)


def prolongator(nf=3000, nc=300, seed=4):
    """A rectangular operator whose columns track the rows at slope
    nc/nf: two entries a row, near column i·nc/nf (a strided BES)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(nf), 2)
    cols = np.minimum(rows * nc // nf + np.tile([0, 1], nf), nc - 1)
    return _canon(sp.coo_matrix((rng.uniform(0.5, 1, 2 * nf), (rows, cols)),
                                shape=(nf, nc)))


def stencil7(g, seed=5):
    """The 7-point stencil of a g³ lattice with random symmetric weights,
    the ±g² bands jittered by up to 2 columns: three affine bands, which
    windows of at most 2g² columns cover as a multi-BES."""
    rng = np.random.default_rng(seed)
    n = g ** 3
    rows, cols = [], []
    for off in (1, g, g * g):
        i = np.arange(n - off - 2)
        j = i + off + (rng.integers(0, 3, len(i)) if off == g * g else 0)
        rows.append(i)
        cols.append(j)
    r, c = np.concatenate(rows), np.concatenate(cols)
    v = -rng.uniform(0.5, 1.0, len(r))
    a = sp.coo_matrix((v, (r, c)), shape=(n, n))
    return _canon(a + a.T + sp.eye(n) * 8)


def cplx(a, seed=6):
    rng = np.random.default_rng(seed)
    b = a.copy().astype(np.complex128)
    b.data = b.data + 1j * rng.standard_normal(len(b.data))
    return b


CASES = {
    "band": (lambda: windowed(4000, 30), {}),
    "band_nonsym": (lambda: windowed(3000, 50, symmetric=False), {}),
    "complex": (lambda: cplx(windowed(2000, 30)), {}),
    "remainder": (with_far, {}),
    "strided": (prolongator, {}),
    "explicit_W": (lambda: windowed(2000, 30), {"W": 384}),
    "budget": (lambda: windowed(2000, 100), {"max_bytes": 1 << 20}),
}


def built(name):
    a = CASES[name][0]()
    kw = CASES[name][1]
    args = (a.indptr, a.indices, a.data, a.shape)
    return (a, JBES.from_csr_arrays(*args, **kw),
            tb.BESMatrix.from_csr_arrays(*args, device="cpu", **kw))


def _same_rem(Tr, Jr):
    assert (Tr is None) == (Jr is None)
    if Tr is not None:
        for u, w in zip(Tr.to_csr_arrays(), Jr.to_csr_arrays()):
            np.testing.assert_array_equal(u, np.asarray(w))
        assert Tr.nnz == Jr.nnz


def _same_bes(T, J):
    assert (T.W, T.c0, T.s, T.R, T.nnz, T.shape) == \
        (J.W, J.c0, J.s, J.R, J.nnz, J.shape)
    np.testing.assert_array_equal(T.slab.numpy(), np.asarray(J.slab))


def _close(got, want, rtol=1e-13):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1.0))


def _vec(n, complex_=False, seed=1):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    return v + 1j * rng.standard_normal(n) if complex_ else v


@pytest.mark.parametrize("name", list(CASES))
def test_bes_arrays_match_lis_tpu(name):
    a, J, T = built(name)
    assert T.format_name == "bes" and T.slab.device.type == "cpu"
    _same_bes(T, J)
    _same_rem(T.rem, J.rem)
    assert T.fill_blowup == J.fill_blowup
    # the round trip gives the canonical CSR of the input
    for u, w in zip(T.to_csr_arrays(), (a.indptr, a.indices, a.data)):
        np.testing.assert_array_equal(u, w)


PRODUCTS = [(name, False) for name in CASES] + [("complex", True)]


@pytest.mark.parametrize("name,vec_complex", PRODUCTS,
                         ids=[f"{n}-{'c' if c else 'r'}" for n, c in PRODUCTS])
def test_bes_products_match_lis_tpu(name, vec_complex):
    """matvec and matvech (Q's and R's plain versions), the diagonal and
    both scalings, to rtol 1e-13; a complex vector only on a complex slab,
    where lis_tpu computes it right (a real slab:
    test_complex_x_on_a_real_slab_matches_scipy)."""
    a, J, T = built(name)
    n, m = a.shape
    x, y = _vec(m, vec_complex, 1), _vec(n, vec_complex, 2)
    _close(T.matvec(torch.from_numpy(x)), J.matvec(jnp.asarray(x)))
    _close(T.matvech(torch.from_numpy(y)), J.matvech(jnp.asarray(y)))
    _close(T.matvec(torch.from_numpy(x)), a @ x)
    _close(T.matvech(torch.from_numpy(y)), a.conj().T @ y)
    if n != m:
        return
    d = T.get_diagonal()
    assert d.device.type == "cpu"
    np.testing.assert_array_equal(d.numpy(), np.asarray(J.get_diagonal()))
    s = np.abs(_vec(n, False, 3)) + 0.5
    for meth in ("scale_rows", "scale_symm"):
        Ts = getattr(T, meth)(torch.from_numpy(s))
        Js = getattr(J, meth)(jnp.asarray(s))
        assert Ts.format_name == "bes"
        np.testing.assert_allclose(Ts.slab.numpy(), np.asarray(Js.slab),
                                   rtol=1e-15)
        _close(Ts.matvec(torch.from_numpy(x)), Js.matvec(jnp.asarray(x)))


def test_complex_x_on_a_real_slab_matches_scipy():
    """A real BES times a complex x: the port promotes x and matches scipy;
    lis_tpu casts x to the slab's float64 and is off by O(1) (bes.py:185,
    the fault this pins)."""
    rng = np.random.default_rng(0)
    n = 1000
    rows = np.repeat(np.arange(n), 6)
    cols = np.clip(rows + rng.integers(-40, 41, 6 * n), 0, n - 1)
    a = _canon(sp.coo_matrix((rng.standard_normal(6 * n), (rows, cols)),
                             shape=(n, n)) + 30 * sp.eye(n))
    args = (a.indptr, a.indices, a.data, a.shape)
    J = JBES.from_csr_arrays(*args)
    T = tb.BESMatrix.from_csr_arrays(*args, device="cpu")
    x = _vec(n, True, 7)
    want = a @ x
    got = T.matvec(torch.from_numpy(x))
    assert got.dtype == torch.complex128
    _close(got, want)
    _close(T.matvech(torch.from_numpy(x)), a.T @ x)
    yj = np.asarray(J.matvec(jnp.asarray(x)))
    assert np.linalg.norm(yj - want) > 0.5 * np.linalg.norm(want)


def test_routed_complex_b_solve_matches_csr():
    """A complex b on the real bes_small system, BiCGSTAB + Jacobi with no
    -storage: the port routes to BES and gives lis_tpu's -storage csr
    answer; lis_tpu's own routed solve ends MAXITER (the fault above)."""
    a = windowed(4000, 30)
    args = (a.indptr, a.indices, a.data, a.shape)
    J = lis_tpu.CSRMatrix.from_csr_arrays(*args)
    T = lis_tpu_torch.CSRMatrix.from_csr_arrays(*args, device="cpu")
    b = _vec(4000, True, 8)
    opts = "-i bicgstab -p jacobi -tol 1e-10"
    assert tdrv.transform_operator(T, TOptions.from_string(opts)) \
        .format_name == "bes"
    rj = lis_tpu.solve(J, b, options=opts + " -storage csr")
    rt = lis_tpu_torch.solve(T, b, options=opts)
    assert rt.status == lis_tpu.LIS_SUCCESS and rt.true_resid <= 1e-9
    assert_same(rj, rt, rtol=1e-9)
    assert lis_tpu.solve(J, b, options=opts).status == lis_tpu.LIS_MAXITER


# ---- multi-BES ------------------------------------------------------------------

MULTI = {
    "stencil7": (lambda: stencil7(16), {"w_max": 256}),
    "prolongator": (lambda: prolongator(6000, 400), {}),
    "windows12": (lambda: stencil7(16), {"max_windows": 12, "w_max": 128,
                                         "max_bytes": 2 << 30}),
    "budget": (lambda: stencil7(16), {"max_bytes": 3 << 20}),
}


def multi_built(name):
    a = MULTI[name][0]()
    kw = MULTI[name][1]
    args = (a.indptr, a.indices, a.data, a.shape)
    return a, jmulti(*args, **kw), tb.multi_bes_from_csr(*args,
                                                         device="cpu", **kw)


@pytest.mark.parametrize("name", list(MULTI))
def test_multi_bes_matches_lis_tpu(name):
    a, J, T = multi_built(name)
    assert T.format_name == J.format_name
    assert T.nnz == J.nnz and T.fill_blowup == J.fill_blowup
    Tparts = getattr(T, "parts", (T,))
    Jparts = getattr(J, "parts", (J,))
    assert len(Tparts) == len(Jparts)
    for tp, jp in zip(Tparts, Jparts):
        if T.format_name == "mbes":
            assert tp.rem is None and jp.rem is None
        _same_bes(tp, jp)
    _same_rem(T.rem, J.rem)
    for u, w in zip(T.to_csr_arrays(), (a.indptr, a.indices, a.data)):
        np.testing.assert_array_equal(u, w)
    x, y = _vec(a.shape[1], False, 1), _vec(a.shape[0], False, 2)
    _close(T.matvec(torch.from_numpy(x)), J.matvec(jnp.asarray(x)))
    _close(T.matvech(torch.from_numpy(y)), J.matvech(jnp.asarray(y)))
    if a.shape[0] == a.shape[1]:
        _close(T.get_diagonal(), J.get_diagonal())
        s = np.abs(_vec(a.shape[0], False, 3)) + 0.5
        for meth in ("scale_rows", "scale_symm"):
            _close(getattr(T, meth)(torch.from_numpy(s)).matvec(
                torch.from_numpy(x)),
                getattr(J, meth)(jnp.asarray(s)).matvec(jnp.asarray(x)))


def test_state_rebuilds_bes_and_multi_bes_from_lis_tpu_leaves():
    def csr_state(C):
        return None if C is None else (
            "csr", {k: np.asarray(getattr(C, k))
                    for k in ("ptr", "index", "value", "row_ids")},
            {"nrows": C.nrows, "ncols": C.ncols, "nnz": C.nnz})

    def bes_state(B):
        return ("bes", {"slab": np.asarray(B.slab), "rem": csr_state(B.rem)},
                {k: getattr(B, k) for k in ("nrows", "ncols", "nnz", "R",
                                            "W", "c0", "stride")})
    _, J, T = built("remainder")
    S = from_numpy_state(*bes_state(J), device="cpu")
    x = _vec(J.ncols, False, 1)
    _close(S.matvec(torch.from_numpy(x)), J.matvec(jnp.asarray(x)))
    a, J, T = multi_built("stencil7")
    parts = [bes_state(p) for p in J.parts]
    M = from_numpy_state("mbes", {"parts": parts, "rem": csr_state(J.rem)},
                         {"nrows": J.nrows, "ncols": J.ncols, "nnz": J.nnz},
                         device="cpu")
    assert M.format_name == "mbes" and len(M.parts) == len(J.parts)
    y = _vec(J.nrows, False, 2)
    _close(M.matvech(torch.from_numpy(y)), J.matvech(jnp.asarray(y)))


def test_nothing_covers_and_other_errors_surface(monkeypatch):
    """The builder raises NothingCovers for an empty matrix, and the router
    catches that alone: any other failure of the candidate surfaces."""
    with pytest.raises(tb.NothingCovers):
        tb.multi_bes_from_csr(np.zeros(5, np.int32), np.zeros(0, np.int32),
                              np.zeros(0), (4, 4), device="cpu")
    assert tdrv._bes_candidate(np.zeros(5, np.int32), np.zeros(0, np.int32),
                               np.zeros(0), (4, 4)) == (None, 0.0)

    def broken(*a, **k):
        raise MemoryError("slab")
    monkeypatch.setattr(tb, "multi_bes_from_csr", broken)
    a = windowed(4000, 30)
    T = lis_tpu_torch.CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data,
                                                a.shape, device="cpu")
    with pytest.raises(MemoryError):
        tdrv.auto_storage(T)


# ---- double-double --------------------------------------------------------------

def _routed_pair(a):
    args = (a.indptr, a.indices, a.data, a.shape)
    return (lis_tpu.CSRMatrix.from_csr_arrays(*args),
            lis_tpu_torch.CSRMatrix.from_csr_arrays(*args, device="cpu"))


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_df_on_the_bes_route_matches_lis_tpu(solver):
    """-f df on a BES route: f64 accumulation through the slab, split into
    f32 limbs (lis_tpu's DDBesOperator), lis_tpu's status, count and x."""
    a = windowed(4000, 30)
    J, T = _routed_pair(a)
    b = _vec(4000, False, 9)
    opts = f"-i {solver} -p jacobi -f df -tol 1e-12"
    rj = lis_tpu.solve(J, b, options=opts)
    rt = lis_tpu_torch.solve(T, b, options=opts)
    assert rt.status == rj.status == lis_tpu.LIS_SUCCESS
    assert rt.iters == rj.iters
    _close(rt.x, rj.x, 1e-9)


@pytest.mark.parametrize("solver", ["cg", "bicgstab"])
def test_quad_on_the_bes_route_equals_quad_on_csr(solver):
    """-f quad on a BES route takes the ELL pair (full double-double): it
    equals lis_tpu's -f quad -storage csr in status, count and x to
    1e-12, where lis_tpu's own routed run accumulates in f64 only."""
    a = windowed(4000, 30)
    J, T = _routed_pair(a)
    b = _vec(4000, False, 10)
    opts = f"-i {solver} -p jacobi -f quad -tol 1e-12"
    A_dd = tdd.make_dd_operator(tdrv.transform_operator(
        T, TOptions.from_string(opts)))
    assert isinstance(A_dd, tdd.DDOperator)
    rj = lis_tpu.solve(J, b, options=opts + " -storage csr")
    rt = lis_tpu_torch.solve(T, b, options=opts)
    assert rt.status == rj.status == lis_tpu.LIS_SUCCESS
    assert rt.iters == rj.iters
    _close(rt.x, rj.x, 1e-12)


def test_lis_tpu_quad_bes_operator_drops_the_low_limb():
    """The fault this port does not copy: lis_tpu's DDBesOperator under
    f64 limbs returns a low limb of exactly 0, where the ELL pair's
    double-double product has one; the port's make_dd_operator gives BES
    the ELL pair under f64 limbs, its own slab path only under f32."""
    _, J, T = built("band")
    x = _vec(J.ncols, False, 11)
    yj = jdd.make_dd_operator(J).matvec(jdd.dd(jnp.asarray(x)))
    assert not np.asarray(yj.lo).any()
    yt = tdd.make_dd_operator(T).matvec(tdd.DD(torch.from_numpy(x),
                                               torch.zeros(J.ncols,
                                                           dtype=torch.float64)))
    assert yt.lo.abs().max() > 0
    assert isinstance(tdd.make_dd_operator(T, limb=torch.float32),
                      tdd.DDF64Operator)


@pytest.mark.parametrize("name", ["band", "remainder", "multi"])
def test_f32_limb_operator_matches_lis_tpu(name):
    """The f32-limb operator of a BES (lis_tpu DDBesOperator) and of a
    multi-BES (DDF64Operator): matvec and matvech bit for bit."""
    if name == "multi":
        _, J, T = multi_built("stencil7")
    else:
        _, J, T = built(name)
    f32 = torch.float32
    Oj = jdd.make_dd_operator(J, limb=jnp.float32)
    Ot = tdd.make_dd_operator(T, limb=f32)
    rng = np.random.default_rng(12)
    hi = rng.standard_normal(J.ncols).astype(np.float32)
    lo = (rng.standard_normal(J.ncols) * 1e-8).astype(np.float32)
    for meth in ("matvec", "matvech"):
        yj = getattr(Oj, meth)(jdd.DD(jnp.asarray(hi), jnp.asarray(lo)))
        yt = getattr(Ot, meth)(tdd.DD(torch.from_numpy(hi),
                                      torch.from_numpy(lo)))
        assert yt.hi.dtype == f32
        got = yt.hi.double() + yt.lo.double()
        want = np.asarray(yj.hi, np.float64) + np.asarray(yj.lo, np.float64)
        _close(got, want, 1e-14)


# ---- SA-AMG graph path ------------------------------------------------------------

def test_saamg_graph_prolongators_are_multi_bes_as_in_lis_tpu():
    """The graph path's prolongators take lis_tpu's multi-BES rule; psolve
    and psolveh equal lis_tpu's to rtol 1e-12."""
    from tests.test_torch_precon import _scipy
    a = _scipy("poisson3d27", 12, 12, 12)
    J, T = _routed_pair(a)
    opts = "-saamg_lattice false"
    Mj = js.create_saamg(J, lis_tpu.SolverOptions.from_string(opts))
    Mt = ts.create_saamg(T, TOptions.from_string(opts))
    assert len(Mt.levels) == len(Mj.levels)
    fmts = [lv.P.format_name for lv in Mt.levels]
    assert fmts == [getattr(lv.P, "format_name", "csr") for lv in Mj.levels]
    assert any(f in ("bes", "mbes") for f in fmts)
    r = _vec(a.shape[0], False, 13)
    for meth in ("psolve", "psolveh"):
        zj = np.asarray(jax.jit(lambda M, v: getattr(M, meth)(v))(
            Mj, jnp.asarray(r)))
        _close(getattr(Mt, meth)(torch.from_numpy(r)), zj, 1e-12)
