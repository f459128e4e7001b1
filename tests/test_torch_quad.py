"""lis_tpu_torch's double-double path ("-f quad" and friends) against
lis_tpu's, on the CPU.

The same inputs, made from a numpy seed, go through both packages:

- the error-free transforms, the DD arithmetic, the BLAS-1 (axpy, xpay,
  dot, nrm2, nrm1) and both DD matvecs (DIA and the ELL pair, each way):
  hi and lo bit-equal, in f64 and in f32 limbs ("df").  On the CPU the
  port runs the plain versions of kernels M-P;
- the 17 _quad twins on poisson2d(8, 8) at -tol 1e-14: lis_tpu's status
  and iteration count, x to 1e-13 relative;
- test5 (gamma_matrix(200, 2.0)): quad BiCG converges in lis_tpu's count
  where double ends MAXITER, in both packages;
- -f switch, df and switch_df as tests/test_quad.py runs them.  Their
  first phase (switch, switch_df) is a double or single solve, whose dot
  products sum in another order in each package (tests/test_torch_solve.py
  holds those to rtol 1e-9), so the counts may differ by a few there;
- the refusals (complex operands, a solver with no twin), the masked
  check interval, and -storage cst on n = 2^12 (the CST operator taken as
  the ELL pair).

lis_tpu's quad path is exact on the CPU only with XLA's fusion pass off,
which tests/conftest.py sets for every test.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import lis_tpu
import lis_tpu_torch
from lis_tpu.core import ddreal as J
from lis_tpu.utils import testmat as tmj
from lis_tpu_torch.core import ddreal as T
from lis_tpu_torch.solvers.base import SOLVER_FNS, SolverSpec
from lis_tpu_torch.utils import testmat as tmt
from tests.test_torch_cst import spd

TWINS = ["cg", "cr", "bicg", "cgs", "bicgstab", "bicr", "crs", "bicrstab",
         "gpbicg", "gpbicr", "bicgsafe", "bicrsafe", "tfqmr", "orthomin",
         "bicgstabl", "gmres", "fgmres"]
LIMBS = {"f64": np.float64, "f32": np.float32}


def _pairs(dt, n=1001, seed=0):
    """Two DD arrays and a DD scalar as numpy (hi, lo) pairs: an odd n,
    some zeros and signs, lo about an ulp of hi."""
    rng = np.random.default_rng(seed)
    eps = np.finfo(dt).eps
    out = []
    for _ in range(3):
        hi = rng.standard_normal(n).astype(dt)
        hi[::97] = 0.0
        lo = (hi * rng.uniform(-0.5, 0.5, n) * eps).astype(dt)
        out.append((hi, lo))
    return out[0], out[1], (out[2][0][:1].reshape(()), out[2][1][:1]
                            .reshape(()))


def _lift(mod, pair):
    if mod is J:
        return J.DD(jnp.asarray(pair[0]), jnp.asarray(pair[1]))
    return T.DD(torch.from_numpy(np.array(pair[0])),
                torch.from_numpy(np.array(pair[1])))


def _host(v):
    return np.asarray(v) if not isinstance(v, torch.Tensor) else v.numpy()


OPS = {
    "two_sum": lambda m, x, y, s: m.two_sum(x.hi, y.hi),
    "two_prod": lambda m, x, y, s: m.two_prod(x.hi, y.hi),
    "add": lambda m, x, y, s: m.add(x, y),
    "mul": lambda m, x, y, s: m.mul(x, y),
    "div": lambda m, x, y, s: m.div(x, m.add(y, m.DD(y.hi * 0 + 3,
                                                     y.lo * 0))),
    "sqrt": lambda m, x, y, s: m.sqrt(m.mul(x, x)),
    "axpy": lambda m, x, y, s: m.axpy(s, x, y),
    "xpay": lambda m, x, y, s: m.xpay(x, s, y),
    "dot": lambda m, x, y, s: m.dot(x, y),
    "nrm2": lambda m, x, y, s: m.nrm2(x),
    "nrm1": lambda m, x, y, s: m.nrm1(x),
}


@pytest.mark.parametrize("limb", list(LIMBS))
@pytest.mark.parametrize("op", list(OPS))
def test_dd_arithmetic_bit_equal(op, limb):
    xs, ys, ss = _pairs(LIMBS[limb])
    got, want = (OPS[op](m, _lift(m, xs), _lift(m, ys), _lift(m, ss))
                 for m in (T, J))
    for g, w in zip(got, want):
        assert str(g.dtype)[6:] == str(np.asarray(w).dtype)
        np.testing.assert_array_equal(_host(g), np.asarray(w))


def _nonsym(fmt, n=60, seed=3):
    """A nonsymmetric matrix as scipy CSR with sorted columns: five random
    diagonals (offsets -7 to 4) for DIA, random scatter for the ELL pair."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    if fmt == "dia":
        offs = [-7, -2, 0, 1, 4]
        a = sp.diags([rng.standard_normal(n - abs(o)) for o in offs], offs)
    else:
        a = sp.random(n, n, density=0.15, random_state=seed, format="csr")
    a = (a + sp.eye(n) * 4).tocsr()
    a.sort_indices()
    return a


@pytest.mark.parametrize("direction", ["matvec", "matvech"])
@pytest.mark.parametrize("limb", list(LIMBS))
@pytest.mark.parametrize("fmt", ["dia", "csr"])
def test_dd_matvec_bit_equal(fmt, limb, direction):
    """DDDiaOperator (kernel M's plain version) and the ELL pair (N's),
    the values in f64 or split into f32 limbs."""
    from lis_tpu.matrix.convert import convert_matrix as jconvert
    from lis_tpu_torch.matrix.convert import convert_matrix as tconvert
    a = _nonsym(fmt)
    args = (a.indptr, a.indices, a.data, a.shape)
    Aj = jconvert(lis_tpu.CSRMatrix.from_csr_arrays(*args), fmt)
    At = tconvert(lis_tpu_torch.CSRMatrix.from_csr_arrays(*args,
                                                          device="cpu"),
                  fmt, device="cpu")
    assert At.format_name == fmt
    dt = LIMBS[limb]
    Oj = J.make_dd_operator(Aj, None if dt == np.float64 else jnp.float32)
    Ot = T.make_dd_operator(At, None if dt == np.float64 else torch.float32)
    assert type(Ot).__name__ == type(Oj).__name__
    xs = _pairs(dt, n=a.shape[0], seed=4)[0]
    xs[0][5] = 0.0
    got = getattr(Ot, direction)(_lift(T, xs))
    want = getattr(Oj, direction)(_lift(J, xs))
    np.testing.assert_array_equal(got.hi.numpy(), np.asarray(want.hi))
    np.testing.assert_array_equal(got.lo.numpy(), np.asarray(want.lo))


def _assert_same(rj, rt, xtol):
    assert rt.status == rj.status
    assert rt.iters == rj.iters
    xj = np.asarray(rj.x)
    assert rt.x.dtype == torch.float64
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=xtol,
                               atol=xtol * np.abs(xj).max())


_P2 = {}


def _poisson2d():
    if not _P2:
        _P2["j"] = tmj.poisson2d(8, 8)
        _P2["t"] = tmt.poisson2d(8, 8, device="cpu")
    return _P2["j"], _P2["t"]


@pytest.mark.parametrize("name", TWINS)
def test_quad_twin_matches_lis_tpu(name):
    """Every _quad twin on poisson2d(8, 8), b = 1, -tol 1e-14 (default
    routing: DIA, kernel M's plain version): lis_tpu's status and count,
    x to 1e-13 relative."""
    Aj, At = _poisson2d()
    b = np.ones(64)
    opts = f"-i {name} -f quad -tol 1e-14 -maxiter 500"
    rj = lis_tpu.solve(Aj, b, options=opts)
    rt = lis_tpu_torch.solve(At, b, options=opts)
    assert rj.status == lis_tpu.LIS_SUCCESS
    _assert_same(rj, rt, 1e-13)
    assert f"{name}_quad" in SOLVER_FNS


def test_all_17_twins_registered():
    import lis_tpu.solvers.quad_ext  # noqa: F401  (registers lis_tpu's)
    from lis_tpu.solvers.base import SOLVER_FNS as JFNS
    twins = sorted(k for k in SOLVER_FNS if k.endswith("_quad"))
    assert twins == sorted(k for k in JFNS if k.endswith("_quad"))
    assert len(twins) == 17


def test_test5_quad_converges_where_double_stalls():
    """The reference's test5 200 2.0: double BiCG ends MAXITER, quad
    SUCCESS, in both packages and in one count."""
    g = tmj.gamma_matrix(200, 2.0)
    gt = tmt.gamma_matrix(200, 2.0, device="cpu")
    b = np.asarray(g.to_dense() @ np.ones(200))
    for f, status in (("double", lis_tpu.LIS_MAXITER),
                      ("quad", lis_tpu.LIS_SUCCESS)):
        opts = f"-i bicg -f {f} -tol 1e-12 -maxiter 500"
        rj, rt = lis_tpu.solve(g, b, options=opts), \
            lis_tpu_torch.solve(gt, b, options=opts)
        assert rj.status == rt.status == status
        assert rt.iters == rj.iters
    _assert_same(rj, rt, 1e-13)
    assert np.linalg.norm(rt.x.numpy() - 1.0) / np.sqrt(200) < 1e-10


def test_switch_variant():
    """tests/test_quad.py::test_switch_variant in both packages: a double
    BiCG phase to 1e-10, then quad from its x."""
    g = tmj.gamma_matrix(120, 2.0)
    gt = tmt.gamma_matrix(120, 2.0, device="cpu")
    b = np.asarray(g.to_dense() @ np.ones(120))
    opts = ("-i bicg -f switch -switch_maxiter 300 -switch_tol 1e-10 "
            "-tol 1e-12 -maxiter 1000")
    rj, rt = lis_tpu.solve(g, b, options=opts), \
        lis_tpu_torch.solve(gt, b, options=opts)
    assert rj.status == rt.status == lis_tpu.LIS_SUCCESS
    assert abs(rt.iters - rj.iters) <= 4
    assert np.linalg.norm(rt.x.numpy() - 1.0) / np.sqrt(120) < 1e-10


@pytest.fixture(scope="module")
def poisson20():
    a = tmj.poisson2d(20, 20)
    xs = np.linspace(1, 2, 400)
    return a, tmt.poisson2d(20, 20, device="cpu"), \
        np.asarray(a.to_dense() @ xs), xs


def test_df_matches_double_accuracy(poisson20):
    """tests/test_quad.py::test_df_matches_double_accuracy in both
    packages: f32 limbs, the operator and b as f32 pairs; lis_tpu's count
    and x exactly."""
    Aj, At, b, xs = poisson20
    rd = lis_tpu_torch.solve(At, b, options="-i cg -f double -tol 1e-10")
    rj = lis_tpu.solve(Aj, b, options="-i cg -f df -tol 1e-10")
    rt = lis_tpu_torch.solve(At, b, options="-i cg -f df -tol 1e-10")
    _assert_same(rj, rt, 0.0)
    ed = np.abs(rd.x.numpy() - xs).max()
    assert np.abs(rt.x.numpy() - xs).max() < 10 * max(ed, 1e-12)


def test_switch_df(poisson20):
    """tests/test_quad.py::test_single_and_switch_df's switch_df in both
    packages: an f32 phase to 1e-6, then f32 pairs."""
    Aj, At, b, xs = poisson20
    opts = "-i cg -f switch_df -tol 1e-10"
    rj, rt = lis_tpu.solve(Aj, b, options=opts), \
        lis_tpu_torch.solve(At, b, options=opts)
    assert rj.status == rt.status == lis_tpu.LIS_SUCCESS
    assert abs(rt.iters - rj.iters) <= 2
    assert np.abs(rt.x.numpy() - xs).max() < 1e-9


@pytest.mark.parametrize("opts", ["-f quad -p jacobi -conv_cond nrm2_b",
                                  "-f df -p ssor -conv_cond nrm1_b "
                                  "-tol_w 0"])
def test_quad_with_precon_and_conv_cond(poisson20, opts):
    """The preconditioner on each limb and the other residual norms."""
    Aj, At, b, _ = poisson20
    o = f"-i bicgstab {opts} -tol 1e-10"
    _assert_same(lis_tpu.solve(Aj, b, options=o),
                 lis_tpu_torch.solve(At, b, options=o), 0.0)


def test_complex_operands_refused():
    A = tmt.poisson2d(4, 4, device="cpu")
    b = np.ones(16) * (1 + 1j)
    for f in ("quad", "switch", "df", "switch_df"):
        with pytest.raises(NotImplementedError, match="real-only"):
            lis_tpu_torch.solve(A.to(dtype=torch.complex128), b,
                                options=f"-i cg -f {f}")


@pytest.mark.parametrize("solver", ["idrs", "idr1", "minres"])
def test_solver_without_twin_refused(solver):
    A = tmt.poisson2d(4, 4, device="cpu")
    with pytest.raises(NotImplementedError, match="no quad variant"):
        lis_tpu_torch.solve(A, np.ones(16), options=f"-i {solver} -f quad")
    with pytest.raises(NotImplementedError, match="no quad variant"):
        lis_tpu.solve(tmj.poisson2d(4, 4), np.ones(16),
                      options=f"-i {solver} -f quad")


def test_cg_quad_check_every_8_matches_1():
    """The masked merge of krylov_loop on DD state: the host reads the
    loop condition every 8 steps, and the state that left the loop stays
    as it was, limb by limb."""
    from lis_tpu_torch.core.ddreal import make_dd_operator
    from lis_tpu_torch.precon.base import NonePrecon
    At = tmt.poisson2d(20, 20, device="cpu")
    D = make_dd_operator(lis_tpu_torch.transform_operator(
        At, lis_tpu_torch.SolverOptions.from_string("-f quad")))
    b = torch.linspace(1, 2, 400, dtype=torch.float64)
    spec = SolverSpec(solver="cg_quad", tol=1e-12, maxiter=300)
    outs = [SOLVER_FNS["cg_quad"](D, b, torch.zeros_like(b), NonePrecon(),
                                  spec._replace(check_every=k))
            for k in (1, 8)]
    assert int(outs[0].iters) == int(outs[1].iters)
    assert int(outs[0].iters) % 8 != 0
    assert torch.equal(outs[0].x, outs[1].x)
    assert torch.equal(outs[0].rhistory.nan_to_num(-1),
                       outs[1].rhistory.nan_to_num(-1))


@pytest.mark.parametrize("f", ["quad", "switch_df"])
def test_cst_operator_as_ell_pair(f):
    """-storage cst on n = 2^12 with -f quad and -f switch_df (these were
    the port's "not ported" pins): the CST operator becomes the ELL pair
    of its CSR arrays in both packages (kernel N's plain version)."""
    a = spd(1 << 12, 5)
    args = (a.indptr, a.indices, a.data, a.shape)
    b = np.random.default_rng(7).standard_normal(1 << 12)
    opts = f"-i cg -storage cst -f {f} -tol 1e-10"
    rj = lis_tpu.solve(lis_tpu.CSRMatrix.from_csr_arrays(*args), b,
                       options=opts)
    rt = lis_tpu_torch.solve(lis_tpu_torch.CSRMatrix.from_csr_arrays(
        *args, device="cpu"), b, options=opts)
    assert rj.status == rt.status == lis_tpu.LIS_SUCCESS
    if f == "quad":
        _assert_same(rj, rt, 0.0)
    else:
        assert abs(rt.iters - rj.iters) <= 2
        np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x),
                                   rtol=1e-9)
