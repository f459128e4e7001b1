"""The library's default path in both packages, on the CPU: a matrix file
or generator, default options (no ``-storage``, so ``auto_storage`` routes
a banded system to DIA), Jacobi, the Krylov loop, the report.

Solves must agree in status and iteration count, x to rtol 1e-9 at double
(1e-4 at single) and the residual history to rtol 1e-6: both packages sum
a DIA row in the order of the offsets, so what differs is the order of the
dot products' partial sums.  Files written by one package are read by the
other with equal entries and vectors (17 significant digits round-trip a
double exactly).  On the CPU the port runs the plain versions of kernels
E, F and G.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lis_tpu
import lis_tpu.cli.hpcg as jhpcg
import lis_tpu.cli.lsolve as jlsolve
from lis_tpu.utils import testmat as jtm
import lis_tpu_torch
import lis_tpu_torch.cli.hpcg as thpcg
import lis_tpu_torch.cli.lsolve as tlsolve
from lis_tpu_torch.precon.base import NonePrecon
from lis_tpu_torch.precon.jacobi import create_jacobi
from lis_tpu_torch.solvers import cg as tcg
from lis_tpu_torch.solvers.base import (SolverSpec, init_residual,
                                        new_rhistory)
from lis_tpu_torch.solvers.driver import transform_operator
from lis_tpu_torch.utils import testmat as ttm


def csym_banded(n=300, seed=0):
    """Complex-symmetric (not Hermitian), banded, diagonally dominant."""
    rng = np.random.default_rng(seed)
    offs = (1, 7, 40)
    d = [rng.standard_normal(n - o) + 1j * rng.standard_normal(n - o)
         for o in offs]
    a = sp.diags(d + d, offs + tuple(-o for o in offs), shape=(n, n))
    a = (a + sp.diags(8.0 + 1j * rng.standard_normal(n))).tocsr()
    a.sort_indices()
    return a


def _from_generator(gen, *args):
    return getattr(jtm, gen)(*args), getattr(ttm, gen)(*args, device="cpu")


def _from_scipy(a):
    args = (a.indptr, a.indices, a.data, a.shape)
    return (lis_tpu.CSRMatrix.from_csr_arrays(*args),
            lis_tpu_torch.CSRMatrix.from_csr_arrays(*args, device="cpu"))


SYSTEMS = {
    "poisson3d27": lambda: _from_generator("poisson3d27", 6, 7, 8),
    "poisson2d": lambda: _from_generator("poisson2d", 31, 17),
    "gamma": lambda: _from_generator("gamma_matrix", 60, 0.4),
    "csym": lambda: _from_scipy(csym_banded()),
}


def rhs(n, cplx=False, seed=3):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(n)
    return b + 1j * rng.standard_normal(n) if cplx else b


def assert_same(rj, rt, rtol):
    """Equal status and count; the history to rtol 1e-6 (a late entry
    also carries rounding of a few eps * rhistory[0]); x to ``rtol``."""
    assert rt.status == rj.status
    assert rt.iters == rj.iters
    rh = np.asarray(rj.rhistory)
    np.testing.assert_allclose(
        rt.rhistory, rh, rtol=max(rtol, 1e-6),
        atol=8 * np.finfo(rt.rhistory.dtype).eps * rh[0])
    xj = np.asarray(rj.x)
    assert rt.x.numpy().dtype == xj.dtype
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=rtol,
                               atol=rtol * np.abs(xj).max())


@pytest.mark.parametrize("system,opts", [
    ("poisson3d27", "-i cg -p jacobi -tol 1e-10"),
    ("poisson3d27", "-i cg -p none -tol 1e-10"),
    ("poisson3d27", "-i cg -p jacobi -tol 1e-10 -scale 1"),
    ("poisson3d27", "-i cg -p jacobi -tol 1e-10 -scale 2"),
    ("poisson3d27", "-i cr -p jacobi -tol 1e-10"),
    ("poisson3d27", "-i cg -p jacobi -conv_cond nrm2_b -tol 1e-9"),
    ("poisson3d27", "-i cg -p jacobi -conv_cond nrm1_b -tol_w 1e-9 -tol 0"),
    ("poisson3d27", "-i cg -p jacobi -tol 1e-14 -maxiter 7"),
    ("poisson2d", "-i cg -p jacobi -tol 1e-10"),
    ("poisson2d", "-i cg -p jacobi -tol 1e-10 -scale 2"),
    ("poisson2d", "-i bicg -p jacobi -tol 1e-10"),
    ("poisson3d27", "-i bicgstab -p jacobi -tol 1e-10"),
    ("gamma", "-i bicg -p jacobi -tol 1e-10"),
    ("gamma", "-i bicg -p jacobi -tol 1e-10 -scale 1"),
    ("gamma", "-i bicr -p none -tol 1e-10"),
    ("gamma", "-i bicgstab -p jacobi -tol 1e-10"),
    ("csym", "-i cocg -p jacobi -tol 1e-10"),
    ("csym", "-i cocr -p jacobi -tol 1e-10"),
    ("csym", "-i cocg -p jacobi -tol 1e-10 -scale 2"),
])
def test_default_routed_solve_matches_lis_tpu(system, opts):
    J, T = SYSTEMS[system]()
    b = rhs(T.nrows, system == "csym")
    rj = lis_tpu.solve(J, b, options=opts)
    rt = lis_tpu_torch.solve(T, b, options=opts)
    assert transform_operator(T, rt.options).format_name == "dia"
    if "-maxiter" not in opts:
        assert rj.status == lis_tpu.LIS_SUCCESS
    assert_same(rj, rt, rtol=1e-9)
    np.testing.assert_allclose(rt.true_resid, rj.true_resid, rtol=1e-3,
                               atol=1e-16)


@pytest.mark.parametrize("system,opts", [
    ("poisson3d27", "-i cg -p jacobi -tol 1e-5 -f single"),
    ("poisson2d", "-i cg -p jacobi -tol 1e-5 -f single"),
    ("gamma", "-i bicg -p jacobi -tol 1e-5 -f single"),
])
def test_default_routed_single_matches_lis_tpu(system, opts):
    J, T = SYSTEMS[system]()
    b = rhs(T.nrows)
    rj = lis_tpu.solve(J, b, options=opts)
    rt = lis_tpu_torch.solve(T, b, options=opts)
    assert rt.status == rj.status == lis_tpu.LIS_SUCCESS
    assert abs(rt.iters - rj.iters) <= 1     # f32 sums in another order
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=1e-4,
                               atol=1e-4 * np.abs(xj).max())


def test_solve_accepts_a_dia_built_directly():
    """poisson3d27_dia in both packages: no CSR input at all."""
    J, T = jtm.poisson3d27_dia(6, 7, 8), \
        ttm.poisson3d27_dia(6, 7, 8, device="cpu")
    b = rhs(T.nrows)
    opts = "-i cg -p jacobi -tol 1e-10"
    rt = lis_tpu_torch.solve(T, b, options=opts)
    assert transform_operator(T, rt.options) is T
    assert_same(lis_tpu.solve(J, b, options=opts), rt, rtol=1e-9)


# ---- the fused step's plain version against the step of torch operations -----

def _run_both_steps(A, b, M, spec):
    b = torch.from_numpy(b)
    x0 = torch.zeros_like(b)
    out = []
    for fn in (tcg.cg_fused, tcg.cg_torch_ops):
        r, bnrm_inv, tol_eff, nrm0 = init_residual(A, b, x0, spec)
        rh = new_rhistory(spec, nrm0, b.dtype)
        out.append(fn(A, b, x0, M, spec, r, bnrm_inv, tol_eff, nrm0, rh))
    return out


class _Diag:
    """A preconditioner that is neither Jacobi nor none: z from psolve."""

    def __init__(self, w):
        self.w = w

    def psolve(self, r):
        return self.w * r


@pytest.mark.parametrize("precon", ["jacobi", "none", "general"])
@pytest.mark.parametrize("conv_cond,tol,tol_w", [(0, 1e-10, 1.0),
                                                 (1, 1e-9, 1.0),
                                                 (2, 0.0, 1e-9)])
@pytest.mark.parametrize("check_every", [1, 8])
def test_fused_step_matches_torch_ops_step(precon, conv_cond, tol, tol_w,
                                           check_every):
    """Same iterations and status, x and the history to 1e-12, for the
    folded Jacobi and none, a general M, every convergence measure, and
    with the host reading the loop condition only every 8 steps (the
    fused step freezes itself past convergence)."""
    A = lis_tpu_torch.convert_matrix(ttm.poisson3d27(5, 6, 7, device="cpu"),
                                     "dia", device="cpu")
    if precon == "jacobi":
        M = create_jacobi(A, None)
    elif precon == "none":
        M = NonePrecon()
    else:
        M = _Diag(torch.from_numpy(
            np.random.default_rng(0).uniform(0.02, 0.05, A.nrows)))
    spec = SolverSpec(solver="cg", tol=tol, tol_w=tol_w, maxiter=200,
                      conv_cond=conv_cond, check_every=check_every)
    fused, plain = _run_both_steps(A, rhs(A.nrows), M, spec)
    assert int(fused.status) == int(plain.status) == lis_tpu.LIS_SUCCESS
    assert int(fused.iters) == int(plain.iters) > 5
    n = int(plain.iters) + 1
    torch.testing.assert_close(fused.x, plain.x, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(fused.rhistory[:n], plain.rhistory[:n],
                               rtol=1e-9, atol=1e-18)
    assert torch.isnan(fused.rhistory[n:]).all()
    torch.testing.assert_close(fused.resid, plain.resid, rtol=1e-9,
                               atol=1e-18)


def test_fused_step_maxiter():
    A = ttm.poisson2d(20, 20, device="cpu")
    spec = SolverSpec(solver="cg", tol=1e-14, maxiter=5)
    fused, plain = _run_both_steps(A, rhs(A.nrows), NonePrecon(), spec)
    assert int(fused.status) == int(plain.status) == lis_tpu.LIS_MAXITER
    assert int(fused.iters) == int(plain.iters) == 5
    torch.testing.assert_close(fused.x, plain.x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("storage", ["", "-auto_storage false",
                                     "-storage dia"])
def test_breakdown_on_a_zero_matrix(storage):
    """p·q == 0: BREAKDOWN, x as it was, in both packages and both steps."""
    n = 40
    z = sp.csr_matrix((n, n))
    J, T = _from_scipy(z)
    b = rhs(n)
    x0 = np.full(n, 0.5)
    opts = "-i cg -p none -initx_zeros false "
    # lis_tpu's own router sends an empty matrix to a BES with no part,
    # whose matvec raises: its side of the default-routing case runs on CSR
    rj = lis_tpu.solve(J, b, x0=x0,
                       options=opts + (storage or "-auto_storage false"))
    rt = lis_tpu_torch.solve(T, b, x0=x0, options=opts + storage)
    assert rt.status == rj.status == lis_tpu.LIS_BREAKDOWN
    assert rt.iters == rj.iters
    np.testing.assert_array_equal(rt.x.numpy(), x0)
    np.testing.assert_array_equal(np.asarray(rj.x), x0)
    np.testing.assert_allclose(rt.rhistory, np.asarray(rj.rhistory),
                               rtol=1e-12)
    spec = SolverSpec(solver="cg", tol=1e-10, maxiter=10)
    fused, plain = _run_both_steps(T, b, NonePrecon(), spec)
    assert int(fused.status) == int(plain.status) == lis_tpu.LIS_BREAKDOWN
    assert torch.equal(fused.x, plain.x)
    torch.testing.assert_close(fused.rhistory, plain.rhistory,
                               equal_nan=True)


def test_fused_step_leaves_its_inputs_alone():
    A = ttm.poisson2d(12, 9, device="cpu")
    b = torch.from_numpy(rhs(A.nrows))
    x0 = torch.from_numpy(rhs(A.nrows, seed=4))
    b0, x00 = b.clone(), x0.clone()
    r = lis_tpu_torch.solve(A, b, x0=x0,
                            options="-i cg -p jacobi -initx_zeros false")
    assert r.status == 0
    assert torch.equal(b, b0) and torch.equal(x0, x00)


# ---- MatrixMarket files and the command lines --------------------------------

def test_mm_written_by_lis_tpu_read_by_the_port(tmp_path):
    J = jtm.poisson2d(9, 7)
    b, x = rhs(63), rhs(63, seed=5)
    path = str(tmp_path / "a.mtx")
    lis_tpu.write_matrix_market(path, J, b=b, x=x)
    A, bt, xt = lis_tpu_torch.lis_input(path, device="cpu")
    assert A.format_name == "csr" and A.device.type == "cpu"
    for got, want in zip(A.to_csr_arrays(), J.to_csr_arrays()):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(bt.numpy(), b)
    np.testing.assert_array_equal(xt.numpy(), x)
    # without vectors: the native parser's path
    lis_tpu.write_matrix_market(path, J)
    A2 = lis_tpu_torch.read_matrix_market(path, device="cpu")
    for got, want in zip(A2.to_csr_arrays(), J.to_csr_arrays()):
        np.testing.assert_array_equal(got, np.asarray(want))
    D = lis_tpu_torch.read_matrix_market(path, "dia", device="cpu")
    assert D.format_name == "dia"


@pytest.mark.parametrize("cplx", [False, True])
def test_mm_written_by_the_port_read_by_lis_tpu(tmp_path, cplx):
    a = csym_banded(40) if cplx else None
    T = _from_scipy(a)[1] if cplx else ttm.gamma_matrix(30, device="cpu")
    b = None if cplx else rhs(30)
    path = str(tmp_path / "t.mtx")
    lis_tpu_torch.write_matrix_market(path, T, b=b)
    J, bj, xj = lis_tpu.lis_input(path)
    for got, want in zip(J.to_csr_arrays(), T.to_csr_arrays()):
        np.testing.assert_array_equal(np.asarray(got), want)
    assert xj is None
    if b is not None:
        np.testing.assert_array_equal(np.asarray(bj), b)
    # and the two writers produce the same bytes
    path2 = str(tmp_path / "j.mtx")
    lis_tpu.write_matrix_market(path2, J, b=b)
    assert open(path).read() == open(path2).read()


_MM_FILES = {
    "symmetric": ("%%MatrixMarket matrix coordinate real symmetric\n"
                  "% a comment\n3 3 4\n1 1 2.0\n2 1 -1.0\n3 2 -1.0\n3 3 2.0\n"),
    "skew": ("%%MatrixMarket matrix coordinate real skew-symmetric\n"
             "3 3 2\n2 1 1.5\n3 1 -2.5\n"),
    "hermitian": ("%%MatrixMarket matrix coordinate complex hermitian\n"
                  "2 2 3\n1 1 2.0 0.0\n2 1 1.0 -3.0\n2 2 4.0 0.0\n"),
    "pattern": ("%%MatrixMarket matrix coordinate pattern general\n"
                "2 3 3\n1 1\n1 3\n2 2\n"),
    "integer_dups": ("%%MatrixMarket matrix coordinate integer general\n"
                     "2 2 3\n1 1 2\n1 1 3\n2 2 1\n"),
    "array": ("%%MatrixMarket matrix array real general\n"
              "2 2\n1.0\n0.0\n3.0\n4.0\n"),
}


@pytest.mark.parametrize("name", list(_MM_FILES))
def test_mm_variants_read_like_lis_tpu(tmp_path, name):
    """1-based indices, symmetry expansion, pattern and integer fields,
    duplicate entries summed, the array format."""
    path = str(tmp_path / f"{name}.mtx")
    with open(path, "w") as f:
        f.write(_MM_FILES[name])
    J = lis_tpu.read_matrix_market(path)
    T = lis_tpu_torch.read_matrix_market(path, device="cpu")
    assert T.shape == J.shape and T.nnz == J.nnz
    for got, want in zip(T.to_csr_arrays(), J.to_csr_arrays()):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_mm_errors_and_unported_formats(tmp_path):
    path = str(tmp_path / "bad.mtx")
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n"
                "3 3 4\n1 1 2.0\n2 2 1.0\n")
    with pytest.raises(ValueError, match="truncated"):
        lis_tpu_torch.read_matrix_market(path, device="cpu")
    with open(path, "w") as f:
        f.write("not a matrix\n")
    with pytest.raises(NotImplementedError, match="queue 1 item 8"):
        lis_tpu_torch.lis_input(path, device="cpu")
    with open(path, "w") as f:
        f.write("#LIS A matrix\n")
    with pytest.raises(NotImplementedError, match="Lis native"):
        lis_tpu_torch.lis_input(path, device="cpu")
    with pytest.raises(NotImplementedError, match="Lis native"):
        lis_tpu_torch.lis_input_vector(path, device="cpu")
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n"
                "2 2 1 0 0 2\n")
    with pytest.raises(NotImplementedError, match="binary"):
        lis_tpu_torch.read_matrix_market(path, device="cpu")
    A = ttm.tridiag(4, device="cpu")
    with pytest.raises(NotImplementedError, match="binary"):
        lis_tpu_torch.write_matrix_market(path, A, binary=True)
    with pytest.raises(NotImplementedError, match="item 8"):
        lis_tpu_torch.lis_output(path, A, fmt="hb")
    with pytest.raises(ValueError, match="unsupported"):
        lis_tpu_torch.lis_output(path, A, fmt="nope")
    lis_tpu_torch.lis_output(path, A)
    assert lis_tpu_torch.lis_input(path, device="cpu")[0].nnz == A.nnz


def _solve_lines(out):
    """The lines of a report that do not hold a time."""
    return [ln for ln in out.splitlines() if "time" not in ln]


@pytest.mark.parametrize("rhs_setting", ["0", "0_bundled", "1", "2", "file"])
def test_lsolve_matches_lis_tpu(tmp_path, capsys, rhs_setting):
    """Exit status, every printed line (the live iteration lines, the
    banner, the iteration count and the residual) and the solution and
    history files, for each rhs setting."""
    J = jtm.poisson2d(9, 7)
    path = str(tmp_path / "a.mtx")
    lis_tpu.write_matrix_market(
        path, J, b=rhs(63) if rhs_setting == "0_bundled" else None)
    setting = rhs_setting.split("_")[0]
    if setting == "file":
        setting = str(tmp_path / "b.mtx")
        lis_tpu.io.mm.write_vector_mm(setting, rhs(63, seed=8))
    opts = ["-i", "cg", "-p", "jacobi", "-tol", "1e-10"]
    outs = {}
    for tag, main, kw in (("j", jlsolve.main, {}),
                          ("t", tlsolve.main, {"device": "cpu"})):
        xf, hf = str(tmp_path / f"x{tag}.mtx"), str(tmp_path / f"h{tag}.txt")
        rc = main([path, setting, xf, hf] + opts, **kw)
        outs[tag] = (rc, capsys.readouterr().out,
                     np.asarray(lis_tpu.read_vector_mm(xf)), hf)
    (rcj, outj, xj, hj), (rct, outt, xt, ht) = outs["j"], outs["t"]
    assert rct == rcj == 0
    # lis_tpu's banner goes to the stdout of import time, past capsys:
    # compare the live iteration lines and the closing report
    def lines(out):
        """(text before the number, the number) of each such line."""
        return [(ln.rsplit("=", 1)[0], float(ln.rsplit("=", 1)[1]))
                for ln in out.splitlines()
                if ln.startswith(("iteration:", "CG:"))]
    lt, lj = lines(outt), lines(outj)
    assert [t for t, _ in lt] == [t for t, _ in lj] and len(lt) > 10
    # a residual at the rounding floor differs in its digits
    np.testing.assert_allclose([v for _, v in lt], [v for _, v in lj],
                               rtol=1e-6, atol=1e-15)
    assert "CG: number of iterations = " in outt
    assert "number of iterations  : " in outt          # the port's banner
    np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.loadtxt(ht), np.loadtxt(hj), rtol=1e-6,
                               atol=1e-15)
    np.testing.assert_array_equal(
        lis_tpu_torch.read_vector_mm(str(tmp_path / "xt.mtx"),
                                     device="cpu").numpy(), xt)


def test_lsolve_exit_status_and_usage(tmp_path, capsys):
    J = jtm.poisson2d(9, 7)
    path = str(tmp_path / "a.mtx")
    lis_tpu.write_matrix_market(path, J)
    args = [path, "1", "-i", "cg", "-maxiter", "3", "-print", "none"]
    rcj = jlsolve.main(args)
    outj = capsys.readouterr().out
    rct = tlsolve.main(args, device="cpu")
    assert rct == rcj == lis_tpu.LIS_MAXITER
    assert capsys.readouterr().out == outj
    assert tlsolve.main([path], device="cpu") == jlsolve.main([path]) == 1


@pytest.mark.parametrize("precon", ["jacobi", "none"])
def test_hpcg_matches_lis_tpu(capsys, precon):
    args = ["8", "8", "8", "-p", precon]
    rcj = jhpcg.main(args)
    outj = capsys.readouterr().out
    rct = thpcg.main(args, device="cpu")
    outt = capsys.readouterr().out
    assert rct == rcj == 0
    tj, tt = _solve_lines(outj), _solve_lines(outt)
    assert tt[:4] == tj[:4]            # size, solver, precon, iterations
    assert "number of iterations" in tt[3]


def test_hpcg_default_options_match_lis_tpu(capsys):
    """hpcg with its defaults (-i cg -p ssor -adds true): exit 0 and the
    same report head as lis_tpu's; too few arguments still give usage."""
    args = ["8", "8", "8"]
    rcj = jhpcg.main(args)
    outj = capsys.readouterr().out
    rct = thpcg.main(args, device="cpu")
    outt = capsys.readouterr().out
    assert rct == rcj == 0
    tj, tt = _solve_lines(outj), _solve_lines(outt)
    assert tt[:4] == tj[:4]            # size, solver, precon + adds, iters
    assert tt[2].endswith("ssor + adds")
    assert thpcg.main(["4"], device="cpu") == 1
