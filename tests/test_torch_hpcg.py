"""The hpcg configuration and the solvers of its slice in both packages, on
the CPU: preconditioned solves with default routing (SSOR and ILU(0) on
DIA, additive Schwarz), the level-scheduled path (-auto_storage false),
the stationary solvers, GMRES/FGMRES, and the ``hpcg`` command line.

Solves must agree in status and iteration count, x to rtol 1e-9 (1e-4 at
-f single) and the residual history to rtol 1e-6.  On the CPU the port
runs the plain versions of kernels E, F, G, H, I and K.
"""

import numpy as np
import pytest

import lis_tpu
import lis_tpu.cli.hpcg as jhpcg
import lis_tpu_torch
import lis_tpu_torch.cli.hpcg as thpcg
from lis_tpu_torch.solvers.driver import transform_operator
from tests.test_torch_mainpath import (SYSTEMS, _from_scipy, _solve_lines,
                                       assert_same, rhs)
from tests.test_torch_precon import nonsym_banded

SYS = dict(SYSTEMS, nonsym=lambda: _from_scipy(nonsym_banded()))


@pytest.mark.parametrize("system,opts,route", [
    ("poisson3d27", "-i cg -p ssor", "dia"),
    ("poisson3d27", "-i cg -p ssor -adds true", "dia"),
    ("poisson3d27", "-i cg -p ssor -adds true -adds_iter 2", "dia"),
    ("poisson3d27", "-i cg -p ssor -ssor_omega 1.2 -ssor_sweeps 3", "dia"),
    ("poisson3d27", "-i cg -p ilu", "dia"),
    ("poisson3d27", "-i cg -p ssor -scale 1", "dia"),
    ("poisson2d", "-i cg -p ssor -adds true", "dia"),
    ("nonsym", "-i bicg -p ssor", "dia"),
    ("nonsym", "-i bicg -p ilu", "dia"),
    ("nonsym", "-i bicgstab -p ilu", "dia"),
    ("gamma", "-i bicg -p ssor -adds true", "dia"),
    ("poisson3d27", "-i cg -p ssor -auto_storage false", "csr"),
    ("poisson3d27", "-i cg -p ilu -ilu_fill 1 -auto_storage false", "csr"),
    ("nonsym", "-i bicg -p ssor -auto_storage false", "csr"),
    ("csym", "-i cocg -p ilu", "dia"),
    ("csym", "-i cocg -p ssor", "dia"),
    ("poisson3d27", "-i jacobi", "dia"),
    ("poisson3d27", "-i gs", "dia"),
    ("poisson3d27", "-i sor -omega 1.2", "dia"),
    ("poisson3d27", "-i sor", "dia"),
    ("poisson3d27", "-i gs -auto_storage false", "csr"),
    ("poisson3d27", "-i gmres -restart 30", "dia"),
    ("poisson3d27", "-i gmres -restart 30 -p jacobi", "dia"),
    ("poisson3d27", "-i gmres -restart 30 -p ssor", "dia"),
    ("poisson3d27", "-i fgmres -p ssor", "dia"),
    ("nonsym", "-i gmres -restart 20 -p ilu -auto_storage false", "csr"),
    ("csym", "-i gmres -p jacobi", "dia"),
])
def test_preconditioned_solve_matches_lis_tpu(system, opts, route):
    J, T = SYS[system]()
    b = rhs(T.nrows, system == "csym")
    rj = lis_tpu.solve(J, b, options=opts)
    rt = lis_tpu_torch.solve(T, b, options=opts)
    assert transform_operator(T, rt.options).format_name == route
    assert rj.status == lis_tpu.LIS_SUCCESS
    assert_same(rj, rt, rtol=1e-9)


def test_gmres_restarts_match_lis_tpu():
    """A solve that restarts several times (the fresh-matvec residual at
    each restart), and one cut by -maxiter inside a cycle."""
    J, T = SYS["poisson3d27"]()
    b = rhs(T.nrows)
    for opts in ("-i gmres -restart 5", "-i fgmres -restart 4 -p ssor",
                 "-i gmres -restart 6 -maxiter 15"):
        rj = lis_tpu.solve(J, b, options=opts)
        rt = lis_tpu_torch.solve(T, b, options=opts)
        assert_same(rj, rt, rtol=1e-9)
    assert rt.status == lis_tpu.LIS_MAXITER and rt.iters == 15
    assert lis_tpu_torch.solve(T, b, options="-i gmres -restart 5").iters > 10


@pytest.mark.parametrize("opts", ["-i cg -p ssor -f single",
                                  "-i cg -p ssor -adds true -f single",
                                  "-i sor -omega 1.2 -f single -tol 1e-5"])
def test_single_precision_matches_lis_tpu(opts):
    J, T = SYS["poisson3d27"]()
    b = rhs(T.nrows)
    rj = lis_tpu.solve(J, b, options=opts)
    rt = lis_tpu_torch.solve(T, b, options=opts)
    assert rt.status == rj.status == lis_tpu.LIS_SUCCESS
    assert abs(rt.iters - rj.iters) <= 1     # f32 sums in another order
    xj = np.asarray(rj.x)
    assert rt.x.dtype == lis_tpu_torch.solve(
        T, b, options="-i cg -p ssor").x.dtype
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=1e-4,
                               atol=1e-4 * np.abs(xj).max())


@pytest.mark.parametrize("extra", [["-p", "ilu"], ["-adds_iter", "2"],
                                   ["-i", "gmres", "-restart", "20"]])
def test_hpcg_options_match_lis_tpu(capsys, extra):
    """hpcg with options beside its defaults: the same report head."""
    args = ["6", "7", "8"] + extra
    rcj = jhpcg.main(args)
    outj = capsys.readouterr().out
    rct = thpcg.main(args, device="cpu")
    outt = capsys.readouterr().out
    assert rct == rcj == 0
    assert _solve_lines(outt)[:4] == _solve_lines(outj)[:4]


@pytest.mark.parametrize("solver", ["gs", "sor"])
def test_prepare_hook_counts_in_ptime(monkeypatch, solver):
    """The GS/SOR set-up (split and lower plan) is timed in ptime, the
    set-up metric, and not in itime."""
    import time
    from lis_tpu_torch.solvers import base
    real = base.SOLVER_PREPARE[solver]

    def slow(A, spec):
        time.sleep(0.3)
        return real(A, spec)
    monkeypatch.setitem(base.SOLVER_PREPARE, solver, slow)
    A = SYS["poisson2d"]()[1]
    res = lis_tpu_torch.solve(A, rhs(A.nrows),
                              options=f"-i {solver} -maxiter 5")
    assert res.iters == 5
    assert res.ptime >= 0.3 > res.itime
