"""lis_tpu_torch.solve against lis_tpu.solve: convergence criteria,
scaling, -f single, -maxiter, -print out and device placement on the
small grid (the solver x preconditioner x storage matrix on both grids is
in tests/test_torch_solve.py).

The same system and option string go through both packages: iteration
counts and statuses must be equal, rhistory and x agree to rtol 1e-9 at
-f double (summation orders differ, and a Krylov method amplifies the
difference a little) and to rtol 1e-5 at -f single (f32 rounding in two
different summation orders).  The system is the locality-free SPD
a + aᵀ + 4k·I of tests/test_torch_cst.py.
"""

import numpy as np
import pytest
import torch

import lis_tpu_torch
from tests.test_torch_solve import assert_same, both, system


@pytest.mark.parametrize("extra", [
    "-conv_cond nrm2_r", "-conv_cond nrm2_b", "-conv_cond nrm1_b -tol_w 0",
    "-scale none", "-scale jacobi", "-scale symm_diag",
    "-i cr -scale jacobi", "-i cr -conv_cond nrm1_b -tol_w 0.5",
])
def test_solve_options_match_lis_tpu(extra):
    rj, rt = both(1 << 15, 5, "-i cg -p jacobi -storage cst -tol 1e-10 "
                  + extra)
    assert_same(rj, rt, rtol=1e-9)


@pytest.mark.parametrize("solver", ["cg", "cr"])
def test_solve_single_matches_lis_tpu(solver):
    rj, rt = both(1 << 15, 5, f"-i {solver} -p jacobi -storage cst "
                  "-tol 1e-6 -f single")
    assert rt.x.dtype == torch.float64
    assert rt.status == lis_tpu_torch.LIS_SUCCESS
    assert_same(rj, rt, rtol=1e-5)


def test_live_print_and_banner(capsys):
    a, J, T, b = system(1 << 15, 5)
    r = lis_tpu_torch.solve(T, b, options="-i cg -p jacobi -storage cst "
                            "-tol 1e-8 -print out")
    out = capsys.readouterr().out.splitlines()
    its = [ln for ln in out if ln.startswith("iteration:")]
    assert len(its) == r.iters
    assert its[-1] == (f"iteration: {r.iters:5d}  relative residual = "
                       f"{r.resid:e}")
    assert f"number of iterations  : {r.iters}" in out


def test_solve_runs_on_the_matrix_device():
    a, J, T, b = system(1 << 15, 5)
    r = lis_tpu_torch.solve(T, torch.from_numpy(b),
                            options="-i cg -p jacobi -storage cst "
                                    "-tol 1e-10")
    assert r.x.device == T.device
    res = np.linalg.norm(a @ r.x.numpy() - b) / np.linalg.norm(b)
    assert res <= 1e-9
    np.testing.assert_allclose(res, r.true_resid, rtol=1e-6)


@pytest.mark.parametrize("solver", ["cg", "cr"])
@pytest.mark.parametrize("maxiter", [3, 1000])
def test_masked_check_interval_matches(solver, maxiter):
    """Reading the loop condition every 8 steps (each step merged under
    the condition as a mask) gives exactly the iterations, status, history
    and x of reading it before every step."""
    from lis_tpu_torch.precon.jacobi import create_jacobi
    from lis_tpu_torch.solvers import driver as D
    a, J, T, b = system(1 << 15, 5)
    opts = lis_tpu_torch.SolverOptions.from_string(
        f"-i {solver} -p jacobi -storage cst -tol 1e-10 -maxiter {maxiter}")
    C = D._convert_storage(T, opts)
    M = create_jacobi(C, opts)
    bt = torch.from_numpy(b)
    outs = [D.SOLVER_FNS[solver](C, bt, torch.zeros_like(bt), M,
                                 D._make_spec(opts)._replace(check_every=k))
            for k in (1, 8)]
    assert int(outs[0].iters) == int(outs[1].iters)
    assert int(outs[0].status) == int(outs[1].status)
    assert torch.equal(outs[0].x, outs[1].x)
    torch.testing.assert_close(outs[0].rhistory, outs[1].rhistory,
                               rtol=0, atol=0, equal_nan=True)


def test_jacobi_precon_and_from_numpy_state():
    """The port's Jacobi equals lis_tpu's, and lis_tpu's carried over by
    from_numpy_state applies the same psolve."""
    from lis_tpu.precon.jacobi import create_jacobi as jax_jacobi
    from lis_tpu_torch.interop.state import from_numpy_state
    from lis_tpu_torch.precon.jacobi import create_jacobi
    a, J, T, b = system(1 << 15, 5)
    pj = jax_jacobi(J, None)
    pt = create_jacobi(T, None)
    carried = from_numpy_state("jacobi", {"dinv": np.asarray(pj.dinv)})
    np.testing.assert_array_equal(pt.dinv.numpy(), np.asarray(pj.dinv))
    r = torch.from_numpy(b)
    assert torch.equal(carried.psolve(r), pt.psolve(r))
    np.testing.assert_array_equal(pt.psolve(r).numpy(),
                                  np.asarray(pj.psolve(b)))


@pytest.mark.parametrize("storage", ["-storage cst", "-auto_storage false"])
@pytest.mark.parametrize("solver,precon", [("cg", "jacobi"), ("cg", "none"),
                                           ("cr", "jacobi"), ("cr", "none")])
def test_solve_maxiter_matches_lis_tpu(storage, solver, precon):
    rj, rt = both(1 << 15, 5, f"-i {solver} -p {precon} {storage} "
                  "-tol 1e-10 -maxiter 3")
    assert rt.status == lis_tpu_torch.LIS_MAXITER and rt.iters == 3
    assert_same(rj, rt, rtol=1e-9)
