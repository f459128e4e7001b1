"""The Krylov slice's solvers (test_torch_krylov.py) in their other
modes: -f single, complex data (against lis_tpu, and on a non-normal
system against scipy), the live -print of the solvers whose step records
several iterations, the masked check interval, and the launch counts that
chip_smoke.py holds the card to, against the solvers' counted calls.
Systems and ``assert_same`` are test_torch_krylov.py's.
"""

import numpy as np
import pytest
import torch

import lis_tpu
import lis_tpu_torch
from tests.test_torch_krylov import COMPLEX, NEW, assert_same, both, pair


@pytest.mark.parametrize("solver", NEW)
def test_single_precision_matches_lis_tpu(solver):
    """-f single: equal counts and status, x to rtol 1e-5, the true
    residual under 2·tol in both.  The history holds to rtol 1e-2 plus
    -tol (1e-5) absolute: float32 rounding (eps 1.2e-7) in the two
    packages' summation orders, with XLA's fused multiply-adds, is
    amplified along the iteration, to 2.3e-3 relative on the middle
    entries of CGS (whose squared polynomial lifts the residual to 33x
    its start) and TFQMR, and to a factor 2 on CGS's last entry, whose
    size is the tolerance's.  The equal count and status show that both
    cross -tol at the same step."""
    rj, rt = both("spd", f"-i {solver} -p jacobi -tol 1e-5 -f single")
    assert rt.x.dtype == torch.float64
    assert rt.status == rj.status == lis_tpu_torch.LIS_SUCCESS
    assert rt.iters == rj.iters
    np.testing.assert_allclose(rt.rhistory, np.asarray(rj.rhistory),
                               rtol=1e-2, atol=1e-5)
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=1e-5,
                               atol=1e-5 * np.abs(xj).max())
    assert rt.true_resid <= 2e-5 and rj.true_resid <= 2e-5


@pytest.mark.parametrize("solver", COMPLEX + ["minres"])
def test_complex_solve_matches_lis_tpu(solver):
    """A complex nonsymmetric diagonally dominant system (minres: the
    Hermitian one).  Complex products round differently in the two
    packages (XLA fuses multiply-adds, torch does not), so a late history
    entry may differ by 16 eps·rhistory[0].  BiCGSTAB(l) runs with
    -ell 1 here: for l >= 2 its Gram-Schmidt coefficient is
    <r_j, r_i>/σ_i with the conjugate on r_j, as in lis_tpu
    (lis_tpu/solvers/bicgstabl.py:96), which on complex data does not
    orthogonalise and amplifies rounding: a change of 1e-15 in b moves
    the history by 0.6 relative on this system (1.7e-7 with the conjugate
    on r_i).  -ell 2 is held to scipy in
    ``test_complex_tridiagonal_solves_to_scipy``."""
    system = "hermitian" if solver == "minres" else "cnonsym"
    ell = " -ell 1" if solver == "bicgstabl" else ""
    rj, rt = both(system, f"-i {solver}{ell} -tol 1e-10 -maxiter 3000")
    assert rj.status == lis_tpu.LIS_SUCCESS
    assert rt.x.dtype == torch.complex128
    assert_same(rj, rt, rtol=1e-9, ulps=16)


@pytest.mark.parametrize("solver", COMPLEX)
def test_complex_tridiagonal_solves_to_scipy(solver):
    """tests/test_complex.py's non-normal complex tridiagonal: on it the
    last-bit differences of complex products (XLA rounds them with fused
    multiply-adds, torch does not) grow about tenfold per step, so
    BiCGSTAB(2) ends in 20 iterations here and in 22 in lis_tpu.  So it
    is held to scipy, as lis_tpu's test holds it: SUCCESS, a true
    residual under 1e-8, and x equal to lis_tpu's to 1e-8."""
    a, t, b = pair("general")
    rj, rt = both("general", f"-i {solver} -tol 1e-10 -maxiter 3000")
    assert rt.status == rj.status == lis_tpu_torch.LIS_SUCCESS
    x = rt.x.numpy()
    dense = np.asarray(a.to_dense())
    assert np.linalg.norm(dense @ x - b) / np.linalg.norm(b) < 1e-8
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(x, xj, rtol=1e-8, atol=1e-8 * np.abs(xj).max())


@pytest.mark.parametrize("opts", ["-i bicgstabl -ell 4", "-i idrs -irestart 4",
                                  "-i cgs"])
def test_live_print_shows_every_iteration(opts, capsys):
    """A step of BiCGSTAB(l) records l iterations and IDR(s)'s start
    phase s: -print out still prints one line per iteration, the history
    entries in order."""
    _, t, b = pair("spd")
    r = lis_tpu_torch.solve(t, b, options=opts + " -tol 1e-10 -print out")
    its = [ln for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("iteration:")]
    assert r.status == lis_tpu_torch.LIS_SUCCESS
    assert its == [f"iteration: {k:5d}  relative residual = {h:e}"
                   for k, h in enumerate(r.rhistory[1:], 1)]


@pytest.mark.parametrize("maxiter", [4, 1000])
@pytest.mark.parametrize("solver", NEW)
def test_masked_check_interval_matches(solver, maxiter):
    """Reading the loop condition every 8 steps (each step merged under
    the condition as a mask) gives exactly the iterations, status, history
    and x of reading it before every step, also where a step writes its
    stacks or rings in place (Orthomin, BiCGSTAB(l), IDR(s))."""
    from lis_tpu_torch.precon.jacobi import create_jacobi
    from lis_tpu_torch.solvers import driver as D
    from lis_tpu_torch.solvers.base import SOLVER_PREPARE
    _, t, b = pair("spd")
    opts = lis_tpu_torch.SolverOptions.from_string(
        f"-i {solver} -p jacobi -tol 1e-10 -maxiter {maxiter}")
    M = create_jacobi(t, opts)
    bt = torch.from_numpy(b)
    outs = []
    for k in (1, 8):
        spec = D._make_spec(opts)._replace(check_every=k)
        aux = {"aux": SOLVER_PREPARE[solver](t, spec)} \
            if solver in SOLVER_PREPARE else {}
        outs.append(D.SOLVER_FNS[solver](t, bt, torch.zeros_like(bt), M,
                                         spec, **aux))
    assert int(outs[0].iters) == int(outs[1].iters)
    assert int(outs[0].status) == int(outs[1].status)
    assert torch.equal(outs[0].x, outs[1].x)
    torch.testing.assert_close(outs[0].rhistory, outs[1].rhistory,
                               rtol=0, atol=0, equal_nan=True)


class _Counting:
    """An operator or preconditioner that counts its applications."""

    def __init__(self, inner):
        self.inner, self.calls = inner, {"matvec": 0, "matvech": 0,
                                         "psolve": 0}

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if name in self.calls:
            def counted(x):
                self.calls[name] += 1
                return attr(x)
            return counted
        return attr


@pytest.mark.parametrize("opts", [f"-i {s}" for s in NEW] + [
    "-i bicgstabl -ell 4", "-i idrs -irestart 4",
    "-i idrs -irestart 8 -tol 1e-2"])
def test_smoke_counts_are_the_solvers_calls(opts):
    """chip_smoke.py holds the card's launches of E, F, H and A–D to
    ``krylov_counts``: here its counts are held to the matvecs, Aᴴ
    products and psolves that each solver makes, through counting
    wrappers (the last case converges inside IDR(8)'s start phase)."""
    from chip_smoke import krylov_counts
    from lis_tpu_torch.precon.jacobi import create_jacobi
    from lis_tpu_torch.solvers import driver as D
    from lis_tpu_torch.solvers.base import SOLVER_PREPARE
    _, t, b = pair("nonsym")
    o = lis_tpu_torch.SolverOptions.from_string(
        opts + " -p jacobi" + ("" if "-tol" in opts else " -tol 1e-10"))
    A, M = _Counting(t), _Counting(create_jacobi(t, o))
    spec = D._make_spec(o)
    kw = {"aux": SOLVER_PREPARE[o.solver](t, spec)} \
        if o.solver in SOLVER_PREPARE else {}
    bt = torch.from_numpy(b)
    out = D.SOLVER_FNS[o.solver](A, bt, torch.zeros_like(bt), M, spec, **kw)
    assert int(out.status) == lis_tpu_torch.LIS_SUCCESS
    want = krylov_counts(o.solver, int(out.iters), ell=o.ell, s=o.irestart)
    assert (A.calls["matvec"], A.calls["matvech"], M.calls["psolve"]) == want
