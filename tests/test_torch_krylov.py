"""The twelve Krylov solvers of lis_tpu_torch that the first slices left
out (CGS/CRS, TFQMR, Orthomin, GPBiCG/GPBiCR, BiCGSafe/BiCRSafe,
BiCGSTAB(l), IDR(s)/IDR(1), MINRES) against lis_tpu, on CSR.

The same system and option string go through ``lis_tpu.solve`` and
``lis_tpu_torch.solve(..., device="cpu")``: equal iteration counts and
statuses, rhistory and x to rtol 1e-9 at -f double (``assert_same``: a
late history entry may also differ by eps·max(rhistory)).
The systems are those of tests/test_all_solvers.py (poisson2d 9 x 9, and
random_sparse(70, 0.07, seed 11) with b = 1..70), its option cases
(-ell, -irestart on random_sparse(60, 0.08, seed 13)), the nonsymmetric
one with a random phase on every off-diagonal entry, and tests/test_complex.py's
complex tridiagonal and Hermitian systems.  Also
here: MAXITER and BREAKDOWN, the registry and IDR(s)'s shadow space bit
for bit.  -f single, complex data, the live -print, the masked check
interval and chip_smoke.py's launch counts are in
test_torch_krylov_modes.py; routed DIA and CST solves in
test_torch_krylov_dia.py and test_torch_krylov_cst.py.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lis_tpu
import lis_tpu_torch
from lis_tpu.solvers.idrs import _shadow_space
from lis_tpu_torch.runtime.options import SOLVER_NAMES
from lis_tpu_torch.solvers.base import SOLVER_FNS
from lis_tpu_torch.solvers.idrs import prepare_idr1, prepare_idrs, \
    shadow_space
from lis_tpu_torch.solvers.base import SolverSpec
from tests.problems import poisson2d, random_sparse

NEW = ["cgs", "crs", "tfqmr", "orthomin", "gpbicg", "gpbicr", "bicgsafe",
       "bicrsafe", "bicgstabl", "idrs", "idr1", "minres"]
# the new solvers that lis_tpu's tests/test_complex.py solves complex
# systems with (general: non-Hermitian; minres: Hermitian)
COMPLEX = ["cgs", "crs", "gpbicg", "gpbicr", "bicgsafe", "bicrsafe",
           "bicgstabl", "idrs", "idr1"]

_PAIRS = {}


def pair(name):
    """(lis_tpu CSR, port CSR on the CPU, b) for a named system, built
    once per module."""
    if name not in _PAIRS:
        if name == "spd":
            a, b = poisson2d(9, 9), np.ones(81)
        elif name == "nonsym":
            a, b = random_sparse(70, density=0.07, seed=11), \
                np.arange(1, 71, dtype=float)
        elif name == "options":
            a, b = random_sparse(60, density=0.08, seed=13), np.ones(60)
        elif name == "cnonsym":
            r = np.asarray(random_sparse(70, density=0.07,
                                         seed=11).to_dense())
            rng = np.random.default_rng(12)
            ph = np.exp(1j * rng.standard_normal((70, 70)))
            np.fill_diagonal(ph, 1.0)
            a = lis_tpu.CSRMatrix.from_dense(r * ph)
            b = rng.standard_normal(70) + 1j * rng.standard_normal(70)
        elif name == "zero":
            a = lis_tpu.CSRMatrix.from_dense(np.zeros((20, 20)))
            b = np.ones(20)
        else:
            a, b = _complex(name)
        m = sp.csr_matrix(np.asarray(a.to_dense()))
        m.sort_indices()
        t = lis_tpu_torch.CSRMatrix.from_csr_arrays(
            m.indptr, m.indices, m.data, m.shape, device="cpu")
        _PAIRS[name] = (a, t, b)
    return _PAIRS[name]


def _complex(name):
    """tests/test_complex.py's general (36 x 36 non-Hermitian
    tridiagonal) and hermitian (24 x 24 positive definite) systems."""
    if name == "general":
        n = 36
        a = sp.diags([-(1 + 0.5j), 4 + 1j, -(1 - 0.25j)], [-1, 0, 1],
                     shape=(n, n), format="csr")
        rng = np.random.RandomState(5)
    else:
        n = 24
        rng = np.random.RandomState(2)
        g = rng.randn(n, n) + 1j * rng.randn(n, n)
        a = sp.csr_matrix(g @ g.conj().T / n + np.diag(np.arange(1.0, n + 1)))
    a = a.tocsr()
    a.sort_indices()
    return (lis_tpu.CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data,
                                              a.shape),
            rng.randn(n) + 1j * rng.randn(n))


def assert_same(rj, rt, rtol, last=True, ulps=1, rh_rtol=None):
    """Equal counts and status; rhistory (to ``rh_rtol``, default
    ``rtol``) and x to ``rtol``, a late history entry also
    ulps·eps·max(rhistory) apart (an entry that small is rounding of the
    largest residual along the way); the true residual to 1e-3 relative,
    or 64 eps·max(rhistory) apart where the solve ended near rounding
    level (these small systems reach 1e-15 at -tol 1e-10).  ``last=False`` leaves the last
    history entry out (TFQMR, see ``test_solve_matches_lis_tpu``)."""
    assert rt.iters == rj.iters
    assert rt.status == rj.status
    assert isinstance(rt.x, torch.Tensor)
    rh = np.asarray(rj.rhistory)
    eps = np.finfo(rt.rhistory.dtype).eps
    end = None if last else -1
    np.testing.assert_allclose(rt.rhistory[:end], rh[:end],
                               rtol=rtol if rh_rtol is None else rh_rtol,
                               atol=ulps * eps * np.nanmax(rh))
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=rtol,
                               atol=rtol * np.abs(xj).max())
    np.testing.assert_allclose(rt.true_resid, rj.true_resid, rtol=1e-3,
                               atol=64 * eps * np.nanmax(rh))


def both(name, opts):
    a, t, b = pair(name)
    return lis_tpu.solve(a, b, options=opts), \
        lis_tpu_torch.solve(t, b, options=opts)


def test_registry_has_every_solver_name():
    """All 25 of lis_tpu's solver names run in the port."""
    assert {k for k in SOLVER_FNS if not k.endswith("_quad")} \
        == set(SOLVER_NAMES)


@pytest.mark.parametrize("precon", ["none", "jacobi"])
@pytest.mark.parametrize("system", ["spd", "nonsym"])
@pytest.mark.parametrize("solver", NEW)
def test_solve_matches_lis_tpu(solver, system, precon):
    """TFQMR's history is its quasi-residual estimate τ·√(m+1); poisson2d
    9 x 9 converges at Krylov exhaustion (true residual 5e-15), where the
    last estimate is the square root of the rounding noise in ||r|| times
    the previous ||r||: rounding noise itself (2.1e-12 here, 3.7e-12 in
    lis_tpu).  That entry is held to -tol only, by the equal count and
    status."""
    rj, rt = both(system, f"-i {solver} -p {precon} -tol 1e-10 "
                  "-maxiter 2000")
    assert rj.status == lis_tpu.LIS_SUCCESS
    assert_same(rj, rt, rtol=1e-9, last=solver != "tfqmr")


@pytest.mark.parametrize("solver", NEW)
def test_maxiter_matches_lis_tpu(solver):
    rj, rt = both("spd", f"-i {solver} -p jacobi -tol 1e-14 -maxiter 5")
    assert rt.status == lis_tpu_torch.LIS_MAXITER and rt.iters == 5
    assert_same(rj, rt, rtol=1e-9)


@pytest.mark.parametrize("solver", NEW)
def test_zero_matrix_status_matches_lis_tpu(solver):
    """A zero matrix: each solver's breakdown (or, where it has no
    breakdown test, its MAXITER or NaN exit) as in lis_tpu.  It is solved
    as CSR: lis_tpu's router fails on an all-zero matrix (its BES
    candidate indexes an empty diagonal profile, lis_tpu/matrix/bes.py)."""
    rj, rt = both("zero", f"-i {solver} -maxiter 50 -auto_storage false")
    assert rt.status == rj.status and rt.iters == rj.iters
    np.testing.assert_allclose(rt.rhistory, np.asarray(rj.rhistory),
                               rtol=1e-12)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-12)


@pytest.mark.parametrize("opts", ["-i bicgstabl -ell 1", "-i bicgstabl -ell 2",
                                  "-i bicgstabl -ell 4", "-i idrs -irestart 1",
                                  "-i idrs -irestart 2", "-i idrs -irestart 4",
                                  "-i orthomin -restart 5"])
def test_solver_options_match_lis_tpu(opts):
    rj, rt = both("options", opts + " -tol 1e-10")
    assert rj.status == lis_tpu.LIS_SUCCESS
    assert_same(rj, rt, rtol=1e-9)


@pytest.mark.parametrize("opts", ["-i bicgstabl -ell 4 -maxiter 6",
                                  "-i idrs -irestart 4 -maxiter 3",
                                  "-i orthomin -restart 5 -maxiter 9"])
def test_solver_options_at_maxiter_match_lis_tpu(opts):
    """Runs cut by -maxiter: inside BiCGSTAB(4)'s second cycle, inside
    IDR(4)'s start phase, and after Orthomin(5)'s ring has wrapped."""
    rj, rt = both("spd", opts + " -tol 1e-14")
    assert rt.status == rj.status == lis_tpu_torch.LIS_MAXITER
    assert_same(rj, rt, rtol=1e-9)


@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("n", [7, 1000])
def test_shadow_space_is_lis_tpus_bit_for_bit(s, n):
    got = shadow_space(s, n)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, _shadow_space(s, n, np.float64))
    _, t, _ = pair("spd")
    spec = SolverSpec(irestart=s)
    np.testing.assert_array_equal(prepare_idrs(t, spec).numpy(),
                                  _shadow_space(s, t.nrows, np.float64))
    np.testing.assert_array_equal(prepare_idr1(t, spec).numpy(),
                                  _shadow_space(1, t.nrows, np.float64))
