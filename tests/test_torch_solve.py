"""lis_tpu_torch.solve against lis_tpu.solve.

The same system and option string go through both packages: iteration
counts and statuses must be equal, rhistory and x agree to rtol 1e-9 at
-f double (summation orders differ, and a Krylov method amplifies the
difference a little) and to rtol 1e-5 at -f single (f32 rounding in two
different summation orders).  The system is the locality-free SPD
a + aᵀ + 4k·I of tests/test_torch_cst.py; convergence criteria, scaling,
-f single and the rest are in tests/test_torch_solve_modes.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import lis_tpu
import lis_tpu_torch
from lis_tpu_torch.runtime.options import SolverOptions as TOptions
from tests.test_torch_cst import spd


_SYSTEMS = {}


def system(n, k):
    """(scipy matrix, lis_tpu CSR, port CSR, b), built once per module."""
    if (n, k) not in _SYSTEMS:
        a = spd(n, k)
        args = (a.indptr, a.indices, a.data, a.shape)
        b = np.random.default_rng(n + k).standard_normal(n)
        _SYSTEMS[n, k] = (a, lis_tpu.CSRMatrix.from_csr_arrays(*args),
                          lis_tpu_torch.CSRMatrix.from_csr_arrays(
                              *args, device="cpu"), b)
    return _SYSTEMS[n, k]


def both(n, k, opts):
    a, J, T, b = system(n, k)
    return lis_tpu.solve(J, b, options=opts), \
        lis_tpu_torch.solve(T, b, options=opts)


def assert_same(rj, rt, rtol):
    """Equal counts and status; rhistory and x to ``rtol``.  A late
    history entry carries rounding of the order of eps * rhistory[0], so
    it is also allowed that much absolute difference."""
    assert rt.iters == rj.iters
    assert rt.status == rj.status
    assert isinstance(rt.x, torch.Tensor)
    rh = np.asarray(rj.rhistory)
    eps = np.finfo(rt.rhistory.dtype).eps
    np.testing.assert_allclose(rt.rhistory, rh, rtol=rtol,
                               atol=eps * rh[0])
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=rtol,
                               atol=rtol * np.abs(xj).max())
    np.testing.assert_allclose(rt.true_resid, rj.true_resid, rtol=1e-3)


@pytest.mark.parametrize("opts", [
    "",
    "-i cg -p jacobi -tol 1e-10 -maxiter 77",
    "-i cr -p none -storage cst -auto_storage false -conv_cond nrm1_b "
    "-tol_w 0.5 -scale symm_diag -f single -print out",
    "-i CG -p 1 -scale 1 -conv_cond 2 -initx_zeros 0 -storage 15",
    "-i bicgstab -p ilu -ilu_fill 2 -restart 30 -omega 1.2 -use_at true",
])
def test_options_parse_equal(opts):
    oj = lis_tpu.SolverOptions.from_string(opts)
    ot = TOptions.from_string(opts)
    assert dataclasses.asdict(ot) == dataclasses.asdict(oj)
    assert ot.solver_id == oj.solver_id and ot.precon_id == oj.precon_id


@pytest.mark.parametrize("grid", [(1 << 15, 5), (1 << 16, 8)],
                         ids=["n15k5", "n16k8"])
@pytest.mark.parametrize("storage", ["-storage cst", "-auto_storage false"])
@pytest.mark.parametrize("solver,precon", [("cg", "jacobi"), ("cg", "none"),
                                           ("cr", "jacobi"), ("cr", "none")])
def test_solve_matches_lis_tpu(grid, storage, solver, precon):
    rj, rt = both(*grid, f"-i {solver} -p {precon} {storage} -tol 1e-10")
    assert rj.status == lis_tpu.LIS_SUCCESS
    assert_same(rj, rt, rtol=1e-9)


@pytest.mark.parametrize("opts", [
    "-i cg -storage bes",
    "-i cg -storage bsr",
    "-i cg -storage bsc",
    "-i cg -storage vbr",
])
def test_formerly_unported_storage_matches_lis_tpu(opts):
    """The option strings that raised before the block formats and BES
    were ported now give lis_tpu's answer (n = 2^11: a locality-free BES
    takes a slab of W = 4096 columns per block of rows)."""
    rj, rt = both(1 << 11, 5, opts)
    assert rj.status == lis_tpu.LIS_SUCCESS
    assert_same(rj, rt, rtol=1e-9)


@pytest.mark.parametrize("opts", [
    "-i cg -storage msr",
    "-i cg -storage jad",
    "-i cg -storage cst -reorder rcm",
    "-i cg -storage cst -use_at true",
    "-i cg -storage ell",
])
def test_formerly_unported_paths_match_lis_tpu(opts):
    """The option strings that raised before the scalar formats, -reorder
    and -use_at were ported now give lis_tpu's answer."""
    rj, rt = both(1 << 15, 5, opts)
    assert rj.status == lis_tpu.LIS_SUCCESS
    assert_same(rj, rt, rtol=1e-9)
