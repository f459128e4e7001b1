"""The twelve Krylov solvers of test_torch_krylov.py on a routed DIA
operator, against lis_tpu.

poisson3d27 at 12³ (1,728 rows, 27 diagonals) goes in as CSR and both
packages route it to DIA.  MINRES and Orthomin solve it as it is (SPD);
the other ten solve its nonsymmetric variant, with the lower diagonals
times 0.7, the upper ones times 1.3 and 28 on the diagonal (the system
chip_smoke.py solves at 96³), so that CRS, GPBiCR and BiCRSafe apply a
true transpose at setup.  Each with -p jacobi and with -p ssor (relaxed
sweeps on DIA): equal iteration counts and statuses, x to rtol 1e-9,
and rhistory to rtol 1e-8 above 16 eps of its largest entry
(``assert_same`` of test_torch_krylov.py).  The history's tolerance is
the looser one: the DIA product sums its 27 diagonals in another order
than XLA's fused loop, and over 16–34 iterations the IDR methods lift
the residual to 8x (IDR(2)) and 326x (IDR(1)) its start.  Measured:
1.4e-9 relative on IDR(2) + Jacobi, 2.3e-9 on CRS + Jacobi in another
run (the CPU's reductions split by thread), x within 2e-12.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import lis_tpu
import lis_tpu_torch
from lis_tpu.solvers.driver import transform_operator as jtransform
from lis_tpu_torch.runtime.options import SolverOptions as TOptions
from lis_tpu_torch.solvers.driver import transform_operator
from lis_tpu_torch.utils.testmat import poisson3d27
from tests.test_torch_krylov import NEW, assert_same

SPD = ("minres", "orthomin")

_PAIRS = {}


def pair(kind):
    """(lis_tpu CSR, port CSR on the CPU, b) of the 12³ system."""
    if kind not in _PAIRS:
        ptr, idx, val = poisson3d27(12, 12, 12, device="cpu").to_csr_arrays()
        n = len(ptr) - 1
        a = sp.csr_matrix((val, idx, ptr), shape=(n, n))
        if kind == "nonsym":
            c = a.tocoo()
            scale = np.where(c.col < c.row, 0.7,
                             np.where(c.col > c.row, 1.3, 28 / 26))
            a = sp.csr_matrix((c.data * scale, (c.row, c.col)), shape=(n, n))
        a.sort_indices()
        args = (a.indptr, a.indices, a.data, a.shape)
        _PAIRS[kind] = (lis_tpu.CSRMatrix.from_csr_arrays(*args),
                        lis_tpu_torch.CSRMatrix.from_csr_arrays(
                            *args, device="cpu"),
                        np.random.default_rng(5).standard_normal(n))
    return _PAIRS[kind]


@pytest.mark.parametrize("precon", ["jacobi", "ssor"])
@pytest.mark.parametrize("solver", NEW)
def test_routed_dia_solve_matches_lis_tpu(solver, precon):
    J, T, b = pair("spd" if solver in SPD else "nonsym")
    opts = f"-i {solver} -p {precon} -tol 1e-10 -maxiter 2000"
    assert jtransform(J, lis_tpu.SolverOptions.from_string(opts)) \
        .format_name == "dia"
    assert transform_operator(T, TOptions.from_string(opts)) \
        .format_name == "dia"
    rj, rt = lis_tpu.solve(J, b, options=opts), \
        lis_tpu_torch.solve(T, b, options=opts)
    assert rj.status == lis_tpu.LIS_SUCCESS
    assert_same(rj, rt, rtol=1e-9, last=solver != "tfqmr", ulps=16,
                rh_rtol=1e-8)
