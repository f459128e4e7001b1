"""The port's auto_storage against lis_tpu's: the same matrix must take
the same route (the format of the operator that is iterated), BES
included, and the routed solves must give lis_tpu's answers.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lis_tpu
from lis_tpu.solvers.driver import transform_operator as jtransform
import lis_tpu_torch
from lis_tpu_torch.runtime.options import SolverOptions as TOptions
from lis_tpu_torch.solvers.driver import auto_storage, transform_operator
from tests.test_torch_cst import spd
from tests.test_torch_dia import MATRICES, power_law, quasi_banded


def windowed(n, w, seed=0, symmetric=True):
    """6 random columns per row within ±w of the diagonal, symmetrised or
    not, diagonally dominant."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 6)
    cols = np.clip(rows + rng.integers(-w, w, n * 6), 0, n - 1)
    a = sp.coo_matrix((rng.standard_normal(n * 6), (rows, cols)),
                      shape=(n, n)).tocsr()
    a = ((a + a.T if symmetric else a) + sp.eye(n) * 30).tocsr()
    a.sort_indices()
    return a


CASES = {
    # name: (matrix, route of lis_tpu, route of the port)
    "banded_3d27": (MATRICES["poisson3d27"], "dia", "dia"),
    "banded_2d": (MATRICES["poisson2d"], "dia", "dia"),
    "banded_nonsym": (MATRICES["gamma"], "dia", "dia"),
    "quasi_banded": (quasi_banded, "hdi", "hdi"),
    "locality_free": (lambda: spd(1 << 15, 5), "cst", "cst"),
    "windowed_css": (lambda: windowed(1 << 15, 2000, symmetric=False),
                     "css", "css"),
    "power_law": (power_law, "csr", "csr"),
    # general banded sparsity: dense sliding slabs
    "bes_small": (lambda: windowed(4000, 30), "bes", "bes"),
    "bes_large": (lambda: windowed(1 << 15, 40), "bes", "bes"),
}

_BUILT = {}


def pair(name):
    """(scipy matrix, lis_tpu CSR, port CSR), built once per module."""
    if name not in _BUILT:
        a = CASES[name][0]().tocsr()
        a.sort_indices()
        args = (a.indptr, a.indices, a.data, a.shape)
        _BUILT[name] = (a, lis_tpu.CSRMatrix.from_csr_arrays(*args),
                        lis_tpu_torch.CSRMatrix.from_csr_arrays(
                            *args, device="cpu"))
    return _BUILT[name]


@pytest.mark.parametrize("name", list(CASES))
def test_route_matches_lis_tpu(name):
    a, J, T = pair(name)
    _, jroute, troute = CASES[name]
    opts = "-i cg -p jacobi"
    Jr = jtransform(J, lis_tpu.SolverOptions.from_string(opts))
    Tr = transform_operator(T, TOptions.from_string(opts))
    assert Jr.format_name == jroute
    assert Tr.format_name == troute
    assert Tr.device.type == "cpu"
    x = np.random.default_rng(1).standard_normal(a.shape[0])
    np.testing.assert_allclose(Tr.matvec(torch.from_numpy(x)).numpy(),
                               a @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["bes_small", "bes_large"])
def test_bes_difference_gives_equal_answers(name):
    """Where lis_tpu iterates on BES the port iterates on BES too, with the
    same window: same status and iteration count, x to rtol 1e-9."""
    a, J, T = pair(name)
    b = np.random.default_rng(2).standard_normal(a.shape[0])
    opts = "-i cg -p jacobi -tol 1e-10"
    Jr = jtransform(J, lis_tpu.SolverOptions.from_string(opts))
    Tr = transform_operator(T, TOptions.from_string(opts))
    assert (Tr.W, Tr.c0, Tr.s) == (Jr.W, Jr.c0, Jr.s)
    rj, rt = lis_tpu.solve(J, b, options=opts), \
        lis_tpu_torch.solve(T, b, options=opts)
    assert rj.status == rt.status == lis_tpu.LIS_SUCCESS
    assert rt.iters == rj.iters
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=1e-9,
                               atol=1e-9 * np.abs(xj).max())


@pytest.mark.parametrize("solver,has_at", [("cg", False), ("bicgstab", False),
                                           ("bicg", True), ("bicr", True),
                                           ("crs", False), ("gpbicr", False),
                                           ("bicrsafe", False)])
def test_cst_route_builds_the_transpose_grid_only_on_need(solver, has_at):
    """cg gives ``at is None``; bicg and bicr, which apply Aᴴ every
    iteration, get a transpose grid — as in lis_tpu.  crs, gpbicr and
    bicrsafe apply Aᴴ once, at setup, and ride the scatter."""
    a, J, T = pair("locality_free")
    for M in (J, T):                      # a fresh cache for each solver
        M.__dict__.pop("_auto_dia", None)
    opts = f"-i {solver} -p jacobi"
    Jr = jtransform(J, lis_tpu.SolverOptions.from_string(opts))
    Tr = transform_operator(T, TOptions.from_string(opts))
    assert Jr.format_name == Tr.format_name == "cst"
    assert (Jr.at is not None) == (Tr.at is not None) == has_at
    assert Tr.Kp == Jr.Kp and Tr.n_pad == Jr.n_pad


@pytest.mark.parametrize("precision", ["quad", "switch", "df", "switch_df"])
def test_dd_modes_route_as_if_at_were_needed(precision):
    """lis_tpu routes every double-double mode as a solver that applies
    Aᴴ each iteration (driver.py:359-360): cg gets a transpose grid under
    -f quad, switch, df and switch_df, in both packages."""
    a, J, T = pair("locality_free")
    for M in (J, T):
        M.__dict__.pop("_auto_dia", None)
    opts = f"-i cg -p jacobi -f {precision}"
    Jr = jtransform(J, lis_tpu.SolverOptions.from_string(opts))
    Tr = transform_operator(T, TOptions.from_string(opts))
    assert Jr.format_name == Tr.format_name == "cst"
    assert Jr.at is not None and Tr.at is not None


def test_route_cache_hit_and_need_at_upgrade():
    a, J, T = pair("locality_free")
    T.__dict__.pop("_auto_dia", None)
    first = auto_storage(T, need_at=False)
    assert first.format_name == "cst" and first.at is None
    assert auto_storage(T, need_at=False) is first          # cache hit
    up = auto_storage(T, need_at=True)                      # rebuilt with at
    assert up is not first and up.at is not None
    assert auto_storage(T, need_at=True) is up
    assert auto_storage(T, need_at=False) is up             # at does no harm
    x = np.random.default_rng(3).standard_normal(a.shape[0])
    np.testing.assert_allclose(up.matvech(torch.from_numpy(x)).numpy(),
                               a.T @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["banded_2d", "quasi_banded", "power_law"])
def test_route_cache_on_the_matrix_object(name):
    """The routed operator (or the refusal) is cached on the matrix it
    was computed for; a copy made by .to() starts without it."""
    a, J, T = pair(name)
    T.__dict__.pop("_auto_dia", None)
    out = auto_storage(T)
    assert auto_storage(T) is out
    cached = T.__dict__["_auto_dia"]
    assert cached is (False if out is T else out)
    assert "_auto_dia" not in T.to("cpu").__dict__
    assert "_auto_dia" not in T.to(dtype=torch.float32).__dict__
    # dia and hdi inputs are left as they are
    if out.format_name in ("dia", "hdi"):
        assert auto_storage(out) is out


def test_auto_storage_false_and_explicit_storage_bypass_the_router():
    a, J, T = pair("banded_2d")
    for opts, route in (("-auto_storage false", "csr"), ("-storage cst", "cst"),
                        ("-storage css", "css"), ("-storage hdi", "hdi"),
                        ("-storage dia", "dia"), ("", "dia")):
        Tr = transform_operator(T, TOptions.from_string(opts))
        assert Tr.format_name == route
        Jr = jtransform(J, lis_tpu.SolverOptions.from_string(opts))
        assert Jr.format_name == route

