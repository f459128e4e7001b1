"""The scipy bindings of lis_tpu_torch (``lis_tpu_torch.interop``) against
lis_tpu's, on the CPU.

The cases of ``tests/test_interop.py:20-72`` run through both packages on
poisson2d 15x15 (n = 225) with b = ones: x must agree with lis_tpu's to
1e-12 and info exactly.  The port's matrices live on the CPU here
(``set_default_device("cpu")`` for the module, restored after it).
"""

import numpy as np
import pytest
import scipy.sparse.linalg as sla
import torch

import lis_tpu
import lis_tpu.interop as J
import lis_tpu_torch
import lis_tpu_torch.interop as T
from lis_tpu_torch import config
from lis_tpu_torch.utils.testmat import poisson2d


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    prev = config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


@pytest.fixture(scope="module")
def spd():
    a = T.to_scipy(poisson2d(15, 15, device="cpu"))
    return a, np.ones(225)


def _agree(tx, jx, tol=1e-12):
    assert isinstance(tx, np.ndarray) and tx.shape == jx.shape
    np.testing.assert_allclose(tx, np.asarray(jx), rtol=tol,
                               atol=tol * np.abs(jx).max())


@pytest.mark.parametrize("case", [
    ("cg", dict(rtol=1e-10)),
    ("bicgstab", dict(rtol=1e-10, M="ilu")),
    ("gmres", dict(rtol=1e-10, restart=30)),
    ("cg", dict(rtol=1e-14, maxiter=3)),
    ("bicg", dict(rtol=1e-10, M="jacobi")),
    ("cgs", dict(rtol=1e-10)),
    ("minres", dict(rtol=1e-10)),
], ids=["cg", "bicgstab_ilu", "gmres_restart", "maxiter_info",
        "bicg_jacobi", "cgs", "minres"])
def test_solver_matches_lis_tpu(spd, case):
    name, kw = case
    a, b = spd
    tx, tinfo = getattr(T, name)(a, b, **kw)
    jx, jinfo = getattr(J, name)(a, b, **kw)
    assert tinfo == jinfo
    _agree(tx, jx)
    if kw.get("maxiter") == 3:
        assert tinfo > 0
    else:
        assert tinfo == 0
        assert np.linalg.norm(b - a @ tx) / np.linalg.norm(b) < 1e-9


def test_cg_matches_scipy(spd):
    a, b = spd
    x, info = T.cg(a, b, rtol=1e-10)
    xs, _ = sla.cg(a, b, rtol=1e-10)
    assert info == 0
    np.testing.assert_allclose(x, xs, atol=1e-7)


def test_callback_fires_once_with_the_final_iterate(spd):
    """As lis_tpu: once, with x (the port does not call it per
    iteration, which lis_tpu cannot)."""
    a, b = spd
    seen = {"T": [], "J": []}
    tx, _ = T.cg(a, b, rtol=1e-10, callback=lambda x: seen["T"].append(x))
    jx, _ = J.cg(a, b, rtol=1e-10, callback=lambda x: seen["J"].append(x))
    assert len(seen["T"]) == len(seen["J"]) == 1
    np.testing.assert_array_equal(seen["T"][0], tx)


@pytest.mark.parametrize("fmt", ["ell", "csr", "dia", "coo"])
def test_from_scipy_formats(spd, fmt):
    a, _ = spd
    m = T.from_scipy(a, matrix_type=fmt)
    mj = J.from_scipy(a, matrix_type=fmt)
    assert m.format_name == mj.format_name == fmt
    assert m.device.type == "cpu"
    np.testing.assert_allclose(np.asarray(m.to_dense()), a.toarray())
    np.testing.assert_allclose(T.to_scipy(m).toarray(), a.toarray())


def test_aslinearoperator(spd):
    a, b = spd
    op = T.aslinearoperator(T.from_scipy(a))
    opj = J.aslinearoperator(J.from_scipy(a))
    rng = np.random.default_rng(3)
    x = rng.standard_normal(225)
    np.testing.assert_allclose(op @ b, a @ b, rtol=1e-12)
    np.testing.assert_allclose(op.rmatvec(x), opj.rmatvec(x), rtol=1e-12)
    assert op.dtype == opj.dtype == np.float64


def test_user_supplied_precon_object(spd):
    """solve(M=<object>): an ILU(1) built by each package, fed to its own
    solve (the analogue of lis_precon_register user preconditioners)."""
    from lis_tpu.precon.ilu import create_iluk as j_iluk
    from lis_tpu.runtime.options import SolverOptions as JOpts
    from lis_tpu_torch.precon.ilu import create_iluk as t_iluk
    from lis_tpu_torch.runtime.options import SolverOptions as TOpts
    a, b = spd
    mt, mj = T.from_scipy(a), J.from_scipy(a)
    Mt = t_iluk(mt, TOpts.from_string("-ilu_fill 1"))
    Mj = j_iluk(mj, JOpts.from_string("-ilu_fill 1"))
    rt = lis_tpu_torch.solve(mt, b, options="-i cg -tol 1e-10", M=Mt)
    rj = lis_tpu.solve(mj, b, options="-i cg -tol 1e-10", M=Mj)
    assert rt.status == rj.status == 0 and rt.iters == rj.iters
    assert rt.true_resid < 1e-9
    _agree(rt.x.numpy(), rj.x)
    xt, info = T.cg(a, b, rtol=1e-10, M=Mt)
    assert info == 0
    _agree(xt, rt.x.numpy())


def test_complex_b_stays_complex():
    a = T.to_scipy(poisson2d(6, 6, device="cpu"))
    b = np.ones(36) + 1j * np.linspace(0, 1, 36)
    tx, tinfo = T.bicgstab(a, b, rtol=1e-10)
    jx, jinfo = J.bicgstab(a, b, rtol=1e-10)
    assert tinfo == jinfo == 0 and np.iscomplexobj(tx)
    _agree(tx, jx)


def test_matrix_built_here_lives_on_the_default_device():
    a = T.to_scipy(poisson2d(4, 4, device="cpu"))
    prev = config.set_default_device("meta")
    try:
        assert T.from_scipy(a).device.type == "meta"
    finally:
        config.set_default_device(prev)
    assert T.from_scipy(a, device="cpu").device == torch.device("cpu")
