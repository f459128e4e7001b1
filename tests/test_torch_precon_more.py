"""The remaining preconditioners of lis_tpu in both packages, on the CPU:
ILUT, ILUC, block Jacobi, I+S, SAINV and hybrid (SA-AMG is in
tests/test_torch_saamg.py).

Host-side outputs (the native factors, the Python factors of complex
data, the I+S and block-Jacobi arrays) must be equal exactly.  psolve and
psolveh must agree with lis_tpu's to rtol 1e-12: both apply the same
factors in the same order of operations, and what differs is the order
of a row's sum.  Each linear preconditioner's psolveh must be the adjoint
of its psolve to 1e-12.  Solves must give lis_tpu's iteration count and
status, on a CSR and on an operator routed to DIA.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lis_tpu
from lis_tpu import _native as jnative
from lis_tpu.precon import hybrid as jhyb, ilu as jilu, is_precon as jis
from lis_tpu.precon import jacobi as jjac, sainv as jsainv
from lis_tpu.solvers import driver as jdrv
import lis_tpu_torch
from lis_tpu_torch import _native as tnative
from lis_tpu_torch.precon import hybrid as thyb, ilu as tilu
from lis_tpu_torch.precon import is_precon as tis, jacobi as tjac
from lis_tpu_torch.precon import sainv as tsainv
from lis_tpu_torch.precon.base import NonePrecon
from lis_tpu_torch.runtime.options import SolverOptions as TOptions
from lis_tpu_torch.solvers import driver as tdrv
from tests.test_torch_precon import (MATRICES, _built, _close, _j, _pair,
                                     _t, _vec)
from tests.test_torch_solve import assert_same

CREATE = {
    "ilut": (jilu.create_ilut, tilu.create_ilut),
    "iluc": (jilu.create_iluc, tilu.create_iluc),
    "bjacobi": (jjac.create_bjacobi, tjac.create_bjacobi),
    "is": (jis.create_is, tis.create_is),
    "sainv": (jsainv.create_sainv, tsainv.create_sainv),
    "hybrid": (jhyb.create_hybrid, thyb.create_hybrid),
}


def _create(kind, J, T, opts):
    create_j, create_t = CREATE[kind]
    return (create_j(J, lis_tpu.SolverOptions.from_string(opts)),
            create_t(T, TOptions.from_string(opts)))


# ---- host-side outputs --------------------------------------------------------

@pytest.mark.parametrize("name", ["nonsym", "random", "poisson3d27",
                                  "gamma"])
@pytest.mark.parametrize("drop,rate", [(0.05, 5.0), (0.01, 2.0)])
def test_native_factors_equal_lis_tpu(name, drop, rate):
    """ilut_factor, iluc_factor and sainv_factor of the port's loader and
    lis_tpu's: one C++ source, the same arrays bit for bit."""
    a = MATRICES[name]()
    args = (a.indptr, a.indices, a.data)
    for fn in ("ilut_factor", "iluc_factor"):
        fj = getattr(jnative, fn)(*args, drop, rate)
        ft = getattr(tnative, fn)(*args, drop, rate)
        for x, y in zip(ft, fj):
            np.testing.assert_array_equal(x, y)
    sj = jnative.sainv_factor(*args, drop)
    st = tnative.sainv_factor(*args, drop)
    for x, y in zip(st[0] + st[1] + (st[2],), sj[0] + sj[1] + (sj[2],)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["csym", "nonsym"])
def test_python_factors_equal_lis_tpu(name):
    """The Python factors (lis_tpu's path for complex data) give lis_tpu's
    rows and arrays exactly."""
    a = MATRICES[name]()
    if name == "nonsym":
        a = a[:150, :150].tocsr()
    args = (a.indptr, a.indices, a.data, a.shape[0])
    for fj, ft in ((jilu._factor_ilut, tilu._factor_ilut),
                   (jilu._factor_iluc, tilu._factor_iluc)):
        assert ft(*args, 0.05, 5.0) == fj(*args, 0.05, 5.0)
    sj = jsainv._factor_sainv_py(*args, 0.05)
    st = tsainv._factor_sainv_py(*args, 0.05)
    for x, y in zip(st[0] + st[1] + (st[2],), sj[0] + sj[1] + (sj[2],)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("opts", ["", "-is_m 1", "-is_m 6 -is_alpha 0.3"])
@pytest.mark.parametrize("name", ["nonsym", "csym", "poisson3d27"])
def test_is_arrays_equal_lis_tpu(name, opts):
    _, J, T = _built(name, "csr")
    Mj, Mt = _create("is", J, T, opts)
    np.testing.assert_array_equal(_t(Mt.index), _j(Mj.index))
    np.testing.assert_array_equal(_t(Mt.value), _j(Mj.value))
    assert Mt.index.dtype == torch.int32 and Mt.alpha == Mj.alpha


@pytest.mark.parametrize("bs", [1, 2, 3, 5])
@pytest.mark.parametrize("name", ["nonsym", "csym", "random"])
def test_bjacobi_blocks_equal_lis_tpu(name, bs):
    _, J, T = _built(name, "csr")
    opts = f"-storage_block {bs}"
    Mj, Mt = _create("bjacobi", J, T, opts)
    np.testing.assert_array_equal(_t(Mt.binv), _j(Mj.binv))
    assert Mt.n == T.nrows


def test_inv_blocks_singular_fallbacks_equal_lis_tpu():
    rng = np.random.default_rng(3)
    blocks = rng.standard_normal((5, 3, 3))
    blocks[2] = 0.0
    blocks[4, 1] = blocks[4, 0]
    for mode in ("pinv", "eye"):
        np.testing.assert_array_equal(tjac.inv_blocks(blocks.copy(), mode),
                                      jjac.inv_blocks(blocks.copy(), mode))


# ---- psolve, psolveh, adjointness ---------------------------------------------

PRECONS = [
    # (system, format, precon, options, the port's class)
    ("nonsym", "csr", "ilut", "", tilu.ILUPrecon),
    ("nonsym", "dia", "ilut", "", tilu.ILUDiaPrecon),
    ("random", "csr", "ilut", "-iluc_drop 0.01 -iluc_rate 2", tilu.ILUPrecon),
    ("csym", "csr", "ilut", "", tilu.ILUPrecon),
    ("nonsym", "csr", "iluc", "", tilu.ILUPrecon),
    ("poisson3d27", "dia", "iluc", "-ssor_sweeps 3", tilu.ILUDiaPrecon),
    ("csym", "csr", "iluc", "-iluc_rate 2", tilu.ILUPrecon),
    ("poisson3d27", "csr", "bjacobi", "-storage_block 3",
     tjac.BlockJacobiPrecon),
    ("csym", "csr", "bjacobi", "", tjac.BlockJacobiPrecon),
    ("nonsym", "dia", "bjacobi", "-storage_block 7", tjac.BlockJacobiPrecon),
    ("nonsym", "csr", "is", "", tis.ISPrecon),
    ("csym", "csr", "is", "-is_alpha 0.5 -is_m 2", tis.ISPrecon),
    ("poisson3d27", "dia", "is", "-is_level 0", NonePrecon),
    ("nonsym", "csr", "sainv", "", tsainv.SAINVPrecon),
    ("poisson3d27", "dia", "sainv", "-sainv_drop 0.01", tsainv.SAINVPrecon),
    ("csym", "csr", "sainv", "", tsainv.SAINVPrecon),
    ("poisson3d27", "csr", "hybrid", "", thyb.HybridPrecon),
    ("nonsym", "dia", "hybrid", "-hybrid_i gmres -hybrid_maxiter 5",
     thyb.HybridPrecon),
    ("nonsym", "csr", "hybrid",
     "-hybrid_i bicgstab -hybrid_maxiter 4 -hybrid_p ilu",
     thyb.HybridPrecon),
    ("nonsym", "dia", "hybrid", "-hybrid_p ssor -hybrid_tol 1e-6",
     thyb.HybridPrecon),
]
_IDS = [f"{p[0]}-{p[1]}-{p[2]}{p[3].replace(' ', '')}" for p in PRECONS]


@pytest.mark.parametrize("name,fmt,kind,opts,cls", PRECONS, ids=_IDS)
def test_psolve_and_psolveh_match_lis_tpu(name, fmt, kind, opts, cls):
    a, J, T = _built(name, fmt)
    Mj, Mt = _create(kind, J, T, opts)
    assert type(Mt) is cls
    r = _vec(a.shape[0], np.iscomplexobj(a.data))
    for meth in ("psolve", "psolveh"):
        zj = _j(getattr(Mj, meth)(jnp.asarray(r)))
        zt = getattr(Mt, meth)(torch.from_numpy(r))
        assert str(zt.dtype)[6:] == zj.dtype.name
        _close(_t(zt), zj, 1e-12)


@pytest.mark.parametrize("name,fmt,kind,opts,cls",
                         [p for p in PRECONS if p[2] != "hybrid"],
                         ids=[i for i, p in zip(_IDS, PRECONS)
                              if p[2] != "hybrid"])
def test_psolveh_is_the_adjoint(name, fmt, kind, opts, cls):
    """⟨M⁻¹x, y⟩ = ⟨x, M⁻ᴴy⟩ for every linear preconditioner (hybrid's
    inner solve stops on a tolerance, so it is not linear)."""
    a, _, T = _built(name, fmt)
    M = CREATE[kind][1](T, TOptions.from_string(opts))
    cplx = np.iscomplexobj(a.data)
    x = torch.from_numpy(_vec(a.shape[0], cplx, seed=21))
    y = torch.from_numpy(_vec(a.shape[0], cplx, seed=22))
    lhs = torch.vdot(M.psolve(x), y).item()
    rhs = torch.vdot(x, M.psolveh(y)).item()
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


def test_single_precision_casts_the_new_preconditioners():
    """M.to(dtype=float32) casts values and keeps index arrays (the -f
    single path); the psolve agrees with lis_tpu's to 1e-5."""
    a, J, T = _built("nonsym", "csr")
    r = _vec(a.shape[0], False)
    for kind, opts in (("ilut", ""), ("bjacobi", "-storage_block 3"),
                       ("is", ""), ("sainv", "")):
        Mj, Mt = _create(kind, J, T, opts)
        M32 = Mt.to(dtype=torch.float32)
        if kind == "is":
            assert M32.index.dtype == torch.int32
        zt = M32.psolve(torch.from_numpy(r).float())
        assert zt.dtype == torch.float32
        _close(_t(zt).astype(np.float64), _j(Mj.psolve(jnp.asarray(r))),
               1e-5)


# ---- scaling and solves --------------------------------------------------------

@pytest.mark.parametrize("opts", [
    "-p is", "-p is -scale 2", "-p is -scale 1 -storage 7",
    "-i cg -p jacobi -scale 1", "-p ilut -scale 1", "-p is -is_level 0",
    "-p sainv"])
def test_effective_scale_matches_lis_tpu(opts):
    """-p is forces Jacobi scaling (0 → 1) before any other rule."""
    assert tdrv._effective_scale(TOptions.from_string(opts)) == \
        jdrv._effective_scale(lis_tpu.SolverOptions.from_string(opts))


_SYS = {}


def _system(name):
    if name not in _SYS:
        a = MATRICES[name]()
        b = _vec(a.shape[0], np.iscomplexobj(a.data), seed=9)
        _SYS[name] = (a,) + _pair(a) + (b,)
    return _SYS[name]


SOLVES = [
    ("nonsym", "-i bicgstab -p ilut"),
    ("nonsym", "-i bicgstab -p iluc -iluc_drop 0.01"),
    ("poisson3d27", "-i cg -p ilut"),
    ("nonsym", "-i gmres -p sainv"),
    ("poisson3d27", "-i cg -p sainv"),
    ("nonsym", "-i bicgstab -p is"),
    ("nonsym", "-i bicgstab -p is -is_level 0"),
    ("nonsym", "-i bicg -p is -is_m 5"),
    ("nonsym", "-i bicgstab -p bjacobi -storage_block 4"),
    ("poisson3d27", "-i cg -p bjacobi"),
    ("poisson3d27", "-i cg -p hybrid"),
    ("nonsym", "-i gmres -p hybrid -hybrid_i gmres -hybrid_maxiter 5"),
    ("nonsym", "-i bicg -p hybrid -hybrid_p jacobi -hybrid_i bicgstab "
     "-hybrid_maxiter 3"),
]


@pytest.mark.parametrize("route", ["-auto_storage false", ""],
                         ids=["csr", "routed"])
@pytest.mark.parametrize("name,opts", SOLVES,
                         ids=[f"{n}{o.replace(' ', '')}" for n, o in SOLVES])
def test_solve_matches_lis_tpu(name, opts, route):
    """Iterations, status, history and x against lis_tpu; ``routed`` sends
    the banded operators to DIA (ILUT/ILUC then take the relaxed sweeps
    where their factors fit)."""
    a, J, T, b = _system(name)
    opts = f"{opts} {route} -tol 1e-10"
    rj = lis_tpu.solve(J, b, options=opts)
    rt = lis_tpu_torch.solve(T, b, options=opts)
    assert rj.status == lis_tpu.LIS_SUCCESS
    assert_same(rj, rt, rtol=1e-9)
    o = TOptions.from_string(opts)
    assert lis_tpu_torch.transform_operator(T, o).format_name == \
        ("csr" if route else "dia")


@pytest.mark.parametrize("kind", ["ilut", "iluc"])
def test_threshold_ilu_takes_the_dia_sweeps_when_the_factors_fit(kind):
    """ILUT/ILUC of a routed DIA operator apply by relaxed sweeps (kernels
    H and I on the card) when the factors fit on few diagonals, else by
    level plans, as lis_tpu's ``_maybe_dia_apply`` decides."""
    a, J, T = _built("nonsym", "dia")
    o = TOptions.from_string("")
    M = CREATE[kind][1](T, o)
    assert type(M) is tilu.ILUDiaPrecon and M.nsweeps == 2
    # factors on too many diagonals: the plan apply
    assert tilu._maybe_dia_apply(*tnative.ilut_factor(
        *T.to_csr_arrays(), 0.0, 50.0), T, o, max_nnd=3) is None


def test_hybrid_inner_solve_reads_the_host_each_step():
    """The inner solver runs ``krylov_loop`` as it is: one host read of
    its loop condition per inner iteration (recorded, not hidden)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    _, J, T = _built("poisson3d27", "csr")
    M = thyb.create_hybrid(T, TOptions.from_string(
        "-hybrid_i cg -hybrid_maxiter 4 -hybrid_tol 1e-30"))
    reads = [0]

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ == "_local_scalar_dense":
                reads[0] += 1
            return func(*args, **(kwargs or {}))
    r = torch.from_numpy(_vec(T.nrows, False))
    with Record():
        M.psolve(r)
    assert reads[0] >= 4


def test_options_reach_the_inner_solver():
    _, J, T = _built("nonsym", "csr")
    M = thyb.create_hybrid(T, TOptions.from_string(
        "-hybrid_i bicgstabl -hybrid_ell 3 -hybrid_tol 1e-5 "
        "-hybrid_maxiter 7 -hybrid_omega 1.1 -hybrid_restart 9"))
    Mj = jhyb.create_hybrid(J, lis_tpu.SolverOptions.from_string(
        "-hybrid_i bicgstabl -hybrid_ell 3 -hybrid_tol 1e-5 "
        "-hybrid_maxiter 7 -hybrid_omega 1.1 -hybrid_restart 9"))
    want = {k: getattr(Mj.spec, k) for k in ("solver", "tol", "maxiter",
                                              "restart", "ell", "omega",
                                              "conv_cond")}
    assert {k: getattr(M.spec, k) for k in want} == want
    assert M.M is None and M.At.format_name == "csr"
    assert np.array_equal(_t(M.At.value), _j(Mj.At.value))
