"""The hpcg slice's building blocks in both packages, on the CPU: the L/D/U
split, level-scheduled plans and triangular solves, the relaxed sweeps, and
the SSOR, ILU(k) and additive Schwarz preconditioners.

Host-side outputs (split arrays, plan arrays, ILU(0) factors) must be
equal exactly.  Vectors must agree to rtol 1e-13 at double and 1e-5 at
single: both packages apply a preconditioner in the same order of
operations, and what differs is the order of a row's sum.  On the CPU the
port runs the plain versions of kernels H, I and K.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import spsolve_triangular

import jax.numpy as jnp

import lis_tpu
from lis_tpu import _native as jnative
from lis_tpu.matrix.convert import convert_matrix as jconvert
from lis_tpu.matrix.split import split_matrix as jsplit
from lis_tpu.ops import trisolve as jts
from lis_tpu.precon.ads import wrap_additive_schwarz as jwrap
from lis_tpu.precon.ilu import create_iluk as jilu
from lis_tpu.precon.ssor import create_ssor as jssor
from lis_tpu.utils import testmat as jtm
import lis_tpu_torch
from lis_tpu_torch import _native as tnative
from lis_tpu_torch.matrix import dia as tdia
from lis_tpu_torch.matrix.split import split_matrix as tsplit
from lis_tpu_torch.ops import trisolve as tts
from lis_tpu_torch.precon.ads import wrap_additive_schwarz as twrap
from lis_tpu_torch.precon.ilu import ILUDiaPrecon, ILUPrecon
from lis_tpu_torch.precon.ilu import create_iluk as tilu
from lis_tpu_torch.precon.ssor import (SSORPrecon, SSORRelaxPrecon,
                                       create_ssor as tssor)
from lis_tpu_torch.runtime.options import SolverOptions as TOptions
from tests.test_torch_mainpath import csym_banded


def _pair(a):
    a = sp.csr_matrix(a)
    a.sort_indices()
    args = (a.indptr, a.indices, a.data, a.shape)
    return (lis_tpu.CSRMatrix.from_csr_arrays(*args),
            lis_tpu_torch.CSRMatrix.from_csr_arrays(*args, device="cpu"))


def _generated(name, *args):
    return getattr(jtm, name)(*args).to_csr_arrays()


def _scipy(name, *args):
    p, i, v = _generated(name, *args)
    n = len(p) - 1
    return sp.csr_matrix((np.asarray(v), np.asarray(i), np.asarray(p)),
                         shape=(n, n))


def nonsym_banded(n=400, seed=1):
    """Nonsymmetric, banded, diagonally dominant (scipy CSR)."""
    rng = np.random.default_rng(seed)
    offs = (-40, -7, -1, 1, 3, 25)
    d = [rng.uniform(-1, 1, n - abs(o)) for o in offs]
    return (sp.diags(d, offs, shape=(n, n)) + sp.diags(np.full(n, 7.0))
            ).tocsr()


MATRICES = {
    "poisson3d27": lambda: _scipy("poisson3d27", 6, 7, 8),
    "gamma": lambda: _scipy("gamma_matrix", 50),
    "random": lambda: _scipy("random_sparse", 120, 0.05, 3),
    "nonsym": nonsym_banded,
    "csym": lambda: csym_banded(200),
}


def _j(x):
    return np.asarray(x)


def _t(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _vec(n, cplx, seed=5):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    return v + 1j * rng.standard_normal(n) if cplx else v


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


# ---- split and plans --------------------------------------------------------

@pytest.mark.parametrize("name", ["poisson3d27", "gamma", "random", "csym"])
def test_split_and_merge_match_lis_tpu(name):
    J, T = _pair(MATRICES[name]())
    sj, st = jsplit(J), tsplit(T)
    for part in ("L", "U"):
        for a, b in zip(getattr(sj, part).to_csr_arrays(),
                        getattr(st, part).to_csr_arrays()):
            np.testing.assert_array_equal(_t(b), _j(a))
    np.testing.assert_array_equal(_t(st.D), _j(sj.D))
    np.testing.assert_array_equal(_t(st.Dinv), _j(sj.Dinv))
    assert st.D.device.type == "cpu" and st.n == T.nrows
    # and L + D + U gives A back
    a = MATRICES[name]()
    parts = [sp.csr_matrix(tuple(_t(t) for t in reversed(
        getattr(st, k).to_csr_arrays())), shape=a.shape) for k in "LU"]
    merged = parts[0] + parts[1] + sp.diags(_t(st.D))
    assert abs(merged - a).max() == 0


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("name", ["poisson3d27", "gamma", "random", "csym"])
def test_make_plan_equals_lis_tpu_and_trisolve_matches(name, lower):
    a = MATRICES[name]()
    n = a.shape[0]
    tri = (sp.tril(a, -1) if lower else sp.triu(a, 1)).tocsr()
    tri.sort_indices()
    d = a.diagonal()
    dinv = 1.0 / d
    pj = jts.make_plan(tri.indptr, tri.indices, tri.data, dinv, lower=lower)
    pt = tts.make_plan(tri.indptr, tri.indices, tri.data, dinv, lower=lower,
                       device="cpu")
    for f in ("rows", "cols", "vals", "dinv"):
        np.testing.assert_array_equal(_t(getattr(pt, f)), _j(getattr(pj, f)))
    assert pt.rows.dtype == pt.cols.dtype == torch.int32
    assert pt.nlev == pj.rows.shape[0] and pt.n == n
    b = _vec(n, np.iscomplexobj(a))
    xj = _j(jts.trisolve(pj, jnp.asarray(b)))
    xt = _t(tts.trisolve(pt, torch.from_numpy(b)))
    _close(xt, xj, 1e-13)
    full = (tri + sp.diags(d)).tocsr()
    _close(xt, spsolve_triangular(full, b, lower=lower), 1e-13)


def test_level_schedule_equals_lis_tpu():
    a = _scipy("poisson3d27", 9, 8, 7)
    for lower in (True, False):
        tri = (sp.tril(a, -1) if lower else sp.triu(a, 1)).tocsr()
        nj, lj = jnative.level_schedule(tri.indptr, tri.indices, lower)
        nt, lt = tnative.level_schedule(tri.indptr, tri.indices, lower)
        assert nt == nj
        np.testing.assert_array_equal(lt, lj)


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("name", ["poisson3d27", "random", "csym", "wide"])
def test_sliced_plan_layout(name, lower):
    """Kernel K's sliced-ELL copy of the plan: every row once, in level
    order and in units of 32 that hold one level each; a row's entries in
    its CSR order at stride 32; each unit padded to its own longest row;
    every column a row reads in an earlier level (so in an earlier unit);
    padding inert (row and column n, value and dinv 0).  ``wide`` has rows
    of up to about 40 entries (more than the kernel's chunk of 16)."""
    a = (_scipy("random_sparse", 120, 0.3, 3) if name == "wide"
         else MATRICES[name]())
    n = a.shape[0]
    tri = (sp.tril(a, -1) if lower else sp.triu(a, 1)).tocsr()
    tri.sort_indices()
    dinv = 1.0 / a.diagonal()
    pt = tts.make_plan(tri.indptr, tri.indices, tri.data, dinv, lower=lower,
                       device="cpu")
    U = tts.UNIT
    srows, sbase = _t(pt.srows), _t(pt.sbase).astype(np.int64)
    scols, svals, sdinv = _t(pt.scols), _t(pt.svals), _t(pt.sdinv)
    assert len(srows) == len(sdinv) == pt.nunits * U
    assert sbase[0] == 0 and sbase[-1] == len(scols) == len(svals)
    live = srows < n
    # every row once, in the padded plan's level order
    np.testing.assert_array_equal(srows[live], _t(pt.rows)[_t(pt.rows) < n])
    np.testing.assert_array_equal(np.sort(srows[live]), np.arange(n))
    np.testing.assert_array_equal(sdinv[live], dinv[srows[live]])
    assert not sdinv[~live].any()
    lev = np.empty(n, dtype=np.int64)
    for l, rl in enumerate(_t(pt.rows)):
        lev[rl[rl < n]] = l
    row_nnz = np.diff(tri.indptr)
    unit_lev = []
    for u in range(pt.nunits):
        rows = srows[u * U:(u + 1) * U]
        rl = rows[rows < n]
        assert len(rl) and len(set(lev[rl])) == 1      # one level per unit
        unit_lev.append(lev[rl[0]])
        width = (sbase[u + 1] - sbase[u]) // U
        assert (sbase[u + 1] - sbase[u]) % U == 0
        assert width == row_nnz[rl].max()       # padded to its longest row
        block_c = scols[sbase[u]:sbase[u + 1]].reshape(width, U)
        block_v = svals[sbase[u]:sbase[u + 1]].reshape(width, U)
        for t, i in enumerate(rows):
            k = row_nnz[i] if i < n else 0
            s, e = (tri.indptr[i], tri.indptr[i + 1]) if i < n else (0, 0)
            np.testing.assert_array_equal(block_c[:k, t], tri.indices[s:e])
            np.testing.assert_array_equal(block_v[:k, t], tri.data[s:e])
            assert (block_c[k:, t] == n).all() and not block_v[k:, t].any()
            if k:
                assert (lev[block_c[:k, t]] < lev[i]).all()
    assert unit_lev == sorted(unit_lev)                 # level-major
    assert pt.nunits == sum(-(-np.bincount(lev) // U))


def test_trisolve_rs_folds_the_scale():
    """trisolve(plan, b, rs) equals the plain version of b·rs bit for bit,
    real and complex (a real plan with complex b), on the CPU."""
    a = MATRICES["poisson3d27"]()
    tri = sp.triu(a, 1).tocsr()
    tri.sort_indices()
    pt = tts.make_plan(tri.indptr, tri.indices, tri.data,
                       1.0 / a.diagonal(), lower=False, device="cpu")
    rs = torch.from_numpy(_vec(a.shape[0], False, seed=8))
    for cplx in (False, True):
        b = torch.from_numpy(_vec(a.shape[0], cplx))
        want = tts._trisolve_plain(pt, b * rs)
        assert torch.equal(tts._trisolve_plain(pt, b, rs), want)
        assert torch.equal(tts.trisolve(pt, b, rs), want)
    with pytest.raises(ValueError, match="rs"):
        tts.trisolve(pt, b, rs[1:])


def test_ssor_psolve_folds_dtil_into_the_second_solve(monkeypatch):
    """The level-scheduled SSOR psolve is two triangular solves, the second
    with rs = D/ω, and no tensor operation of its own between them."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from lis_tpu_torch.precon import ssor as tssor_mod
    a, J, T = _built("poisson3d27", "csr")
    M = tssor(T, TOptions.from_string(""))
    calls, ops, inside = [], [], [False]

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not inside[0]:
                ops.append(str(func))
            return func(*args, **(kwargs or {}))

    def spy(plan, b, rs=None):
        calls.append((plan, rs))
        inside[0] = True
        try:
            return tts.trisolve(plan, b, rs)
        finally:
            inside[0] = False
    monkeypatch.setattr(tssor_mod, "trisolve", spy)
    r = torch.from_numpy(_vec(a.shape[0], False))
    with Record():
        z = M.psolve(r)
    assert [(p, q) for p, q in calls] == [(M.fwd, None), (M.bwd, M.dtil)]
    assert ops == []
    monkeypatch.undo()
    _close(z.numpy(), _j(jssor(J, lis_tpu.SolverOptions.from_string(""))
                          .psolve(jnp.asarray(r.numpy()))), 1e-13)


def test_relaxed_sweeps_match_lis_tpu():
    """lis_tpu's form ``relaxed_sweeps(L, U, dinv, b, nsweeps, lower)`` in
    both packages (H's series on a DIA triangle, lis_tpu's loop on any
    other format), and the port's series ``sweep_series`` that every
    sweep runs through, against lis_tpu's."""
    a = MATRICES["poisson3d27"]()
    J, T = _pair(a)
    Jd, Td = jconvert(J, "dia"), lis_tpu_torch.convert_matrix(T, "dia",
                                                              device="cpu")
    from lis_tpu.precon.ssor import _split_dia as jsplit_dia
    from lis_tpu_torch.precon.ssor import _split_dia as tsplit_dia
    Lj, Uj, dj = jsplit_dia(Jd)
    Lt, Ut, dt = tsplit_dia(Td)
    assert Lt.nnz == Lj.nnz and Ut.nnz == Uj.nnz
    assert Lt.value.data_ptr() == Td.value.data_ptr()       # a view
    st = tsplit(T)
    b = _vec(a.shape[0], False)
    for lower in (True, False):
        for ns in (0, 1, 2, 3):
            xj = _j(jts.relaxed_sweeps(Lj, Uj, 1.0 / dj, jnp.asarray(b), ns,
                                       lower))
            xt = tts.relaxed_sweeps(Lt, Ut, 1.0 / dt, torch.from_numpy(b),
                                    ns, lower)
            _close(_t(xt), xj, 1e-13)
            # the same with CSR triangles: lis_tpu's loop of matvecs
            xc = tts.relaxed_sweeps(st.L, st.U, 1.0 / dt,
                                    torch.from_numpy(b), ns, lower=lower)
            _close(_t(xc), xj, 1e-13)
            if ns:
                xs = tts.sweep_series(Lt if lower else Ut,
                                      torch.from_numpy(b), ns, w=1.0 / dt)
                assert torch.equal(xs, xt)
    # the defaults: two sweeps of the lower triangle
    _close(_t(tts.relaxed_sweeps(Lt, Ut, 1.0 / dt, torch.from_numpy(b))),
           _j(jts.relaxed_sweeps(Lj, Uj, 1.0 / dj, jnp.asarray(b))), 1e-13)


# ---- the sweep kernels' plain versions ---------------------------------------

def _dia_and_dense(rng, n, offs):
    """A random square DIA on the CPU and the same matrix dense."""
    val = rng.standard_normal((len(offs), n))
    cols = np.arange(n)[None, :] + np.array(offs)[:, None]
    val = val * ((cols >= 0) & (cols < n))
    T = tdia.DIAMatrix.from_diagonals(val, offs, (n, n), nnz=int(
        np.count_nonzero(val)), device="cpu")
    dense = np.zeros((n, n))
    for k, o in enumerate(offs):
        for i in range(n):
            if 0 <= i + o < n:
                dense[i, i + o] = val[k, i]
    return T, dense


@pytest.mark.parametrize("trans", [False, True])
def test_relax_plain_is_the_sweep_formula(trans):
    """dia_relax / dia_relaxh on the CPU against the formula written out
    with scipy: out = (rhs·rs − T·t)·w for every term mode."""
    rng = np.random.default_rng(7)
    n = 37
    T, dense = _dia_and_dense(rng, n, (-20, -3, -1, 2, 19))
    M = dense.T if trans else dense
    rhs, y, s, w, rs = (rng.standard_normal(n) for _ in range(5))
    fn = tdia.dia_relaxh if trans else tdia.dia_relax
    tt = {k: torch.from_numpy(v) for k, v in
          dict(rhs=rhs, y=y, s=s, w=w, rs=rs).items()}
    base = rhs * rs
    cases = [
        (dict(y=tt["y"], s=tt["s"], w=tt["w"], rs=tt["rs"]),
         (base - M @ (y * s)) * w),
        (dict(y=tt["y"]), rhs - M @ y),
        (dict(start=True, w=tt["w"], rs=tt["rs"]), (base - M @ (base * w)) * w),
        (dict(w=tt["w"]), rhs * w),
    ]
    for kw, want in cases:
        got = fn(T, tt["rhs"], **kw).numpy()
        _close(got, want, 1e-13)
    with pytest.raises(ValueError, match="start"):
        fn(T, tt["rhs"], tt["y"], start=True)


SERIES = {"w": ("w",), "w_rs": ("w", "rs"), "y_s": ("y", "s"),
          "none": ()}


@pytest.mark.parametrize("ns", [1, 3])
@pytest.mark.parametrize("case", list(SERIES))
@pytest.mark.parametrize("trans", [False, True])
def test_relaxed_sweeps_series_is_the_sweep_formula(trans, case, ns):
    """The series every SSOR, ILU(0) and GS/SOR sweep runs through against
    its loop written out with scipy: y ← (rhs·rs − T·(s⊙y))·w, ``ns``
    times, from the given y or else from (rhs·rs)·w."""
    rng = np.random.default_rng(11)
    n = 41
    T, dense = _dia_and_dense(rng, n, (-23, -4, -1))
    M = dense.T if trans else dense
    vecs = {k: rng.standard_normal(n) for k in ("rhs", "y", "s", "w", "rs")}
    on = SERIES[case]
    one = np.ones(n)
    rhs = vecs["rhs"] * (vecs["rs"] if "rs" in on else one)
    w = vecs["w"] if "w" in on else one
    s_ = vecs["s"] if "s" in on else one
    y = vecs["y"] if "y" in on else rhs * w
    want = None
    for _ in range(ns):
        want = y = (rhs - M @ (s_ * y)) * w
    got = tts.sweep_series(
        T, torch.from_numpy(vecs["rhs"]), ns, trans=trans,
        **{k: torch.from_numpy(vecs[k]) for k in on})
    _close(got.numpy(), want, 1e-13)


def test_relaxed_sweeps_refuses_what_it_cannot_run():
    T = tdia.DIAMatrix.from_diagonals(np.ones((1, 5)), (-1,), (5, 5), nnz=4,
                                      device="cpu")
    x = torch.ones(5, dtype=torch.float64)
    with pytest.raises(ValueError, match="nsweeps"):
        tts.sweep_series(T, x, 0)
    with pytest.raises(ValueError, match="start"):
        tts.sweep_series(T, x, 2, s=x)


# ---- preconditioners --------------------------------------------------------

def _built(name, fmt):
    a = MATRICES[name]()
    J, T = _pair(a)
    if fmt == "dia":
        J, T = jconvert(J, "dia"), lis_tpu_torch.convert_matrix(
            T, "dia", device="cpu")
    return a, J, T


def _create(kind, J, T, opts):
    oj = lis_tpu.SolverOptions.from_string(opts)
    ot = TOptions.from_string(opts)
    create_j, create_t = {"ssor": (jssor, tssor), "ilu": (jilu, tilu)}[kind]
    Mj, Mt = create_j(J, oj), create_t(T, ot)
    if oj.adds:
        Mj, Mt = jwrap(J, Mj, oj), twrap(T, Mt, ot)
    return Mj, Mt


PRECONS = [
    # (system, format, precon, options, the port's class)
    ("poisson3d27", "dia", "ssor", "", SSORRelaxPrecon),
    ("poisson3d27", "dia", "ssor", "-ssor_omega 1.2 -ssor_sweeps 3",
     SSORRelaxPrecon),
    ("nonsym", "dia", "ssor", "-ssor_sweeps 1", SSORRelaxPrecon),
    ("csym", "dia", "ssor", "", SSORRelaxPrecon),
    ("poisson3d27", "csr", "ssor", "", SSORPrecon),
    ("gamma", "csr", "ssor", "-ssor_omega 1.2", SSORPrecon),
    ("csym", "csr", "ssor", "", SSORPrecon),
    ("poisson3d27", "dia", "ilu", "", ILUDiaPrecon),
    ("nonsym", "dia", "ilu", "-ssor_sweeps 3", ILUDiaPrecon),
    ("csym", "dia", "ilu", "", ILUPrecon),
    ("poisson3d27", "dia", "ilu", "-ilu_fill 1", ILUPrecon),
    ("random", "csr", "ilu", "", ILUPrecon),
    ("nonsym", "csr", "ilu", "-ilu_fill 1", ILUPrecon),
    ("csym", "csr", "ilu", "-ilu_fill 0", ILUPrecon),
    ("csym", "csr", "ilu", "-ilu_fill 1", ILUPrecon),
    ("poisson3d27", "dia", "ssor", "-adds true", SSORRelaxPrecon),
    ("nonsym", "dia", "ssor", "-adds true -adds_iter 2", SSORRelaxPrecon),
    ("nonsym", "csr", "ilu", "-adds true -adds_iter 2", ILUPrecon),
]


def _ssor_inv_h(a, r, omega=1.0, nsweeps=None):
    """scipy's M⁻ᴴr for SSOR on ``a``: M = (D/ω + L)(I + ωD⁻¹U) solved
    exactly, or with ``nsweeps`` the operator of the relaxed form,
    P = G·(D/ω)·F with F = Σ_{k≤ns} (−WL)^k W and G = Σ_{k≤ns} (−WU)^k W
    (W = ω/D), whose adjoint Pᴴ r is what psolveh must give."""
    a = sp.csr_matrix(a)
    d = a.diagonal()
    L, U = sp.tril(a, -1).tocsr(), sp.triu(a, 1).tocsr()
    if nsweeps is None:
        M = (sp.diags(d / omega) + L) @ (sp.eye(a.shape[0])
                                         + omega * sp.diags(1 / d) @ U)
        return sp.linalg.spsolve(sp.csc_matrix(M.conj().T), r)
    W = np.diag(omega / d)

    def series(T):
        term, acc = W, W
        for _ in range(nsweeps):
            term = -W @ T.toarray() @ term
            acc = acc + term
        return acc
    P = series(U) @ np.diag(d / omega) @ series(L)
    return P.conj().T @ r


@pytest.mark.parametrize("name,fmt,kind,opts,cls", PRECONS,
                         ids=[f"{p[0]}-{p[1]}-{p[2]}{p[3].replace(' ', '')}"
                              for p in PRECONS])
def test_psolve_and_psolveh_match_lis_tpu(name, fmt, kind, opts, cls):
    """psolve and psolveh against lis_tpu's; SSOR's psolveh on complex data
    against scipy's M⁻ᴴr instead, since lis_tpu solves with Mᵀ there
    (ROADMAP queue 3)."""
    a, J, T = _built(name, fmt)
    Mj, Mt = _create(kind, J, T, opts)
    inner = getattr(Mt, "inner", Mt)
    assert type(inner) is cls
    cplx = np.iscomplexobj(a.data)
    r = _vec(a.shape[0], cplx)
    for meth in ("psolve", "psolveh"):
        zj = _j(getattr(Mj, meth)(jnp.asarray(r)))
        zt = getattr(Mt, meth)(torch.from_numpy(r))
        assert str(zt.dtype)[6:] == zj.dtype.name
        if kind == "ssor" and cplx and meth == "psolveh":
            ns = inner.nsweeps if cls is SSORRelaxPrecon else None
            _close(_t(zt), _ssor_inv_h(a, r, nsweeps=ns), 1e-12)
        else:
            _close(_t(zt), zj, 1e-13)


@pytest.mark.parametrize("fmt,cls", [("dia", SSORRelaxPrecon),
                                     ("csr", SSORPrecon)])
def test_complex_bicg_ssor_converges(fmt, cls):
    """BiCG + SSOR on a complex banded system with a complex diagonal:
    BiCG's shadow recurrence runs psolveh, so with Mᵀ in place of Mᴴ it
    stalls (lis_tpu: MAXITER after 2000 iterations).  Both SSOR forms
    must reach SUCCESS with a true residual within 1e-8."""
    from lis_tpu_torch.precon.base import create_precon
    from lis_tpu_torch.solvers.driver import transform_operator
    a = csym_banded(500, seed=3)
    _, T = _pair(a)
    if fmt == "dia":
        T = lis_tpu_torch.convert_matrix(T, "dia", device="cpu")
    b = _vec(a.shape[0], True, seed=4)
    opts = "-i bicg -p ssor -auto_storage false -maxiter 500"
    o = lis_tpu_torch.SolverOptions.from_string(opts)
    M = create_precon(o.precon, transform_operator(T, o), o)
    assert type(M) is cls
    res = lis_tpu_torch.solve(T, b, options=opts)
    assert res.status == lis_tpu.LIS_SUCCESS
    x = _t(res.x)
    assert np.linalg.norm(b - a @ x) <= 1e-8 * np.linalg.norm(b)


@pytest.mark.parametrize("name,fmt,kind,opts", [
    ("poisson3d27", "dia", "ssor", "-adds true"),
    ("poisson3d27", "csr", "ssor", ""),
    ("nonsym", "dia", "ilu", ""),
    ("nonsym", "csr", "ilu", "-ilu_fill 1"),
])
def test_single_precision_precon(name, fmt, kind, opts):
    """M.to(dtype=float32) casts the values and keeps every plan's int32
    rows and columns; its psolve agrees with lis_tpu's to 1e-5."""
    a, J, T = _built(name, fmt)
    Mj, Mt = _create(kind, J, T, opts)
    M32 = Mt.to(dtype=torch.float32)
    inner = getattr(M32, "inner", M32)
    for f in ("lower", "upper", "fwd", "bwd", "fwd_t", "bwd_t"):
        plan = getattr(inner, f, None)
        if plan is not None:
            for idx in ("rows", "cols", "srows", "sbase", "scols"):
                assert getattr(plan, idx).dtype == torch.int32
            for val in ("vals", "dinv", "svals", "sdinv"):
                assert getattr(plan, val).dtype == torch.float32
    r = _vec(a.shape[0], False)
    for meth in ("psolve", "psolveh"):
        zj = _j(getattr(Mj, meth)(jnp.asarray(r)))
        zt = getattr(M32, meth)(torch.from_numpy(r).float())
        assert zt.dtype == torch.float32
        _close(_t(zt).astype(np.float64), zj, 1e-5)


@pytest.mark.parametrize("name", ["poisson3d27", "nonsym"])
def test_ilu0_dia_factors_equal_lis_tpu(name):
    a, J, T = _built(name, "dia")
    lu_j = jnative.ilu0_dia(np.asarray(J.offsets), J.value_2d)
    lu_t = tnative.ilu0_dia(np.asarray(T.offsets), T.value_2d)
    np.testing.assert_array_equal(lu_t, lu_j)
    M = tilu(T, TOptions.from_string(""))
    full = torch.zeros_like(T.value)
    for k, off in enumerate(T.offsets):
        src = M.L if off < 0 else M.U
        if off != 0:
            full[k] = src.value[src.offsets.index(off)]
    k0 = T.offsets.index(0)
    full[k0] = 1.0 / M.udinv
    np.testing.assert_allclose(full.numpy(), lu_j, rtol=1e-15)
    # the factor leaves the operator's diagonals as they were
    np.testing.assert_array_equal(T.value.numpy(), J.value_2d)


def test_ilu_creation_without_native_matches(monkeypatch):
    """Without the native library, ILU(0) of a DIA takes the Python
    factorisation and stays a DIA apply; the result is the same."""
    a, J, T = _built("nonsym", "dia")
    M_native = tilu(T, TOptions.from_string(""))
    monkeypatch.setattr(tnative, "ilu0_dia", lambda *a: None)
    M_py = tilu(T, TOptions.from_string(""))
    assert type(M_py) is ILUDiaPrecon
    r = torch.from_numpy(_vec(a.shape[0], False))
    _close(M_py.psolve(r).numpy(), M_native.psolve(r).numpy(), 1e-13)


@pytest.mark.parametrize("opts", [
    "-i cg -p ssor -storage cst -tol 1e-10",
    "-i cg -p ilu -storage cst -tol 1e-10",
    "-i bicg -p ssor -storage hdi -tol 1e-10",
    "-i bicgstab -p ilu -ilu_fill 1 -storage css -tol 1e-10"])
def test_level_scheduled_precon_on_other_formats(opts):
    """SSOR and ILU(k) on CST, HDI and CSS operators take the level plans
    (kernel K on the card), as lis_tpu's do; x and counts match it."""
    from lis_tpu_torch.precon.base import create_precon
    from lis_tpu_torch.solvers.driver import transform_operator
    from tests.test_torch_solve import assert_same as assert_same_solve
    from tests.test_torch_solve import system
    a, J, T, b = system(1 << 12, 5)
    rj = lis_tpu.solve(J, b, options=opts)
    rt = lis_tpu_torch.solve(T, b, options=opts)
    assert rj.status == lis_tpu.LIS_SUCCESS
    assert_same_solve(rj, rt, rtol=1e-9)
    o = lis_tpu_torch.SolverOptions.from_string(opts)
    M = create_precon(o.precon, transform_operator(T, o), o)
    assert type(M) is (SSORPrecon if o.precon == "ssor" else ILUPrecon)
