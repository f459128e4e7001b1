"""SA-AMG in both packages, on the CPU: the host set-up (lattice
detection, aggregation, hierarchies), the plain versions of kernels J and
L (the coarse-grid transfers of the lattice path), the V-cycle and its
adjoint, and solves on the lattice and graph paths.

Host outputs must equal lis_tpu's (aggregates exactly; level operators,
prolongators and restrictions to 1e-14: both run the same scipy
products).  The transfers of J and L hold scipy's P exactly; J and L
must agree with lis_tpu's ``ImplicitP`` and with the assembled scipy P to
rtol 1e-13, and their plain versions sum in the kernels' order bit for
bit.  psolve and psolveh must agree with
lis_tpu's to rtol 1e-12, and solves must take lis_tpu's iteration count.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import lis_tpu
from lis_tpu.matrix.csr import CSRMatrix as JCSR
from lis_tpu.precon import saamg as js
from lis_tpu.solvers.driver import auto_storage as jauto
import lis_tpu_torch
from lis_tpu_torch.matrix.dia import DIAMatrix
from lis_tpu_torch.ops import amg as tamg
from lis_tpu_torch.precon import saamg as ts
from lis_tpu_torch.runtime.options import SolverOptions as TOptions
from tests.test_torch_precon import _close, _pair, _scipy, _t, _vec
from tests.test_torch_precon import nonsym_banded
from tests.test_torch_solve import assert_same


def lattice_op(dims, seed=0):
    """A nonsymmetric stencil operator on the lattice ``dims`` (1-D: 3
    points, 2-D: 9, 3-D: 27), diagonally dominant (scipy CSR)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(dims))
    coords = np.unravel_index(np.arange(n), dims)
    rows, cols, vals = [], [], []
    for digits in np.ndindex(*(3,) * len(dims)):
        d = np.array(digits) - 1
        nb = [c + di for c, di in zip(coords, d)]
        ok = np.all([(x >= 0) & (x < f) for x, f in zip(nb, dims)], axis=0)
        centre = not d.any()
        rows.append(np.arange(n)[ok])
        cols.append(np.ravel_multi_index([x[ok] for x in nb], dims))
        vals.append(np.full(ok.sum(), 3.0 ** len(dims)) if centre
                    else -rng.uniform(0.5, 1.0, ok.sum()))
    a = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                              np.concatenate(cols))),
                      shape=(n, n))
    a.sort_indices()
    return a


# ---- host set-up --------------------------------------------------------------

@pytest.mark.parametrize("case", [
    "p27-9x10x11", "p27-4x5x6", "lat-12x14", "lat-40", "p7-5x6x7",
    "tridiag", "random", "gamma", "diag", "band-wide"])
def test_detect_lattice_matches_lis_tpu(case):
    a = {
        "p27-9x10x11": lambda: _scipy("poisson3d27", 9, 10, 11),
        "p27-4x5x6": lambda: _scipy("poisson3d27", 4, 5, 6),
        "lat-12x14": lambda: lattice_op((12, 14)),
        "lat-40": lambda: lattice_op((40,)),
        "p7-5x6x7": lambda: _scipy("poisson3d", 5, 6, 7),
        "tridiag": lambda: sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1],
                                    shape=(50, 50)).tocsr(),
        "random": lambda: _scipy("random_sparse", 120, 0.05, 3),
        "gamma": lambda: _scipy("gamma_matrix", 50),
        "diag": lambda: sp.eye(60).tocsr(),
        "band-wide": lambda: nonsym_banded(400),
    }[case]()
    got = ts.detect_lattice(a)
    assert got == js.detect_lattice(a)
    # the gamma matrix is tridiagonal: a 1-D lattice
    want_some = case.startswith(("p27", "lat", "p7")) or case in (
        "tridiag", "gamma")
    assert (got is not None) == want_some


@pytest.mark.parametrize("name", ["poisson3d27", "random", "nonsym"])
def test_aggregates_and_strength_match_lis_tpu(name, monkeypatch):
    a = {"poisson3d27": lambda: _scipy("poisson3d27", 7, 8, 9),
         "random": lambda: _scipy("random_sparse", 200, 0.03, 3),
         "nonsym": lambda: nonsym_banded(300)}[name]()
    for theta in (0.05, 0.0125):
        S = ts._strength(a, theta)
        Sj = js._strength(a, theta)
        assert abs(S - Sj).max() == 0 if S.nnz else Sj.nnz == 0
        agg = ts._aggregate(S)
        np.testing.assert_array_equal(agg, js._aggregate(Sj))
        # the Python fallback gives the native aggregation's result
        from lis_tpu_torch import _native
        monkeypatch.setattr(_native, "amg_aggregate", lambda *a: None)
        np.testing.assert_array_equal(ts._aggregate(S), agg)
        monkeypatch.undo()


def _same_sparse(x, y, tol=1e-14):
    assert x.shape == y.shape
    scale = max(abs(y).max(), 1.0)
    assert abs(x - y).max() <= tol * scale


@pytest.mark.parametrize("dims", [(13, 12, 11), (25, 16), (60,)])
def test_lattice_hierarchy_matches_lis_tpu(dims):
    a = lattice_op(dims)
    lt, At = ts.build_hierarchy_lattice(a, dims)
    lj, Aj = js.build_hierarchy_lattice(a, dims)
    assert [l[0].shape for l in lt] == [l[0].shape for l in lj]
    for (A1, P1, fd1, cd1, wc1, d1), (A2, P2, fd2, cd2, wc2, d2) in zip(lt,
                                                                       lj):
        _same_sparse(A1, A2)
        _same_sparse(P1, P2)
        assert (fd1, cd1) == (fd2, cd2)
        np.testing.assert_array_equal(wc1, wc2)
        np.testing.assert_array_equal(d1, d2)
    _same_sparse(At, Aj)
    assert At.shape[0] <= 300


@pytest.mark.parametrize("unsym", [False, True])
@pytest.mark.parametrize("name", ["poisson3d27", "nonsym"])
def test_graph_hierarchy_matches_lis_tpu(name, unsym):
    a = {"poisson3d27": lambda: _scipy("poisson3d27", 8, 9, 10),
         "nonsym": lambda: nonsym_banded(500)}[name]()
    lt, At = ts.build_hierarchy(a, unsym=unsym)
    lj, Aj = js.build_hierarchy(a, unsym=unsym)
    assert len(lt) == len(lj) >= 1
    for (A1, P1, R1), (A2, P2, R2) in zip(lt, lj):
        _same_sparse(A1, A2)
        _same_sparse(P1, P2)
        assert (R1 is None) == (R2 is None) == (not unsym)
        if unsym:
            _same_sparse(R1, R2)
    _same_sparse(At, Aj)


# ---- kernels J and L: the plain versions ---------------------------------------

LATTICES = [(12, 12, 12), (13, 14, 16), (25, 17, 19), (20, 23), (50,),
            (3, 4, 5)]
_IDS = lambda d: "x".join(map(str, d))   # noqa: E731


def _level(dims, seed=0):
    """The finest lattice level in both packages: lis_tpu's ImplicitP on
    its routed DIA; the port's transfer and its implicit reference (DIA,
    dinv and tent); and scipy's P."""
    a = lattice_op(dims, seed)
    (Al, P, fd, cd, wc, dinv), = ts.build_hierarchy_lattice(
        a, dims, max_levels=2, coarse_size=1)[0]
    Aj = jauto(JCSR.from_csr_arrays(Al.indptr, Al.indices, Al.data,
                                    Al.shape))
    assert Aj.format_name == "dia"
    Pj = js.ImplicitP(A=Aj, dinv=jnp.asarray(dinv),
                      tent=js.LatticeTent(wc=jnp.asarray(wc), fdims=fd,
                                          cdims=cd))
    D = DIAMatrix.from_csr_arrays(Al.indptr, Al.indices, Al.data, Al.shape,
                                  device="cpu")
    tent = tamg.LatticeTent(wc=torch.from_numpy(wc), fdims=fd, cdims=cd)
    T = tamg.LatticeTransfer.from_scipy(P, device="cpu")
    return Pj, T, (D, torch.from_numpy(dinv), tent), P


@pytest.mark.parametrize("dims", LATTICES, ids=_IDS)
def test_transfer_unpacks_to_scipys_P(dims):
    """The transfer holds scipy's P and Pᵀ exactly, with int32 row
    pointers and columns, and ``-f single``'s cast keeps them int32."""
    _, T, _, P = _level(dims)
    assert (T.n, T.nc) == P.shape
    Pu = sp.csr_matrix((T.pval.numpy(), T.pcol.numpy(), T.pptr.numpy()),
                       shape=P.shape)
    Ru = sp.csr_matrix((T.rval.numpy(), T.rcol.numpy(), T.rptr.numpy()),
                       shape=P.shape[::-1])
    assert (Pu != P).nnz == 0 and (Ru != P.T).nnz == 0
    assert Pu.nnz == Ru.nnz == P.nnz
    for t in (T.pptr, T.pcol, T.rptr, T.rcol):
        assert t.dtype == torch.int32
    T32 = T.to(dtype=torch.float32)
    assert T32.pval.dtype == T32.rval.dtype == torch.float32
    assert T32.pcol.dtype == T32.rptr.dtype == torch.int32
    # a lattice row of P touches at most 8 boxes, a box at most 5^d rows
    assert int((T.pptr[1:] - T.pptr[:-1]).max()) <= 2 ** len(dims)
    assert int((T.rptr[1:] - T.rptr[:-1]).max()) <= 5 ** len(dims)


@pytest.mark.parametrize("dims", LATTICES, ids=_IDS)
def test_prolong_and_restrict_match_lis_tpu_and_scipy(dims):
    """J and L over the assembled P against lis_tpu's ImplicitP and
    scipy's P; the port's implicit reference against lis_tpu's too."""
    Pj, T, imp, P = _level(dims)
    n, nc = P.shape
    rng = np.random.default_rng(len(dims))
    ec, x, r = (rng.standard_normal(k) for k in (nc, n, n))
    got = tamg.lattice_prolong(T, torch.from_numpy(ec),
                               torch.from_numpy(x)).numpy()
    want_j = x + np.asarray(Pj.matvec(jnp.asarray(ec)))
    _close(got, want_j, 1e-13)
    _close(got, x + P @ ec, 1e-13)
    _close(tamg.implicit_prolong(*imp, torch.from_numpy(ec),
                                 torch.from_numpy(x)).numpy(), want_j, 1e-13)
    got = tamg.lattice_restrict(T, torch.from_numpy(r)).numpy()
    want_l = np.asarray(Pj.matvech(jnp.asarray(r)))
    _close(got, want_l, 1e-13)
    _close(got, P.T @ r, 1e-13)
    _close(tamg.implicit_restrict(*imp, torch.from_numpy(r)).numpy(),
           want_l, 1e-13)


@pytest.mark.parametrize("dims", [(13, 11, 10), (20, 23), (50,)], ids=_IDS)
def test_prolong_and_restrict_take_complex_vectors(dims):
    """A real level with complex vectors (a complex right-hand side on a
    real operator): the real and imaginary parts go through P apart, and
    each part equals the real transfer of that part bit for bit."""
    Pj, T, _, P = _level(dims)
    n, nc = P.shape
    rng = np.random.default_rng(5)
    ec = rng.standard_normal(nc) + 1j * rng.standard_normal(nc)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    got = tamg.lattice_prolong(T, torch.from_numpy(ec), torch.from_numpy(x))
    _close(got.numpy(), x + P @ ec, 1e-13)
    _close(got.numpy(), x + np.asarray(Pj.matvec(jnp.asarray(ec))), 1e-13)
    for part in (np.real, np.imag):
        assert torch.equal(part(got), tamg.lattice_prolong(
            T, torch.from_numpy(part(ec).copy()),
            torch.from_numpy(part(x).copy())))
    got = tamg.lattice_restrict(T, torch.from_numpy(x))
    _close(got.numpy(), P.T @ x, 1e-13)
    _close(got.numpy(), np.asarray(Pj.matvech(jnp.asarray(x))), 1e-13)
    for part in (np.real, np.imag):
        assert torch.equal(part(got), tamg.lattice_restrict(
            T, torch.from_numpy(part(x).copy())))


def _kernel_order(T, ec, x, r):
    """J and L written out as the kernels sum, one scalar at a time: J's
    row from 0 in column order, then x[i] + sum; L's lane l from 0 over
    entries l, l + 32, ..., then the lanes folded in halves."""
    pptr, pcol, pval = (t.numpy() for t in (T.pptr, T.pcol, T.pval))
    out = np.empty_like(x)
    for i in range(T.n):
        acc = 0.0
        for t in range(pptr[i], pptr[i + 1]):
            acc = acc + pval[t] * ec[pcol[t]]
        out[i] = x[i] + acc
    rptr, rcol, rval = (t.numpy() for t in (T.rptr, T.rcol, T.rval))
    rc = np.empty(T.nc)
    for c in range(T.nc):
        lanes = [0.0] * 32
        for t in range(rptr[c], rptr[c + 1]):
            lane = (t - rptr[c]) % 32
            lanes[lane] = lanes[lane] + rval[t] * r[rcol[t]]
        for half in (16, 8, 4, 2, 1):
            lanes = [lanes[k] + lanes[k + half] for k in range(half)]
        rc[c] = lanes[0]
    return out, rc


@pytest.mark.parametrize("dims", [(7, 8, 9), (20, 23), (50,)], ids=_IDS)
def test_plain_versions_sum_in_the_kernels_order(dims):
    """The plain versions equal J's and L's order of sums, written out
    scalar by scalar, bit for bit (the card's kernels are held to the
    plain versions bit for bit)."""
    _, T, _, P = _level(dims)
    rng = np.random.default_rng(11)
    ec, x, r = (rng.standard_normal(k) for k in (T.nc, T.n, T.n))
    want_j, want_l = _kernel_order(T, ec, x, r)
    got_j = tamg.lattice_prolong(T, torch.from_numpy(ec), torch.from_numpy(x))
    got_l = tamg.lattice_restrict(T, torch.from_numpy(r))
    np.testing.assert_array_equal(got_j.numpy(), want_j)
    np.testing.assert_array_equal(got_l.numpy(), want_l)


def test_nan_in_the_coarse_vector_reaches_only_its_rows():
    """No padded slot multiplies by zero: a NaN or Inf in ec[0] or r[0]
    reaches exactly the rows that hold column 0."""
    _, T, _, P = _level((13, 11, 10))
    ec, x, r = np.ones(T.nc), np.zeros(T.n), np.ones(T.n)
    ec[0], r[0] = np.nan, np.inf
    got_j = tamg.lattice_prolong(T, torch.from_numpy(ec), torch.from_numpy(x))
    got_l = tamg.lattice_restrict(T, torch.from_numpy(r))
    touch_j = np.asarray(P[:, 0].todense()).ravel() != 0
    touch_l = np.asarray(P[0, :].todense()).ravel() != 0
    np.testing.assert_array_equal(got_j.isnan().numpy(), touch_j)
    np.testing.assert_array_equal(~torch.isfinite(got_l).numpy(), touch_l)
    assert 0 < touch_j.sum() < T.n and 0 < touch_l.sum() < T.nc


def test_tent_box_sums_in_lexicographic_order():
    """Ptᵀ sums each box's points in lexicographic order, with the cropped
    edge boxes of dims not divisible by 3 (the implicit reference)."""
    dims, cdims = (4, 5), (2, 2)
    wc = torch.ones(4, dtype=torch.float64)
    tent = tamg.LatticeTent(wc=wc, fdims=dims, cdims=cdims)
    r = torch.arange(20, dtype=torch.float64)
    box = [[0, 1, 2, 5, 6, 7, 10, 11, 12], [3, 4, 8, 9, 13, 14],
           [15, 16, 17], [18, 19]]
    want = torch.tensor([float(sum(b)) for b in box], dtype=torch.float64)
    assert torch.equal(tent.matvech(r), want)
    assert torch.equal(tent.matvec(torch.arange(4.0, dtype=torch.float64)),
                       torch.tensor([0., 0, 0, 1, 1] * 3 + [2., 2, 2, 3, 3],
                                    dtype=torch.float64))


def test_kernel_wrappers_check_their_operands():
    _, T, _, P = _level((12, 12, 12))
    x = torch.zeros(T.n, dtype=torch.float64)
    ec = torch.zeros(T.nc, dtype=torch.float64)
    with pytest.raises(ValueError, match="lattice_prolong"):
        tamg.lattice_prolong(T, x, x)                  # ec of n points
    with pytest.raises(ValueError, match="lattice_restrict"):
        tamg.lattice_restrict(T, x[1:])
    with pytest.raises(ValueError, match="lattice_prolong"):
        tamg.lattice_prolong(T, ec.float(), x.float())  # f32 on f64 P
    with pytest.raises(ValueError, match="lattice_restrict"):
        tamg.lattice_restrict(T, x.to(torch.complex64))
    with pytest.raises(ValueError, match="lattice_restrict"):
        tamg.lattice_restrict(dataclasses.replace(T, rcol=T.rcol.long()), x)
    with pytest.raises(ValueError, match="2\\^31"):       # int32 indices
        tamg.LatticeTransfer.from_scipy(sp.coo_matrix((2 ** 31, 4)))
    # kernel J stages MAX_ROW = 8 entries a row of P, the most a lattice
    # row holds: rows of 8 pass, a row of 9 is refused
    full = tamg.LatticeTransfer.from_scipy(sp.csr_matrix(np.ones((4, 8))))
    assert (full.n, full.nc, full.pcol.numel()) == (4, 8, 32)
    bad = sp.lil_matrix((4, 12))
    bad[2, :tamg.MAX_ROW + 1] = 1.0
    with pytest.raises(ValueError, match="holds 9 entries"):
        tamg.LatticeTransfer.from_scipy(bad)


# ---- the V-cycle ----------------------------------------------------------------

CYCLES = [
    # (system, options, lattice path)
    ("lat3", "", True),
    ("lat3", "-saamg_smoother jacobi", True),
    ("lat2", "", True),
    ("lat3", "-saamg_lattice false", False),
    ("p27", "-saamg_lattice false -saamg_theta 0.1", False),
    ("nonsym", "-saamg_unsym true", False),
    ("nonsym", "-saamg_unsym true -saamg_smoother jacobi", False),
]
_SYSTEMS = {
    "lat3": lambda: lattice_op((13, 12, 10)),
    "lat2": lambda: lattice_op((40, 44)),
    "p27": lambda: _scipy("poisson3d27", 9, 9, 9),
    "nonsym": lambda: nonsym_banded(500),
}


def _pair_routed(a):
    J, T = _pair(a)
    return jauto(J), lis_tpu_torch.solvers.driver.auto_storage(T)


@pytest.mark.parametrize("name,opts,lattice", CYCLES,
                         ids=[f"{c[0]}{c[1].replace(' ', '')}" for c in CYCLES])
def test_psolve_and_psolveh_match_lis_tpu(name, opts, lattice):
    a = _SYSTEMS[name]()
    J, T = _pair_routed(a)
    Mj = js.create_saamg(J, lis_tpu.SolverOptions.from_string(opts))
    Mt = ts.create_saamg(T, TOptions.from_string(opts))
    assert len(Mt.levels) == len(Mj.levels)
    assert all((lv.transfer is not None) == lattice for lv in Mt.levels)
    assert Mt.coarse_inv.shape == Mj.coarse_inv.shape
    if lattice:
        # the finest level reuses the routed operator; every level is DIA
        assert Mt.levels[0].A is T
        assert all(lv.A.format_name == "dia" for lv in Mt.levels)
        sgs = "jacobi" not in opts
        assert all((lv.Ls is not None) == sgs for lv in Mt.levels)
    r = _vec(a.shape[0], False)
    for meth in ("psolve", "psolveh"):
        # one compiled program (lis_tpu's solvers run the cycle inside jit)
        zj = np.asarray(jax.jit(lambda M, v: getattr(M, meth)(v))(
            Mj, jnp.asarray(r)))
        zt = getattr(Mt, meth)(torch.from_numpy(r))
        _close(_t(zt), zj, 1e-12)


@pytest.mark.parametrize("opts", ["", "-saamg_unsym true"])
def test_psolveh_is_the_adjoint(opts):
    """⟨M⁻¹x, y⟩ = ⟨x, M⁻ᴴy⟩: the symmetric cycle is its own adjoint on a
    symmetric operator, and the Petrov-Galerkin hierarchy runs the
    transposed cycle."""
    a = _scipy("poisson3d27", 9, 9, 9) if not opts else nonsym_banded(500)
    _, T = _pair_routed(a)
    M = ts.create_saamg(T, TOptions.from_string(opts))
    x = torch.from_numpy(_vec(a.shape[0], False, seed=1))
    y = torch.from_numpy(_vec(a.shape[0], False, seed=2))
    lhs = torch.dot(M.psolve(x), y).item()
    rhs = torch.dot(x, M.psolveh(y)).item()
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


def test_lattice_level_counts_its_launch_calls(monkeypatch):
    """One V-cycle calls J and L once per lattice level, and the smoother's
    residuals are single sweeps (no separate product and subtraction)."""
    from lis_tpu_torch.precon import saamg as mod
    calls = {"J": 0, "L": 0, "relax": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(mod, "lattice_prolong",
                        count("J", tamg.lattice_prolong))
    monkeypatch.setattr(mod, "lattice_restrict",
                        count("L", tamg.lattice_restrict))
    monkeypatch.setattr(mod, "dia_relax", count("relax", mod.dia_relax))
    a = lattice_op((30, 31, 29))
    _, T = _pair_routed(a)
    M = ts.create_saamg(T, TOptions.from_string(""))
    M.psolve(torch.from_numpy(_vec(a.shape[0], False)))
    nl = len(M.levels)
    assert nl == 2 and calls["J"] == calls["L"] == nl
    assert calls["relax"] == 4 * nl       # the four residuals of a level


# ---- solves ----------------------------------------------------------------------

SOLVES = [
    ("p27", "-i cg -p saamg"),
    ("p27", "-i cg -p saamg -saamg_lattice false"),
    ("lat3", "-i cg -p saamg -saamg_smoother jacobi"),
    ("lat2", "-i bicgstab -p saamg"),
    ("nonsym", "-i bicgstab -p saamg -saamg_unsym true"),
    ("nonsym", "-i bicg -p saamg -saamg_unsym true"),
]


@pytest.mark.parametrize("name,opts", SOLVES,
                         ids=[f"{n}{o.replace(' ', '')}" for n, o in SOLVES])
def test_solve_matches_lis_tpu(name, opts):
    a = _SYSTEMS[name]()
    J, T = _pair(a)
    b = _vec(a.shape[0], False, seed=9)
    opts += " -tol 1e-10"
    rj = lis_tpu.solve(J, b, options=opts)
    rt = lis_tpu_torch.solve(T, b, options=opts)
    assert rj.status == lis_tpu.LIS_SUCCESS
    assert_same(rj, rt, rtol=1e-9)


def test_complex_operator_raises():
    from tests.test_torch_mainpath import csym_banded
    _, T = _pair(csym_banded(200))
    with pytest.raises(NotImplementedError, match="real-only"):
        lis_tpu_torch.solve(T, np.ones(200), options="-i bicg -p saamg")


def test_operator_that_does_not_coarsen_raises():
    """A diagonal operator has no strength structure: the aggregation
    stalls at the finest level (5000 rows > 4096), as in lis_tpu."""
    a = sp.diags(np.linspace(1.0, 2.0, 5000)).tocsr()
    J, T = _pair(a)
    with pytest.raises(ValueError, match="failed to coarsen"):
        js.create_saamg(J, lis_tpu.SolverOptions.from_string(""))
    with pytest.raises(ValueError, match="failed to coarsen"):
        lis_tpu_torch.solve(T, np.ones(5000), options="-i cg -p saamg")
