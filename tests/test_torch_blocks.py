"""The block formats BSR, BSC and VBR in both packages, on the CPU: the
host build array for array (BSR's windows, slabs and spill; BSC's
transposed blocks; VBR's partitions and its ``fast`` BSR), the CSR round
trip, matvec and matvech on real and complex data to rtol 1e-13, the
generic diagonal and scalings, block ILU(k) of BSR and of a non-uniform
VBR (psolve and psolveh to rtol 1e-12), block Jacobi with a BSR's own
block size, and solves with -storage bsr|bsc|vbr and -scale 1 -storage
bsr: lis_tpu's status and count, x to rtol 1e-9.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lis_tpu
from lis_tpu.matrix.convert import convert_matrix as jconvert
from lis_tpu.precon import ilu as jilu, jacobi as jjac
import lis_tpu_torch
from lis_tpu_torch.interop.state import from_numpy_state
from lis_tpu_torch.matrix.convert import convert_matrix as tconvert
from lis_tpu_torch.precon import ilu as tilu, jacobi as tjac
from lis_tpu_torch.runtime.options import SolverOptions as TOptions

B3 = np.array([[4.0, 1.0, 0.5], [1.0, 3.0, 0.25], [0.5, 0.25, 2.0]])


def _canon(a):
    a = sp.csr_matrix(a)
    a.sum_duplicates()
    a.eliminate_zeros()
    a.sort_indices()
    return a


def poisson2d(g):
    t = sp.diags([-np.ones(g - 1), 2 * np.ones(g), -np.ones(g - 1)],
                 [-1, 0, 1])
    e = sp.eye(g)
    return sp.kron(t, e) + sp.kron(e, t)


def kron_block(g, block=B3, cut=0):
    """kron(poisson2d g×g, block): an SPD operator of 3 dofs a point, a
    block band (block displacements -g, -1, 0, 1, g); ``cut`` rows and
    columns dropped at the end (a size that no block divides)."""
    a = sp.kron(poisson2d(g), block).tocsr()
    n = a.shape[0] - cut
    return _canon(a[:n, :n])


def nonsym_block(g, seed=1):
    """kron'd block band with random nonsymmetric blocks, diagonally
    dominant."""
    rng = np.random.default_rng(seed)
    a = sp.kron(poisson2d(g), np.ones((3, 3))).tocoo()
    v = a.data * rng.uniform(0.2, 1.0, len(a.data))
    a = sp.coo_matrix((v, (a.row, a.col)), shape=a.shape)
    return _canon(a + sp.eye(a.shape[0]) * 12)


def scatter(n=200, seed=2):
    """Random scattered entries, no block band: the BSR spill alone."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=0.03, random_state=rng, format="csr")
    return _canon(a + sp.eye(n) * 5)


def rect(n=31, m=20, seed=3):
    rng = np.random.default_rng(seed)
    return _canon(sp.random(n, m, density=0.2, random_state=rng))


def cplx(a, seed=4):
    rng = np.random.default_rng(seed)
    b = a.astype(np.complex128).tocsr()
    b.data = b.data + 1j * rng.standard_normal(len(b.data))
    return b


SYSTEMS = {
    "kron": (lambda: kron_block(6), {"bnr": 3}),
    "kron_cut": (lambda: kron_block(6, cut=2), {"bnr": 3}),
    "nonsym": (lambda: nonsym_block(5), {"bnr": 3}),
    "scatter": (scatter, {"bnr": 2}),
    "rect": (rect, {"bnr": 2, "bnc": 3}),
    "bnr_ne_bnc": (lambda: kron_block(4), {"bnr": 2, "bnc": 3}),
    "complex": (lambda: cplx(kron_block(5)), {"bnr": 3}),
}


def pair(a):
    args = (a.indptr, a.indices, a.data, a.shape)
    return (lis_tpu.CSRMatrix.from_csr_arrays(*args),
            lis_tpu_torch.CSRMatrix.from_csr_arrays(*args, device="cpu"))


def converted(name, fmt):
    a, kw = SYSTEMS[name][0](), SYSTEMS[name][1]
    if fmt == "vbr":
        kw = {}
    J, T = pair(a)
    return a, jconvert(J, fmt, **kw), tconvert(T, fmt, device="cpu", **kw)


def _vec(n, complex_, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    return v + 1j * rng.standard_normal(n) if complex_ else v


def _close(got, want, rtol=1e-13):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1.0))


def leaves(J):
    arrays, statics = {}, {}
    for f in dataclasses.fields(J):
        val = getattr(J, f.name)
        if f.metadata.get("static"):
            statics[f.name] = val
        elif isinstance(val, tuple):
            arrays[f.name] = [np.asarray(v) for v in val]
        else:
            arrays[f.name] = np.asarray(val)
    return arrays, statics


@pytest.mark.parametrize("name", list(SYSTEMS))
@pytest.mark.parametrize("fmt", ["bsr", "bsc"])
def test_layout_matches_lis_tpu(fmt, name):
    a, J, T = converted(name, fmt)
    assert T.format_name == fmt and T.device.type == "cpu"
    arrays, statics = leaves(J)
    for k, want in arrays.items():
        got = getattr(T, k)
        if isinstance(want, list):
            assert len(got) == len(want), k
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), w, err_msg=k)
        else:
            assert got.numpy().dtype == want.dtype, k
            np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
    for k, want in statics.items():
        assert getattr(T, k) == want, k
    if fmt == "bsr" and name == "scatter":
        assert not T.slabs and T.has_spill
    if fmt == "bsr" and name == "kron":
        assert T.slabs and not T.has_spill
    for u, w in zip(T.to_csr_arrays(), J.to_csr_arrays()):
        np.testing.assert_array_equal(u, np.asarray(w))
    for u, w in zip(T.to_csr_arrays(), (a.indptr, a.indices, a.data)):
        np.testing.assert_array_equal(u, w)
    # the port's products on lis_tpu's own leaves
    S = from_numpy_state(fmt, arrays, statics, device="cpu")
    x = _vec(a.shape[1], False, 1)
    _close(S.matvec(torch.from_numpy(x)), a @ x)


@pytest.mark.parametrize("name", list(SYSTEMS))
@pytest.mark.parametrize("fmt", ["bsr", "bsc", "vbr"])
def test_products_match_lis_tpu(fmt, name):
    """matvec and matvech to rtol 1e-13 against lis_tpu and scipy, a
    complex vector on every matrix (all three formats promote)."""
    a, J, T = converted(name, fmt)
    n, m = a.shape
    for cx in (False, True):
        x, y = _vec(m, cx, 1), _vec(n, cx, 2)
        _close(T.matvec(torch.from_numpy(x)), a @ x)
        _close(T.matvech(torch.from_numpy(y)), a.conj().T @ y)
        _close(T.matvec(torch.from_numpy(x)), J.matvec(jnp.asarray(x)))
        _close(T.matvech(torch.from_numpy(y)), J.matvech(jnp.asarray(y)))


@pytest.mark.parametrize("fmt", ["bsr", "bsc", "vbr"])
def test_generic_methods_match_lis_tpu(fmt):
    """The diagonal, both scalings and the shift, each in the same format
    with the same block structure."""
    a, J, T = converted("nonsym", fmt)
    np.testing.assert_array_equal(T.get_diagonal().numpy(),
                                  np.asarray(J.get_diagonal()))
    s = np.abs(_vec(a.shape[0], False, 3)) + 0.5
    x = _vec(a.shape[0], False, 4)
    for meth in ("scale_rows", "scale_symm"):
        Ts = getattr(T, meth)(torch.from_numpy(s))
        Js = getattr(J, meth)(jnp.asarray(s))
        assert Ts.format_name == fmt
        if fmt != "vbr":
            assert (Ts.bnr, Ts.bnc) == (T.bnr, T.bnc)
        _close(Ts.matvec(torch.from_numpy(x)), Js.matvec(jnp.asarray(x)))
    Tsh = T.shift_diagonal(0.5)
    _close(Tsh.matvec(torch.from_numpy(x)), (a - 0.5 * sp.eye(a.shape[0])) @ x)


VBR_CASES = {
    # (matrix, partition or None for the automatic one)
    "auto_uniform": (lambda: kron_block(6), None),
    "auto_ragged": (lambda: _canon(sp.random(60, 60, density=0.1,
                                             random_state=5)
                                   + 4 * sp.eye(60)), None),
    "given": (lambda: kron_block(5, cut=1),
              (0, 2, 3, 7, 8, 12, 20, 21, 30, 33, 40, 50, 60, 74)),
}


def vbr_pair(name):
    mk, part = VBR_CASES[name]
    a = mk()
    J, T = pair(a)
    kw = {} if part is None else {"row_part": part, "col_part": part}
    return a, jconvert(J, "vbr", **kw), tconvert(T, "vbr", device="cpu",
                                                 **kw)


@pytest.mark.parametrize("name", list(VBR_CASES))
def test_vbr_partitions_and_fast_bsr_match_lis_tpu(name):
    a, J, T = vbr_pair(name)
    assert T.row_part == tuple(J.row_part)
    assert T.col_part == tuple(J.col_part)
    np.testing.assert_array_equal(T.bptr, np.asarray(J.bptr))
    np.testing.assert_array_equal(T.bindex, np.asarray(J.bindex))
    for k in ("ptr", "index", "value"):
        np.testing.assert_array_equal(getattr(T, k).numpy(),
                                      np.asarray(getattr(J, k)))
    assert (T.fast is None) == (J.fast is None)
    if T.fast is not None:
        assert T.fast.bnr == J.fast.bnr == 3
        for g, w in zip(T.fast.slabs, J.fast.slabs):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # fast and the CSR view give the same products
    x = _vec(a.shape[0], True, 6)
    slow = dataclasses.replace(T, fast=None)
    _close(T.matvec(torch.from_numpy(x)), slow.matvec(torch.from_numpy(x)))
    _close(T.matvech(torch.from_numpy(x)),
           slow.matvech(torch.from_numpy(x)))


# ---- preconditioners -------------------------------------------------------------

ILU_CASES = [
    ("bsr", "kron", 0), ("bsr", "kron", 1), ("bsr", "kron_cut", 0),
    ("bsr", "nonsym", 1), ("bsr", "complex", 0),
    ("vbr", "given", 0), ("vbr", "given", 1), ("vbr", "auto_ragged", 0),
    ("vbr", "large_block", 0),
]


def _ilu_operands(fmt, name):
    if fmt == "bsr":
        return converted(name, "bsr")
    if name == "large_block":
        # one block of 70 rows: D⁻¹ takes the padded batched product
        a = kron_block(5)
        part = (0, 70, 72, 75)
        J, T = pair(a)
        kw = {"row_part": part, "col_part": part}
        return a, jconvert(J, "vbr", **kw), tconvert(T, "vbr", device="cpu",
                                                     **kw)
    return vbr_pair(name)


@pytest.mark.parametrize("fmt,name,fill", ILU_CASES,
                         ids=[f"{f}-{n}-k{k}" for f, n, k in ILU_CASES])
def test_block_ilu_matches_lis_tpu(fmt, name, fill):
    a, J, T = _ilu_operands(fmt, name)
    opts = f"-ilu_fill {fill}"
    Mj = jilu.create_iluk(J, lis_tpu.SolverOptions.from_string(opts))
    Mt = tilu.create_iluk(T, TOptions.from_string(opts))
    # an all-1x1 partition takes the scalar ILU, as in lis_tpu
    want = tilu.ILUPrecon if name == "auto_ragged" else {
        "bsr": tilu.BlockILUPrecon, "vbr": tilu.VBlockILUPrecon}[fmt]
    assert isinstance(Mt, want) and type(Mj).__name__ == want.__name__
    if want is tilu.VBlockILUPrecon:
        assert (Mt.pbinv is not None) == (name == "large_block")
    cx = np.iscomplexobj(a.data)
    for seed in (7, 8):
        r = _vec(a.shape[0], cx, seed)
        for meth in ("psolve", "psolveh"):
            zj = jax.jit(lambda M, v: getattr(M, meth)(v))(Mj,
                                                          jnp.asarray(r))
            _close(getattr(Mt, meth)(torch.from_numpy(r)), zj, 1e-12)


def test_bjacobi_takes_the_bsr_block_size():
    a, J, T = converted("nonsym", "bsr")
    opts = "-storage_block 2"
    Mj = jjac.create_bjacobi(J, lis_tpu.SolverOptions.from_string(opts))
    Mt = tjac.create_bjacobi(T, TOptions.from_string(opts))
    assert Mt.binv.shape == tuple(np.asarray(Mj.binv).shape) == (
        a.shape[0] // 3, 3, 3)
    np.testing.assert_allclose(Mt.binv.numpy(), np.asarray(Mj.binv),
                               rtol=1e-14)


# ---- solves ----------------------------------------------------------------------

SOLVES = [
    ("kron", "-i cg -p bjacobi -storage bsr -storage_block 3"),
    ("kron", "-i cg -p ilu -storage bsr -storage_block 3"),
    ("kron", "-i cg -p ilu -ilu_fill 1 -storage vbr"),
    ("kron", "-i bicg -p jacobi -storage bsr -storage_block 3"),
    ("nonsym", "-i bicgstab -scale 1 -storage bsr -storage_block 3"),
    ("nonsym", "-i bicgstab -p ilu -scale 1 -storage bsr -storage_block 3"),
    ("kron", "-i cg -p jacobi -storage bsc -storage_block 3"),
    ("kron", "-i cg -p jacobi -storage vbr"),
    ("kron_cut", "-i cg -p ilu -storage bsr -storage_block 3"),
    ("nonsym", "-i bicg -p ilu -storage vbr"),
]


@pytest.mark.parametrize("name,opts", SOLVES,
                         ids=[f"{n}{o.replace(' ', '')}" for n, o in SOLVES])
def test_solve_matches_lis_tpu(name, opts):
    # g = 16: at g = 12 CG + Jacobi ends on the edge of -tol 1e-10, where
    # lis_tpu's own -storage bsc takes 82 iterations to its csr's 81
    a = {"kron": lambda: kron_block(16), "kron_cut": lambda: kron_block(
        16, cut=2), "nonsym": lambda: nonsym_block(16)}[name]()
    J, T = pair(a)
    b = _vec(a.shape[0], False, 9)
    opts += " -tol 1e-10"
    rj = lis_tpu.solve(J, b, options=opts)
    rt = lis_tpu_torch.solve(T, b, options=opts)
    assert rj.status == rt.status == lis_tpu.LIS_SUCCESS
    assert rt.iters == rj.iters
    # status, count and x: the block products sum in another order than
    # lis_tpu's einsums, and on these kron'd operators (eigenvalues of
    # high multiplicity) late residuals of the history part by more than
    # 1e-9 while x does not
    _close(rt.x, rj.x, 1e-9)


def test_block_scaling_scales_by_the_block_diagonal():
    """-scale 1 -storage bsr: the operator the solver iterates is
    D_b⁻¹A in BSR, as in lis_tpu, and its diagonal blocks are identities;
    -p is keeps the point scaling."""
    from lis_tpu.solvers.driver import transform_operator as jtransform
    from lis_tpu_torch.solvers.driver import transform_operator
    a = nonsym_block(6)
    J, T = pair(a)
    opts = "-i bicgstab -scale 1 -storage bsr -storage_block 3"
    Jr = jtransform(J, lis_tpu.SolverOptions.from_string(opts))
    Tr = transform_operator(T, TOptions.from_string(opts))
    assert Tr.format_name == "bsr" and Tr.bnr == 3
    for u, w in zip(Tr.to_csr_arrays(), Jr.to_csr_arrays()):
        np.testing.assert_allclose(u, np.asarray(w), rtol=1e-14)
    d = Tr.to_dense()
    for k in range(0, a.shape[0], 3):
        np.testing.assert_allclose(d[k:k + 3, k:k + 3], np.eye(3),
                                   atol=1e-14)
    from lis_tpu_torch.solvers.driver import _effective_scale, _is_bscale
    o = TOptions.from_string(opts + " -p is")
    assert not _is_bscale(o) and _effective_scale(o) == 1
