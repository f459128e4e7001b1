"""The lis.h compatibility layer of lis_tpu_torch against lis_tpu's, on the
CPU.

Each flow of ``tests/test_compat.py`` (the reference's test4.c and friends)
runs once through ``lis_tpu.compat`` and once through
``lis_tpu_torch.compat`` on the same numpy inputs, and the port is held to
lis_tpu: ids, names, sizes, ranges, statuses and iteration counts exactly,
vectors and scalars to rtol 1e-12, eigenvalues to 1e-10.  The port's
handles run on the CPU here (``set_default_device("cpu")`` for the
module, restored after it).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import lis_tpu
import lis_tpu.compat as J
import lis_tpu_torch
import lis_tpu_torch.compat as T
from lis_tpu_torch import config

RTOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    prev = config.set_default_device("cpu")
    yield
    config.set_default_device(prev)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(want).max()
                                               if want.size else 1.0))


def _vec(lis, arr):
    """A device array of ``arr`` in the package of ``lis``."""
    return torch.from_numpy(np.array(arr)) if lis is T else jnp.asarray(arr)


def _solve_fn(lis):
    return lis_tpu_torch.solve if lis is T else lis_tpu.solve


def _both(flow, **kw):
    return flow(J, **kw), flow(T, **kw)


def _same(j, t, exact=(), close=(), rtol=RTOL):
    for k in exact:
        assert t[k] == j[k], (k, t[k], j[k])
    for k in close:
        _close(t[k], j[k], rtol)


# ---- test4.c ---------------------------------------------------------------

def flow_test4(lis):
    n = 12
    lis.lis_initialize([])
    A = lis.lis_matrix_create(0)
    st_size = lis.lis_matrix_set_size(A, 0, n)
    for i in range(n):
        if i > 0:
            lis.lis_matrix_set_value(lis.LIS_INS_VALUE, i, i - 1, -1.0, A)
        if i < n - 1:
            lis.lis_matrix_set_value(lis.LIS_INS_VALUE, i, i + 1, -1.0, A)
        lis.lis_matrix_set_value(lis.LIS_INS_VALUE, i, i, 2.0, A)
    lis.lis_matrix_set_type(A, lis.LIS_MATRIX_CSR)
    st_asm = lis.lis_matrix_assemble(A)
    b = lis.lis_vector_create(0)
    x = lis.lis_vector_create(0)
    lis.lis_vector_set_size(b, 0, n)
    lis.lis_vector_set_size(x, 0, n)
    u = lis.lis_vector_duplicate(b)
    lis.lis_vector_set_all(1.0, u)
    lis.lis_matvec(A, u, b)
    solver = lis.lis_solver_create()
    lis.lis_solver_set_option("-i bicg -print none -tol 1e-12", solver)
    st = lis.lis_solve(A, b, x, solver)
    return dict(st=(st_size, st_asm, st), iters=lis.lis_solver_get_iter(
        solver), iterex=lis.lis_solver_get_iterex(solver),
        resid=lis.lis_solver_get_residualnorm(solver),
        status=lis.lis_solver_get_status(solver),
        name=lis.lis_solver_get_solvername(lis.lis_solver_get_solver(solver)),
        x=lis.lis_vector_get_values(x, 0, n), b=lis.lis_vector_gather(b),
        rh=lis.lis_solver_get_rhistory(solver))


def test_test4_flow():
    j, t = _both(flow_test4)
    _same(j, t, exact=("st", "iters", "iterex", "status", "name"),
          close=("x", "b", "rh", "resid"))
    assert t["name"] == "bicg" and t["iters"] <= 12
    assert isinstance(t["x"], np.ndarray)


# ---- set_csr + esolve --------------------------------------------------------

def flow_set_csr_esolve(lis):
    n = 64
    a = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n), format="csr")
    a.sort_indices()
    A = lis.lis_matrix_create(0)
    lis.lis_matrix_set_size(A, 0, n)
    lis.lis_matrix_set_csr(a.nnz, a.indptr, a.indices, a.data.astype(float),
                           A)
    lis.lis_matrix_assemble(A)
    x = lis.lis_vector_create(0)
    lis.lis_vector_set_size(x, 0, n)
    es = lis.lis_esolver_create()
    lis.lis_esolver_set_option("-e li -ss 2 -etol 1e-9", es)
    st, ev = lis.lis_esolve(A, x, es)
    xv = lis.lis_vector_get_values(x, 0, n)
    return dict(st=st, ev=ev, iters=lis.lis_esolver_get_iter(es),
                nnz=lis.lis_matrix_get_nnz(A),
                esolver=lis.lis_esolver_get_esolver(es),
                resid=np.linalg.norm(a @ xv - ev * xv),
                evs=lis.lis_esolver_get_evalues(es))


def test_set_csr_and_esolve():
    j, t = _both(flow_set_csr_esolve)
    _same(j, t, exact=("st", "iters", "nnz", "esolver"))
    _close(t["ev"], j["ev"], 1e-10)
    _close(t["evs"], j["evs"], 1e-10)
    assert t["resid"] < 1e-7


# ---- I/O round trip ----------------------------------------------------------

def flow_io(lis, tmp):
    n = 10
    A = lis.lis_matrix_create(0)
    lis.lis_matrix_set_size(A, 0, n)
    for i in range(n):
        lis.lis_matrix_set_value(lis.LIS_INS_VALUE, i, i, float(i + 1), A)
    lis.lis_matrix_assemble(A)
    f = str(tmp / f"a_{lis.__name__}.mtx")
    lis.lis_output(A, None, None, "mm", f)
    B = lis.lis_matrix_create(0)
    lis.lis_input(B, None, None, f)
    d = lis.lis_vector_create(0)
    lis.lis_matrix_get_diagonal(B, d)
    v = lis.lis_vector_create(0)
    lis.lis_vector_set_size(v, 0, n)
    lis.lis_vector_set_values2(lis.LIS_INS_VALUE, 0, n,
                               np.linspace(1.0, 2.0, n), v)
    fv = str(tmp / f"v_{lis.__name__}.txt")
    lis.lis_output_vector(v, 1, fv)
    w = lis.lis_vector_create(0)
    lis.lis_input_vector(w, fv)
    return dict(d=lis.lis_vector_get_values(d, 0, n), n=B.n,
                w=lis.lis_vector_gather(w), text=open(fv).read().split())


def test_io_roundtrip(tmp_path):
    j, t = flow_io(J, tmp_path), flow_io(T, tmp_path)
    _same(j, t, exact=("n",), close=("d", "w"))
    np.testing.assert_allclose(t["d"], np.arange(1.0, 11.0))
    np.testing.assert_allclose(np.array(t["text"], float),
                               np.array(j["text"], float), rtol=RTOL)


# ---- PSD (test8f.F90) --------------------------------------------------------

def flow_psd(lis):
    n = 40
    A = lis.lis_matrix_create(0)
    lis.lis_matrix_set_size(A, 0, n)
    for i in range(n):
        lis.lis_matrix_set_value(lis.LIS_INS_VALUE, i, i, 2.5, A)
        if i > 0:
            lis.lis_matrix_set_value(lis.LIS_INS_VALUE, i, i - 1, -1.0, A)
        if i < n - 1:
            lis.lis_matrix_set_value(lis.LIS_INS_VALUE, i, i + 1, -1.0, A)
    lis.lis_matrix_assemble(A)
    solver = lis.lis_solver_create()
    lis.lis_solver_set_option("-i bicgstab -p ilu -tol 1e-12", solver)
    lis.lis_solver_set_matrix(A, solver)
    precon = lis.lis_precon_psd_create(solver)
    b = lis.lis_vector_create(0)
    lis.lis_vector_set_size(b, 0, n)
    lis.lis_vector_set_all(1.0, b)
    x = lis.lis_vector_duplicate(b)
    st1 = lis.lis_solve_kernel(A, b, x, solver, precon)
    x1 = lis.lis_vector_get_values(x, 0, n)
    it1 = lis.lis_solver_get_iter(solver)
    ups = [lis.lis_matrix_psd_set_value(lis.LIS_ADD_VALUE, i, i, 2.0, A)
           for i in range(n)]
    outside = lis.lis_matrix_psd_set_value(lis.LIS_INS_VALUE, 0, n - 1, 9.9,
                                           A)
    upd = lis.lis_precon_psd_update(solver, precon)
    lis.lis_matrix_psd_reset_scale(A)
    lis.lis_vector_psd_reset_scale(b)
    st2 = lis.lis_solve_kernel(A, b, x, solver, precon)
    return dict(ptype=precon.precon_type, st=(st1, st2, upd, outside),
                ups=ups, it=(it1, lis.lis_solver_get_iter(solver)), x1=x1,
                x2=lis.lis_vector_get_values(x, 0, n),
                dense=_np(A.m.to_dense()))


def test_psd_decoupled_flow():
    j, t = _both(flow_psd)
    _same(j, t, exact=("ptype", "st", "ups", "it"),
          close=("x1", "x2", "dense"))
    assert t["st"][3] == T.LIS_ERR_ILL_ARG
    np.testing.assert_allclose(t["dense"] @ t["x2"], np.ones(40), atol=1e-9)


def flow_psd_scaling(lis):
    n = 60
    A = lis.lis_matrix_create(0)
    lis.lis_matrix_set_size(A, 0, n)
    d = np.random.RandomState(3).uniform(5.0, 50.0, n)
    for i in range(n):
        lis.lis_matrix_set_value(lis.LIS_INS_VALUE, i, i, d[i], A)
        if i:
            lis.lis_matrix_set_value(lis.LIS_INS_VALUE, i, i - 1, -1.0, A)
            lis.lis_matrix_set_value(lis.LIS_INS_VALUE, i - 1, i, -1.0, A)
    lis.lis_matrix_assemble(A)
    b = lis.lis_vector_create(0)
    lis.lis_vector_set_size(b, 0, n)
    lis.lis_vector_set_all(1.0, b)
    out = {}
    for optstr in ("-i bicgstab -p is -tol 1e-10",
                   "-i gmres -p ilu -tol 1e-10"):
        s1 = lis.lis_solver_create()
        lis.lis_solver_set_option(optstr, s1)
        x1 = lis.lis_vector_duplicate(b)
        st1 = lis.lis_solve(A, b, x1, s1)
        s2 = lis.lis_solver_create()
        lis.lis_solver_set_option(optstr, s2)
        lis.lis_solver_set_matrix(A, s2)
        p = lis.lis_precon_psd_create(s2)
        x2 = lis.lis_vector_duplicate(b)
        st2 = lis.lis_solve_kernel(A, b, x2, s2, p)
        out[optstr] = ((st1, lis.lis_solver_get_iter(s1)),
                       (st2, lis.lis_solver_get_iter(s2)),
                       lis.lis_vector_get_values(x2, 0, n))
    return out


def test_psd_matches_direct_solve_with_scaling():
    j, t = _both(flow_psd_scaling)
    for k in j:
        assert t[k][:2] == j[k][:2], k
        _close(t[k][2], j[k][2], 1e-10)
        assert abs(t[k][1][1] - t[k][0][1]) <= 1


# ---- raw-layout lis_matrix_set_* ---------------------------------------------

def _tri5_dense():
    d = np.zeros((6, 6))
    for i in range(6):
        d[i, i] = 2.0 + i
        if i > 0:
            d[i, i - 1] = -1.0
        if i < 5:
            d[i, i + 1] = -1.5
    return d


def _handle(lis, n=6, mtype=None):
    A = lis.lis_matrix_create(0)
    lis.lis_matrix_set_size(A, 0, n)
    if mtype is not None:
        lis.lis_matrix_set_type(A, mtype)
    return A


def _set_raw(lis, fmt, d):
    """The raw arrays of test_compat.py::test_raw_layout_set_formats for
    one format, set on a new handle and assembled."""
    n = 6
    A = _handle(lis, mtype=getattr(lis, f"LIS_MATRIX_{fmt.upper()}"))
    if fmt == "coo":
        coo = sp.coo_matrix(d)
        lis.lis_matrix_set_coo(coo.nnz, coo.row, coo.col, coo.data, A)
    elif fmt == "csc":
        csc = sp.csc_matrix(d)
        lis.lis_matrix_set_csc(csc.nnz, csc.indptr, csc.indices, csc.data, A)
    elif fmt == "dns":
        lis.lis_matrix_set_dns(d.reshape(-1, order="F"), A)
    elif fmt == "dia":
        offs = np.array([-1, 0, 1])
        val = np.zeros(3 * n)
        for j, off in enumerate(offs):
            for i in range(max(0, -off), min(n, n - off)):
                val[j * n + i] = d[i, i + off]
        lis.lis_matrix_set_dia(3, offs, val, A)
    elif fmt == "ell":
        w = 3
        eidx = np.zeros(w * n, dtype=np.int64)
        eval_ = np.zeros(w * n)
        for i in range(n):
            slots = [(j, d[i, j]) for j in range(n) if d[i, j] != 0]
            for k, (j, v) in enumerate(slots):
                eidx[k * n + i] = j
                eval_[k * n + i] = v
        lis.lis_matrix_set_ell(w, eidx, eval_, A)
    elif fmt == "msr":
        tail_idx, tail_val = [], []
        ptrs = [n + 1]
        for i in range(n):
            for j in range(n):
                if i != j and d[i, j] != 0:
                    tail_idx.append(j)
                    tail_val.append(d[i, j])
            ptrs.append(n + 1 + len(tail_idx))
        midx = np.concatenate([ptrs, tail_idx]).astype(np.int64)
        mval = np.concatenate([np.diag(d), [0.0], tail_val])
        lis.lis_matrix_set_msr(len(mval) - 1, 0, midx, mval, A)
    elif fmt == "jad":
        counts = (d != 0).sum(1)
        perm = np.argsort(-counts, kind="stable").astype(np.int64)
        maxnzr = int(counts.max())
        jptr, jidx, jval = [0], [], []
        rowslots = [[(j, d[r, j]) for j in range(n) if d[r, j] != 0]
                    for r in perm]
        for s in range(maxnzr):
            for k in range(n):
                if s < len(rowslots[k]):
                    jidx.append(rowslots[k][s][0])
                    jval.append(rowslots[k][s][1])
            jptr.append(len(jidx))
        lis.lis_matrix_set_jad(len(jval), maxnzr, perm, np.array(jptr),
                               np.array(jidx), np.array(jval), A)
    elif fmt == "bsr":
        bsr = sp.bsr_matrix(d, blocksize=(2, 2))
        bval = bsr.data.transpose(0, 2, 1).reshape(-1)
        lis.lis_matrix_set_bsr(2, 2, bsr.indptr[-1], bsr.indptr,
                               bsr.indices, bval, A)
    elif fmt == "bsc":
        bsc = sp.bsr_matrix(d.T, blocksize=(2, 2))
        lis.lis_matrix_set_bsc(2, 2, bsc.indptr[-1], bsc.indptr,
                               bsc.indices, bsc.data.reshape(-1), A)
    elif fmt == "vbr":
        rp = np.array([0, 2, 3, 6])
        cp = np.array([0, 3, 6])
        bptr, bindex, vptr, vvals = [0], [], [0], []
        for bi in range(3):
            for bj in range(2):
                blk = d[rp[bi]:rp[bi + 1], cp[bj]:cp[bj + 1]]
                if np.any(blk != 0):
                    bindex.append(bj)
                    vvals.extend(blk.reshape(-1, order="F"))
                    vptr.append(len(vvals))
            bptr.append(len(bindex))
        lis.lis_matrix_set_vbr(len(vvals), 3, 2, len(bindex), rp, cp,
                               np.array(vptr), np.array(bptr),
                               np.array(bindex), np.array(vvals), A)
    st = lis.lis_matrix_assemble(A)
    return A, st


RAW_FORMATS = ("coo", "csc", "dns", "dia", "ell", "msr", "jad", "bsr",
               "bsc", "vbr")


@pytest.mark.parametrize("fmt", RAW_FORMATS)
def test_raw_layout_set_formats(fmt):
    """Every lis_matrix_set_<fmt> of test_raw_layout_set_formats adopts the
    reference's raw packing and assembles to lis_tpu's operator, in the
    declared format."""
    d = _tri5_dense()
    (Aj, sj), (At, st) = _set_raw(J, fmt, d), _set_raw(T, fmt, d)
    assert st == sj == T.LIS_SUCCESS
    assert At.m.format_name == Aj.m.format_name == fmt
    assert T.lis_matrix_get_type(At) == J.lis_matrix_get_type(Aj)
    assert T.lis_matrix_get_nnz(At) == J.lis_matrix_get_nnz(Aj)
    _close(At.m.to_dense(), Aj.m.to_dense())
    np.testing.assert_allclose(_np(At.m.to_dense()), d)
    x = np.linspace(-1.0, 1.0, 6)
    _close(At.m.matvec(torch.from_numpy(x)), Aj.m.matvec(jnp.asarray(x)))


# ---- matrix / vector / array surfaces ----------------------------------------

def flow_matrix_ops(lis):
    d = _tri5_dense()
    A = _handle(lis)
    assembled0 = lis.lis_matrix_is_assembled(A)
    lis.lis_matrix_set_values(lis.LIS_INS_VALUE, 6, d.reshape(-1), A)
    lis.lis_matrix_assemble(A)
    assembled1 = lis.lis_matrix_is_assembled(A)
    B = lis.lis_matrix_create(0)
    lis.lis_matrix_copy(A, B)
    bvec = lis.lis_vector_create(0)
    lis.lis_vector_set_size(bvec, 0, 6)
    lis.lis_vector_set_all(2.0, bvec)
    dvec = lis.lis_vector_create(0)
    lis.lis_matrix_scale(A, bvec, dvec, 1)
    A2 = _handle(lis)
    lis.lis_matrix_set_values(lis.LIS_INS_VALUE, 6, d.reshape(-1), A2)
    lis.lis_matrix_assemble(A2)
    lis.lis_matrix_scale(A2, None, None, 2)
    csr_st = lis.lis_matrix_set_value_csr(lis.LIS_INS_VALUE, 0, 1, -9.0, B)
    C = lis.lis_matrix_duplicate(B)
    lis.lis_matrix_set_type(C, lis.LIS_MATRIX_ELL)
    lis.lis_matrix_convert(B, C)
    lis.lis_matrix_unset(B)
    ptr, idx, val = lis.lis_matrix_malloc_csr(6, 16)
    return dict(asm=(assembled0, assembled1), A=_np(A.m.to_dense()),
                A2=_np(A2.m.to_dense()), B=_np(B.m.to_dense()),
                C=_np(C.m.to_dense()), Cfmt=C.m.format_name,
                dv=lis.lis_vector_gather(dvec), bv=lis.lis_vector_gather(bvec),
                csr=csr_st, kept=B.m is not None,
                bufs=(ptr.shape, idx.shape, val.dtype,
                      lis.lis_is_malloc(val)),
                rng=lis.lis_matrix_get_range(A),
                size=lis.lis_matrix_get_size(A))


def test_matrix_ops_surface():
    j, t = _both(flow_matrix_ops)
    _same(j, t, exact=("asm", "Cfmt", "csr", "kept", "bufs", "rng", "size"),
          close=("A", "A2", "B", "C", "dv", "bv"))
    assert t["B"][0, 1] == -9.0


def flow_vector_ops(lis):
    out = {}
    v = lis.lis_vector_create(0)
    lis.lis_vector_set_size(v, 0, 5)
    lis.lis_vector_set_values(lis.LIS_INS_VALUE, 3, np.array([0, 2, 4]),
                              np.array([1.0, -2.0, 3.0]), v)
    lis.lis_vector_set_values2(lis.LIS_ADD_VALUE, 1, 2, np.array([0.5, 0.5]),
                               v)
    out["v"] = lis.lis_vector_gather(v)
    out["ints"] = (lis.lis_vector_get_size(v), lis.lis_vector_get_range(v),
                   lis.lis_vector_is_null(v),
                   lis.lis_vector_is_null(lis.lis_vector_create(0)))
    out["red"] = (lis.lis_vector_nrm1(v), lis.lis_vector_nrmi(v),
                  lis.lis_vector_sum(v), lis.lis_vector_nrm2(v))
    w = lis.lis_vector_duplicate(v)
    lis.lis_vector_set_all(2.0, w)
    out["dots"] = (lis.lis_vector_nhdot(v, w), lis.lis_vector_dot(v, w))
    z = lis.lis_vector_duplicate(v)
    lis.lis_vector_axpyz(3.0, v, w, z)
    out["axpyz"] = lis.lis_vector_gather(z)
    lis.lis_vector_xpay(v, 0.5, z)
    out["xpay"] = lis.lis_vector_gather(z)
    lis.lis_vector_axpy(-2.0, v, z)
    lis.lis_vector_scale(0.5, z)
    out["axpy"] = lis.lis_vector_gather(z)
    lis.lis_vector_pmul(v, w, z)
    out["pmul"] = lis.lis_vector_gather(z)
    lis.lis_vector_pdiv(z, w, z)
    lis.lis_vector_abs(z)
    lis.lis_vector_shift(1.0, z)
    out["shift"] = lis.lis_vector_gather(z)
    lis.lis_vector_set_all(4.0, z)
    lis.lis_vector_reciprocal(z)
    lis.lis_vector_conjugate(z)
    out["recip"] = lis.lis_vector_gather(z)
    a, bv = lis.lis_vector_duplicate(v), lis.lis_vector_duplicate(v)
    lis.lis_vector_set_all(1.0, a)
    lis.lis_vector_set_all(2.0, bv)
    lis.lis_vector_swap(a, bv)
    out["swap"] = (lis.lis_vector_get_value(a, 0),
                   lis.lis_vector_get_value(bv, 0))
    lis.lis_vector_copy(a, bv)
    out["copy"] = lis.lis_vector_gather(bv)
    buf = np.zeros(5)
    lis.lis_vector_gather(v, buf)
    lis.lis_vector_scatter(buf * 2, a)
    out["scatter"] = lis.lis_vector_gather(a)
    # per-element writes: insert, accumulate, read back before and after
    # a device read
    e = lis.lis_vector_duplicate(v)
    for i in range(5):
        lis.lis_vector_set_value(lis.LIS_INS_VALUE, i, float(i * i), e)
    lis.lis_vector_set_value(lis.LIS_ADD_VALUE, 3, 0.25, e)
    first = lis.lis_vector_get_value(e, 3)
    out["elem"] = (first, lis.lis_vector_nrm2(e))
    lis.lis_vector_set_value(lis.LIS_ADD_VALUE, 3, 1.0, e)
    out["elem2"] = (lis.lis_vector_get_value(e, 3),
                    lis.lis_vector_get_values(e, 1, 3))
    out["rh"] = lis.lis_vector_print(v)
    return out


def test_vector_ops_surface(capsys):
    j = flow_vector_ops(J)
    jout = capsys.readouterr().out
    t = flow_vector_ops(T)
    assert capsys.readouterr().out == jout
    _same(j, t, exact=("ints", "swap", "rh"),
          close=("v", "red", "dots", "axpyz", "xpay", "axpy", "pmul",
                 "shift", "recip", "copy", "scatter", "elem"))
    assert t["elem2"][0] == j["elem2"][0] == 10.25
    _close(t["elem2"][1], j["elem2"][1])
    np.testing.assert_allclose(t["v"], [1.0, 0.5, -1.5, 0.0, 3.0])


def test_vector_set_value_stages_on_the_host():
    """Per-element writes go to a host copy: no device tensor exists
    while they are pending, and the next device read sees all of them."""
    v = T.lis_vector_create(0)
    T.lis_vector_set_size(v, 0, 1000)
    T.lis_vector_set_all(1.0, v)
    for i in range(0, 1000, 7):
        T.lis_vector_set_value(T.LIS_ADD_VALUE, i, 0.5, v)
    assert v._dev is None and v._host is not None
    want = np.ones(1000)
    want[::7] += 0.5
    assert T.lis_vector_get_value(v, 7) == 1.5 and v._dev is None
    got = v.value
    assert isinstance(got, torch.Tensor) and v._host is None
    np.testing.assert_array_equal(got.numpy(), want)


def flow_array_ops(lis):
    rng = np.random.RandomState(7)
    n = 4
    a, b = rng.randn(n * n), rng.randn(n * n)
    x = rng.randn(n)
    out = {}
    y = np.zeros(n)
    lis.lis_array_matvech(n, a, x, y, lis.LIS_INS_VALUE)
    out["matvech"] = y.copy()
    lis.lis_array_matvec(n, a, x, y, lis.LIS_ADD_VALUE)
    out["matvec"] = y.copy()
    c = np.zeros(n * n)
    lis.lis_array_matmat(n, a, b, c, lis.LIS_INS_VALUE)
    out["matmat"] = c.copy()
    c2 = np.zeros(6)
    lis.lis_array_matmat_ns(3, 2, 4, a, 4, b, 4, c2, 3, lis.LIS_INS_VALUE)
    out["matmat_ns"] = c2
    y2 = np.zeros(3)
    lis.lis_array_matvec_ns(3, 4, a, 4, x, y2, lis.LIS_INS_VALUE)
    out["matvec_ns"] = y2
    inv = a.copy()
    lis.lis_array_ge(n, inv)
    out["ge"] = inv
    xs, w = np.zeros(n), np.zeros(n * n)
    lis.lis_array_solve(n, a, x, xs, w)
    out["solve"] = xs
    for fac in ("cgs", "mgs"):
        q, r = np.zeros(n * n), np.zeros(n * n)
        getattr(lis, f"lis_array_{fac}")(n, a.copy(), q, r)
        out[fac] = (q, r)
    am = a.reshape(n, n, order="F")
    sa = (am + am.T).reshape(-1, order="F").copy()
    q, r = np.zeros(n * n), np.zeros(n * n)
    out["qr_it"] = lis.lis_array_qr(n, sa, q, r)[0]
    out["qr"] = sa
    u, w3 = np.array([1.0, -2.0, 3.0]), np.array([2.0, 2.0, 2.0])
    out["red"] = (lis.lis_array_dot(3, u, w3), lis.lis_array_nhdot(3, u, w3),
                  lis.lis_array_nrm1(3, u), lis.lis_array_nrmi(3, u),
                  lis.lis_array_sum(3, u), lis.lis_array_nrm2(3, u))
    z = np.zeros(3)
    lis.lis_array_axpyz(3, 2.0, u, w3, z)
    lis.lis_array_axpy(3, -1.0, u, w3)
    lis.lis_array_xpay(3, u, 0.5, z)
    lis.lis_array_pmul(3, u, z, z)
    lis.lis_array_pdiv(3, z, w3, z)
    lis.lis_array_scale(3, 2.0, z)
    lis.lis_array_abs(3, z)
    lis.lis_array_shift(3, 1.0, z)
    lis.lis_array_reciprocal(3, w3)
    lis.lis_array_conjugate(3, w3)
    t1, t2 = u.copy(), 5 * u
    lis.lis_array_swap(3, t1, t2)
    lis.lis_array_copy(3, t1, z)
    lis.lis_array_set_all(2, 7.0, t2)
    out["blas1"] = np.concatenate([z, w3, t1, t2])
    return out


def test_array_ops_surface():
    j, t = _both(flow_array_ops)
    _same(j, t, exact=("qr_it",),
          close=("matvech", "matvec", "matmat", "matmat_ns", "matvec_ns",
                 "ge", "solve", "red", "qr", "blas1"))
    for fac in ("cgs", "mgs"):
        _close(t[fac][0], j[fac][0])
        _close(t[fac][1], j[fac][1])


# ---- solver / esolver getters --------------------------------------------------

def _lap(lis, n, diag):
    A = _handle(lis, n)
    for i in range(n):
        lis.lis_matrix_set_value(lis.LIS_INS_VALUE, i, i, diag, A)
        if i:
            lis.lis_matrix_set_value(lis.LIS_INS_VALUE, i, i - 1, -1.0, A)
            lis.lis_matrix_set_value(lis.LIS_INS_VALUE, i - 1, i, -1.0, A)
    lis.lis_matrix_assemble(A)
    return A


def flow_getters(lis, eopts):
    n = 30
    A = _lap(lis, n, 2.0)
    s = lis.lis_solver_create()
    lis.lis_solver_set_option("-i cg -p ssor -tol 1e-10", s)
    lis.lis_solve_setup(A, s)
    p = lis.lis_precon_psd_create(s)
    b = lis.lis_vector_create(0)
    lis.lis_vector_set_size(b, 0, n)
    lis.lis_vector_set_all(1.0, b)
    x = lis.lis_vector_duplicate(b)
    st = lis.lis_solve_kernel(A, b, x, s, p)
    rhv = lis.lis_vector_create(0)
    lis.lis_solver_get_rhistory(s, rhv)
    out = dict(st=st, pname=lis.lis_solver_get_preconname(
        lis.lis_solver_get_precon(s)), it=lis.lis_solver_get_iter(s),
        x=lis.lis_vector_gather(x), rh=lis.lis_vector_gather(rhv),
        timeex=len(lis.lis_solver_get_timeex(s)))
    es = lis.lis_esolver_create()
    lis.lis_esolver_set_option(eopts, es)
    ex = lis.lis_vector_duplicate(b)
    out["est"], out["ev"] = lis.lis_esolve(A, ex, es)
    M = lis.lis_matrix_create(0)
    lis.lis_esolver_get_evectors(es, M)
    out["M_n"] = M.n
    out["evs"] = lis.lis_esolver_get_evalues(es)
    vk = lis.lis_vector_duplicate(b)
    lis.lis_esolver_get_specific_evector(es, 0, vk)
    out["v0"] = lis.lis_vector_gather(vk)
    out["spec"] = (lis.lis_esolver_get_specific_evalue(es, 0),
                   lis.lis_esolver_get_specific_iter(es, 0),
                   lis.lis_esolver_get_specific_residualnorm(es, 0))
    itv = lis.lis_vector_create(0)
    lis.lis_esolver_get_iters(es, itv)
    out["iters"] = lis.lis_vector_gather(itv)
    out["ilist"] = list(lis.lis_esolver_get_iters(es))
    out["nres"] = len(lis.lis_esolver_get_residualnorms(es))
    out["eit"] = (lis.lis_esolver_get_iter(es),
                  lis.lis_esolver_get_iterex(es),
                  lis.lis_esolver_get_esolvername(
                      lis.lis_esolver_get_esolver(es)),
                  lis.lis_esolver_get_status(es),
                  lis.lis_iesolver_destroy(es))
    return out


def test_solver_esolver_getter_surface():
    """test_compat.py's getter flow, its esolve with Lanczos (-e li -ss
    4), where every pair of the two packages agrees."""
    j, t = _both(flow_getters, eopts="-e li -ss 4 -etol 1e-8")
    _same(j, t, exact=("st", "pname", "it", "timeex", "est", "M_n", "ilist",
                       "nres", "eit"), close=("x", "rh", "iters"))
    assert t["pname"] == "ssor" and t["est"] == T.LIS_SUCCESS
    _close(t["ev"], j["ev"], 1e-10)
    _close(t["evs"], j["evs"], 1e-10)
    _close(t["spec"][0], j["spec"][0], 1e-10)
    assert t["spec"][1] == j["spec"][1] and t["spec"][2] < 1e-8
    # the eigenvector up to sign
    sgn = np.sign(np.dot(t["v0"], j["v0"]))
    _close(sgn * t["v0"], j["v0"], 1e-8)


def test_esolver_getters_subspace_first_pair():
    """test_compat.py's options, -e si -ss 4 -etol 1e-6, with -emaxiter
    300 for 3000 (lis_tpu's four pairs take 7, 14, 17 and 45 sweeps).
    SI's pairs after the first start, in lis_tpu, from rounding noise, in
    the port from a seeded random vector (ROADMAP.md queue 3), so only the
    first pair is held to lis_tpu; on this grid the port's third pair
    floors at 1.04e-6 and the esolve ends MAXITER, where lis_tpu's pairs
    meet 1e-6."""
    j, t = _both(flow_getters, eopts="-e si -ss 4 -emaxiter 300 -etol 1e-6")
    _same(j, t, exact=("st", "pname", "it", "M_n", "nres"), close=("x",))
    assert t["ilist"][0] == j["ilist"][0]
    _close(t["ev"], j["ev"], 1e-10)
    _close(t["spec"][0], j["spec"][0], 1e-10)
    want = 2 - 2 * np.cos(np.arange(1, 5) * np.pi / 31)
    np.testing.assert_allclose(np.sort(t["evs"]), want, rtol=1e-5)


# ---- user preconditioners -------------------------------------------------------

def flow_user_precon(lis, name):
    n = 40
    A = _lap(lis, n, 3.0)
    reg = lis.lis_precon_register(name, lambda m, o: 1.0 / m.get_diagonal(),
                                  lambda st, r: st * r)
    res = _solve_fn(lis)(A.m, np.ones(n),
                         options=f"-i cg -p {name} -tol 1e-10")
    pid = res.options.precon_id
    out = dict(reg=reg, st=res.status, it=res.iters, x=_np(res.x), pid=pid,
               pname=lis.lis_solver_get_preconname(pid),
               tr=res.true_resid)
    lis.lis_precon_register_free()
    from importlib import import_module
    reg_mod = import_module(lis.__name__.rsplit(".", 1)[0] + ".precon.base")
    out["freed"] = name not in reg_mod.PRECON_REGISTRY
    return out


@pytest.mark.parametrize("name", ["mydiag", "udiag2"])
def test_user_precon_register(name):
    """lis_precon_register / get_preconname / register_free (the two
    user-preconditioner flows of test_compat.py)."""
    j = flow_user_precon(J, name)
    t = flow_user_precon(T, name)
    _same(j, t, exact=("reg", "st", "it", "pname", "freed"), close=("x",))
    assert t["pname"] == name and t["freed"] and t["tr"] < 1e-9
    assert t["pid"] >= len(__import__(
        "lis_tpu_torch.runtime.options",
        fromlist=["PRECON_NAMES"]).PRECON_NAMES)


def test_user_precon_psolve_sees_device_tensors():
    """The user psolve receives the solver's tensors, on the matrix's
    device, and its state follows a cast under -f single."""
    seen = []

    def psolve(st, r):
        seen.append((type(r), r.dtype, r.device.type, st.dtype))
        return st * r

    A = _lap(T, 20, 3.0)
    T.lis_precon_register("seen", lambda m, o: 1.0 / m.get_diagonal(),
                          psolve)
    try:
        r64 = lis_tpu_torch.solve(A.m, np.ones(20),
                                  options="-i bicg -p seen -tol 1e-10")
        r32 = lis_tpu_torch.solve(A.m, np.ones(20),
                                  options="-i bicg -p seen -f single")
    finally:
        T.lis_precon_register_free()
    assert r64.status == r32.status == 0
    assert (torch.Tensor, torch.float64, "cpu", torch.float64) in seen
    assert (torch.Tensor, torch.float32, "cpu", torch.float32) in seen


# ---- complex, COO, range ---------------------------------------------------------

def flow_complex_dot(lis):
    u = lis.lis_vector_create(0)
    u.n = 3
    u.value = _vec(lis, np.array([1j, 2j, 0.0]))
    return dict(dot=lis.lis_vector_dot(u, u), nh=lis.lis_vector_nhdot(u, u),
                sum=lis.lis_vector_sum(u), get=lis.lis_vector_get_value(u, 1),
                n2=lis.lis_vector_nrm2(u))


def test_vector_dot_is_hermitian_complex():
    j, t = _both(flow_complex_dot)
    _same(j, t, exact=("dot", "nh", "sum", "get"), close=("n2",))
    assert t["dot"] == 5.0 and t["nh"] == -5.0 and t["get"] == 2j


def flow_complex_coo(lis):
    d = _tri5_dense() + 1j * np.eye(6)
    A = _handle(lis, mtype=lis.LIS_MATRIX_COO)
    coo = sp.coo_matrix(d)
    lis.lis_matrix_set_coo(coo.nnz, coo.row, coo.col, coo.data, A)
    lis.lis_matrix_assemble(A)
    return dict(dense=_np(A.m.to_dense()), fmt=A.m.format_name)


def test_set_coo_preserves_complex():
    j, t = _both(flow_complex_coo)
    _same(j, t, exact=("fmt",), close=("dense",))
    np.testing.assert_allclose(t["dense"], _tri5_dense() + 1j * np.eye(6))


def test_matrix_get_range_is_zero_based():
    from lis_tpu.interop import fapi as jf
    from lis_tpu_torch.interop import fapi as tf
    got = []
    for lis, f in ((J, jf), (T, tf)):
        A = _handle(lis, 10)
        h = f.matrix_create(0)
        f.matrix_set_size(h, 0, 10)
        got.append((lis.lis_matrix_get_range(A), f.matrix_get_range_is(h),
                    f.matrix_get_range_ie(h)))
    assert got[1] == got[0] == ((0, 10), 1, 11)


def test_full_lis_h_surface_of_lis_tpu_present():
    """Every lis_* name of lis_tpu.compat exists in lis_tpu_torch.compat
    (the port's counterpart of test_full_lis_h_surface_present, which
    reads the reference's header), with the same kind (function or
    constant) and the same constant values."""
    names = sorted(n for n in dir(J) if n.startswith(("lis_", "LIS_")))
    assert len([n for n in names if n.startswith("lis_")]) >= 180
    missing = [n for n in names if not hasattr(T, n)]
    assert not missing, missing
    for n in names:
        a, b = getattr(J, n), getattr(T, n)
        assert callable(a) == callable(b), n
        if not callable(a):
            assert a == b, n
    assert isinstance(T.lis_date(), str)
    assert T.lis_do_not_handle_mpi() is None and T.lis_free(None) is None
    assert T.lis_free2(2, None, None) is None
