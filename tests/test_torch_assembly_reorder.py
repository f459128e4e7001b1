"""MatrixAssembler, the RCM reordering (-reorder rcm) and the explicit
transpose (-use_at) against lis_tpu.

A seeded sequence of insertions and additions with repeated keys is
assembled into every scalar format by both packages: equal arrays.  The
RCM permutation, the bandwidth and the permuted matrix equal lis_tpu's;
``-reorder rcm`` solves give lis_tpu's count and x (rtol 1e-9), with x
returned in the original order.  ``-use_at true`` with BiCG and BiCR
gives lis_tpu's count and x on real and complex systems.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lis_tpu
from lis_tpu.matrix import reorder as jreorder
from lis_tpu.matrix.assembly import MatrixAssembler as JAssembler
import lis_tpu_torch
from lis_tpu_torch import LIS_ADD_VALUE, LIS_INS_VALUE, MatrixAssembler
from lis_tpu_torch.matrix import reorder as treorder
from lis_tpu_torch.matrix.useat import WithTranspose, with_explicit_transpose

SCALAR = ["csr", "coo", "csc", "msr", "ell", "jad", "dns"]


def sequence(n, count, cplx, seed):
    """(flag, i, j, value) steps over an n x n matrix, about a third of
    them on keys already set."""
    rng = np.random.default_rng(seed)
    steps, keys = [], []
    for _ in range(count):
        if keys and rng.random() < 0.35:
            i, j = keys[rng.integers(len(keys))]
        else:
            i, j = (int(k) for k in rng.integers(0, n, 2))
            keys.append((i, j))
        v = rng.standard_normal() + (1j * rng.standard_normal() if cplx
                                     else 0)
        steps.append((int(rng.integers(2)), i, j, v))
    for i in range(n):                       # a full diagonal
        steps.append((LIS_ADD_VALUE, i, i, 8.0))
    return steps


@pytest.mark.parametrize("cplx", [False, True])
def test_assembler_matches_lis_tpu(cplx):
    n = 24
    dtype = np.complex128 if cplx else np.float64
    J, T = JAssembler((n, n), dtype), MatrixAssembler((n, n), dtype)
    steps = sequence(n, 400, cplx, seed=3 + cplx)
    for flag, i, j, v in steps[:200]:
        J.set_value(flag, i, j, v)
        T.set_value(flag, i, j, v)
    rest = np.array(steps[200:], dtype=object).T
    for flag in (LIS_INS_VALUE, LIS_ADD_VALUE):
        sel = rest[0] == flag
        J.set_values(flag, rest[1][sel], rest[2][sel], rest[3][sel])
        T.set_values(flag, rest[1][sel], rest[2][sel], rest[3][sel])
    for fmt in SCALAR + ["dia", "hdi"]:
        Jm, Tm = J.assemble(fmt), T.assemble(fmt, device="cpu")
        assert Tm.format_name == fmt and Tm.device.type == "cpu"
        for g, w in zip(Tm.to_csr_arrays(), Jm.to_csr_arrays()):
            np.testing.assert_array_equal(g, np.asarray(w))
        if fmt in SCALAR:
            for f in dataclasses.fields(Jm):
                want = getattr(Jm, f.name)
                got = getattr(Tm, f.name)
                if f.metadata.get("static"):
                    assert got == want
                else:
                    np.testing.assert_array_equal(got.numpy(),
                                                  np.asarray(want))
    # INS overwrote the latest triplet of a key, ADD appended: the COO
    # keeps the triplets, so its length is lis_tpu's
    assert T.assemble("coo", device="cpu").nnz == J.assemble("coo").nnz
    with pytest.raises(IndexError):
        T.set_value(LIS_INS_VALUE, n, 0, 1.0)


def scrambled_poisson(nx, ny, seed):
    """A 2-D 5-point Laplacian under a seeded symmetric permutation."""
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (nx, nx))
    s = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (ny, ny))
    a = sp.kronsum(t, s).tocsr()
    p = np.random.default_rng(seed).permutation(a.shape[0])
    a = a[p][:, p].tocsr()
    a.sort_indices()
    return a


def pair(a):
    args = (a.indptr, a.indices, a.data, a.shape)
    return (lis_tpu.CSRMatrix.from_csr_arrays(*args),
            lis_tpu_torch.CSRMatrix.from_csr_arrays(*args, device="cpu"))


@pytest.mark.parametrize("fmt", ["csr", "ell", "coo"])
def test_rcm_permutation_and_permuted_matrix_match_lis_tpu(fmt):
    J, T = pair(scrambled_poisson(17, 13, seed=1))
    T = lis_tpu_torch.convert_matrix(T, fmt, device="cpu")
    J = lis_tpu.convert_matrix(J, fmt)
    pj, pt = jreorder.rcm_permutation(J), treorder.rcm_permutation(T)
    assert pt.dtype == pj.dtype
    np.testing.assert_array_equal(pt, pj)
    assert treorder.bandwidth(T) == jreorder.bandwidth(J) > 100
    Pj, Pt = jreorder.permute_symmetric(J, pj), \
        treorder.permute_symmetric(T, pt)
    assert Pt.format_name == fmt and Pt.device.type == "cpu"
    for g, w in zip(Pt.to_csr_arrays(), Pj.to_csr_arrays()):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert treorder.bandwidth(Pt) == jreorder.bandwidth(Pj) < 20


@pytest.mark.parametrize("opts", [
    "-i cg -p jacobi -tol 1e-10",
    "-i cg -p ssor -storage csr -tol 1e-10",
    "-i bicgstab -p ilu -storage ell -tol 1e-10",
    "-i cg -p jacobi -scale 2 -f quad -tol 1e-12",
])
def test_reorder_rcm_solve_matches_lis_tpu(opts):
    a = scrambled_poisson(16, 14, seed=2)
    J, T = pair(a)
    rng = np.random.default_rng(4)
    b, x0 = rng.standard_normal(a.shape[0]), rng.standard_normal(a.shape[0])
    opts += " -reorder rcm -initx_zeros false"
    rj = lis_tpu.solve(J, b, x0=x0, options=opts)
    rt = lis_tpu_torch.solve(T, b, x0=x0, options=opts)
    plain = lis_tpu_torch.solve(T, b, x0=x0,
                                options=opts.replace("-reorder rcm", ""))
    assert rj.status == rt.status == lis_tpu.LIS_SUCCESS
    assert rt.iters == rj.iters
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=1e-9,
                               atol=1e-9 * np.abs(xj).max())
    np.testing.assert_allclose(rt.true_resid, rj.true_resid, rtol=1e-3)
    # x is returned in the original order: it solves the original system
    np.testing.assert_allclose(rt.x.numpy(), plain.x.numpy(), rtol=1e-7,
                               atol=1e-7 * np.abs(xj).max())
    np.testing.assert_allclose(a @ rt.x.numpy(), b, atol=1e-8)


def nonsym(n, cplx, seed):
    """A banded nonsymmetric (complex: non-Hermitian) diagonally dominant
    matrix with a few random entries off the band."""
    rng = np.random.default_rng(seed)
    a = sp.diags([-1.3, 4.0, -0.6, 0.4], [-1, 0, 1, 7], (n, n)).tolil()
    for _ in range(3 * n // 10):
        a[rng.integers(n), rng.integers(n)] += rng.uniform(-0.3, 0.3)
    a = a.tocsr()
    if cplx:
        a = (a + 1j * sp.diags(rng.uniform(-1, 1, n - 2), 2,
                               (n, n))).tocsr()
    a.sort_indices()
    return a


USE_AT = ["-i bicg -p jacobi", "-i bicr -p jacobi",
          "-i bicg -p ilu -storage jad", "-i bicr -storage coo"]


@pytest.mark.parametrize("opts,cplx", [
    *((o, c) for c in (False, True) for o in USE_AT),
    ("-i bicg -f single -tol 1e-5", False)])
def test_use_at_matches_lis_tpu(opts, cplx):
    a = nonsym(150, cplx, seed=5)
    J, T = pair(a)
    b = np.random.default_rng(6).standard_normal(150) + 0j * cplx
    opts += " -use_at true"
    rj = lis_tpu.solve(J, b, options=opts)
    rt = lis_tpu_torch.solve(T, b, options=opts)
    assert rj.status == rt.status == lis_tpu.LIS_SUCCESS
    assert rt.iters == rj.iters
    rtol = 1e-5 if "single" in opts else 1e-9
    xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), xj, rtol=rtol,
                               atol=rtol * np.abs(xj).max())
    off = lis_tpu_torch.solve(T, b, options=opts.replace("true", "false"))
    assert abs(off.iters - rt.iters) <= 1


def test_with_explicit_transpose_products_and_moves():
    a = nonsym(60, True, seed=7)
    _, T = pair(a)
    W = with_explicit_transpose(lis_tpu_torch.convert_matrix(
        T, "ell", device="cpu"))
    assert isinstance(W, WithTranspose) and W.format_name == "use_at"
    assert W.shape == (60, 60) and W.nnz == a.nnz
    assert W.At.format_name == "csr"
    y = torch.from_numpy(np.random.default_rng(8).standard_normal(60)
                         + 0j)
    np.testing.assert_allclose(W.matvech(y).numpy(),
                               a.conj().T @ y.numpy(), rtol=1e-13)
    np.testing.assert_array_equal(W.get_diagonal().numpy(), a.diagonal())
    W2 = W.to("cpu")
    assert isinstance(W2, WithTranspose) and W2.device.type == "cpu"
    _, R = pair(nonsym(60, False, seed=7))
    W32 = with_explicit_transpose(R).to(dtype=torch.float32)
    assert W32.A.value.dtype == W32.At.value.dtype == torch.float32
