"""The scalar storage formats coo, csc, msr, ell, jad and dns against
lis_tpu's.

The same host CSR, made from a seed with numpy, goes through lis_tpu's
``convert_matrix`` and the port's: every array of the port's format must
equal the matching leaf of lis_tpu's exactly (values, indices and their
types), ``to_csr_arrays`` too, and matvec and matvech agree to rtol 1e-13
(summation orders differ).  ``from_numpy_state`` rebuilds each format
from lis_tpu's own leaves, so the port's matvec also runs on lis_tpu's
exact layout.  The generic methods of the base class (``to_dense``,
``get_diagonal``, ``shift_diagonal``, ``axpy``, the scalings) and the
formats' particular behaviour (ELL/JAD padding, explicit zeros, the MSR
diagonal, DNS from a dense array) follow.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lis_tpu
from lis_tpu.matrix.convert import convert_matrix as jconvert
import lis_tpu_torch
from lis_tpu_torch.interop.state import from_numpy_state
from lis_tpu_torch.matrix.convert import convert_matrix as tconvert

FORMATS = ["coo", "csc", "msr", "ell", "jad", "dns"]
# (rows, cols, complex); lis_tpu's MSR matvec takes only nrows <= ncols
SHAPES = {"square": (60, 60, False), "complex": (60, 60, True),
          "wide": (40, 70, False), "tall": (70, 40, False)}


def random_csr(n, m, cplx, seed=0, density=0.12):
    """A random sparse matrix with a full diagonal where it is square,
    explicit zeros absent (scipy canonical CSR)."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, m, density=density, random_state=rng, format="csr")
    if cplx:
        a = a + 1j * sp.random(n, m, density=density, random_state=rng,
                               format="csr")
    k = min(n, m)
    a = (a + sp.eye(n, m) * (4 + rng.random(k).mean())).tocsr()
    a.sort_indices()
    return a


def both(a):
    args = (a.indptr, a.indices, a.data, a.shape)
    return (lis_tpu.CSRMatrix.from_csr_arrays(*args),
            lis_tpu_torch.CSRMatrix.from_csr_arrays(*args, device="cpu"))


def converted(a, fmt):
    """(lis_tpu's, the port's) ``a`` in format ``fmt``."""
    J, T = both(a)
    return jconvert(J, fmt), tconvert(T, fmt, device="cpu")


def vec(n, cplx, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    return v + 1j * rng.standard_normal(n) if cplx else v


def leaves(J):
    """lis_tpu's format as ({array field: numpy array}, {static: value})."""
    arrays, statics = {}, {}
    for f in dataclasses.fields(J):
        val = getattr(J, f.name)
        if f.metadata.get("static"):
            statics[f.name] = val
        else:
            arrays[f.name] = np.asarray(val)
    return arrays, statics


def cases():
    for fmt in FORMATS:
        for name in SHAPES:
            if fmt == "msr" and name == "tall":
                continue
            yield pytest.param(fmt, name, id=f"{fmt}-{name}")


@pytest.mark.parametrize("fmt,shape", list(cases()))
def test_layout_and_products_match_lis_tpu(fmt, shape):
    n, m, cplx = SHAPES[shape]
    J, T = converted(random_csr(n, m, cplx, seed=n + m), fmt)
    assert T.format_name == fmt and T.device.type == "cpu"
    arrays, statics = leaves(J)
    for name, want in arrays.items():
        got = getattr(T, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name, want in statics.items():
        assert getattr(T, name) == want, name
    for got, want in zip(T.to_csr_arrays(), J.to_csr_arrays()):
        want = np.asarray(want)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    x, y = vec(m, cplx, 1), vec(n, cplx, 2)
    want_mv = np.asarray(J.matvec(jnp.asarray(x)))
    want_mvh = np.asarray(J.matvech(jnp.asarray(y)))
    np.testing.assert_allclose(T.matvec(torch.from_numpy(x)).numpy(),
                               want_mv, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(T.matvech(torch.from_numpy(y)).numpy(),
                               want_mvh, rtol=1e-13, atol=1e-13)
    # the port's products on lis_tpu's own leaves
    S = from_numpy_state(fmt, arrays, statics, device="cpu")
    assert type(S) is type(T)
    np.testing.assert_allclose(S.matvec(torch.from_numpy(x)).numpy(),
                               want_mv, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(S.matvech(torch.from_numpy(y)).numpy(),
                               want_mvh, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("fmt", FORMATS)
def test_generic_methods_match_lis_tpu(fmt):
    """to_dense, get_diagonal (the format's own or the base class's, on the
    matrix's device), shift_diagonal, axpy and both scalings, each
    rebuilt in the same format."""
    J, T = converted(random_csr(50, 50, False, seed=7), fmt)
    np.testing.assert_array_equal(T.to_dense(), J.to_dense())
    d = T.get_diagonal()
    assert isinstance(d, torch.Tensor) and d.device.type == "cpu"
    np.testing.assert_array_equal(d.numpy(), np.asarray(J.get_diagonal()))
    J2, T2 = converted(random_csr(50, 50, False, seed=8), fmt)
    s = vec(50, False, 3)
    for got, want in ((T.shift_diagonal(1.5), J.shift_diagonal(1.5)),
                      (T.axpy(-0.5, T2), J.axpy(-0.5, J2)),
                      (T.scale_rows(torch.from_numpy(s)),
                       J.scale_rows(jnp.asarray(s))),
                      (T.scale_symm(torch.from_numpy(np.abs(s))),
                       J.scale_symm(jnp.asarray(np.abs(s))))):
        assert got.format_name == fmt and got.device.type == "cpu"
        for g, w in zip(got.to_csr_arrays(), want.to_csr_arrays()):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-15)


@pytest.mark.parametrize("fmt", ["ell", "jad"])
def test_padding_and_explicit_zeros_follow_lis_tpu(fmt):
    """Rows are padded with column 0 and value 0, unmasked: a NaN in x[0]
    reaches every padded row, as in lis_tpu.  to_csr_arrays drops entries
    by the value mask, explicit zeros included, as lis_tpu's does."""
    ptr = np.array([0, 3, 4, 6, 6, 8])
    idx = np.array([0, 2, 4, 1, 2, 3, 1, 4])
    val = np.array([1.0, 0.0, 2.0, 3.0, 4.0, 0.0, 5.0, 6.0])
    J, T = converted(sp.csr_matrix((val, idx, ptr), shape=(5, 5)), fmt)
    for g, w in zip(T.to_csr_arrays(), J.to_csr_arrays()):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert len(T.to_csr_arrays()[1]) == 6
    x = np.array([np.nan, 1.0, 2.0, 3.0, 4.0])
    got = T.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got),
                                  np.isnan(np.asarray(J.matvec(
                                      jnp.asarray(x)))))
    assert np.isnan(got).all()


def test_jad_to_csr_arrays_matches_lis_tpu_at_size():
    """The vectorised JAD to_csr_arrays against lis_tpu's row loop on rows
    of every length 0-30 and explicit zeros; the result is cached."""
    rng = np.random.default_rng(5)
    n = 3000
    lens = rng.integers(0, 31, n)
    ptr = np.concatenate([[0], np.cumsum(lens)])
    idx = np.concatenate([np.sort(rng.choice(n, k, replace=False))
                          for k in lens])
    val = rng.standard_normal(len(idx))
    val[rng.random(len(val)) < 0.05] = 0.0
    J, T = converted(sp.csr_matrix((val, idx, ptr), shape=(n, n)), "jad")
    got = T.to_csr_arrays()
    for g, w in zip(got, J.to_csr_arrays()):
        w = np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert T.to_csr_arrays() is got


def test_msr_sums_duplicate_diagonal_entries_like_lis_tpu():
    ptr = np.array([0, 3, 4])
    idx = np.array([0, 0, 1, 1])
    val = np.array([1.0, 2.5, -1.0, 3.0])
    J = lis_tpu.matrix.msr.MSRMatrix.from_csr_arrays(ptr, idx, val, (2, 2))
    T = lis_tpu_torch.MSRMatrix.from_csr_arrays(ptr, idx, val, (2, 2),
                                                device="cpu")
    np.testing.assert_array_equal(T.diag.numpy(), np.asarray(J.diag))
    np.testing.assert_array_equal(T.get_diagonal().numpy(), [3.5, 3.0])


def test_dns_from_dense_and_mixed_types():
    rng = np.random.default_rng(2)
    d = rng.standard_normal((7, 5))
    d[d < 0] = 0
    J = lis_tpu.matrix.dns.DNSMatrix.from_dense(d)
    T = lis_tpu_torch.DNSMatrix.from_dense(d, device="cpu")
    assert T.nnz == J.nnz and T.shape == (7, 5)
    np.testing.assert_array_equal(T.to_dense(), d)
    # a real matrix times a complex vector, and -f single's f32 copy
    x = vec(5, True, 4)
    np.testing.assert_allclose(T.matvec(torch.from_numpy(x)).numpy(), d @ x,
                               rtol=1e-14)
    T32 = T.to(dtype=torch.float32)
    assert T32.value.dtype == torch.float32
    np.testing.assert_allclose(
        T32.matvec(torch.ones(5, dtype=torch.float32)).numpy(),
        d.sum(axis=1), rtol=1e-6)


@pytest.mark.parametrize("target,item", [("bsr", "8b"), ("bsc", "8b"),
                                         ("vbr", "8b"), ("bes", "8c")])
def test_unported_formats_name_their_item(target, item):
    _, T = both(random_csr(20, 20, False))
    with pytest.raises(NotImplementedError, match=f"queue 1 item {item}"):
        tconvert(T, target, device="cpu")


def test_host_csr_cache_survives_a_device_move():
    """A format's cached host CSR arrays are kept by .to(device) and
    dropped by a type cast."""
    _, T = both(random_csr(30, 30, False))
    E = tconvert(T, "ell", device="cpu")
    arrays = E.to_csr_arrays()
    assert E.to("cpu").to_csr_arrays() is arrays
    assert getattr(E.to(dtype=torch.float32), "_host_csr", None) is None
