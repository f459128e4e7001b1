"""lis_tpu_torch.matrix.cst against lis_tpu.matrix.cst and scipy.

The host build must give equal arrays, statics and Benes plans; the plain
front (kernel A's CPU version) must equal lis_tpu's unfused select x val
chain; matvec/matvech hold to rtol 1e-12 (summation order differs) on the
port's own grid and on lis_tpu's grid carried over by from_numpy_state.
Grids: the locality-free SPD system a + aᵀ + 4k·I with k random columns
per row, at n = 2^15, k = 5 (3-pass plan, CSR remainder) and n = 2^16,
k = 8 (5-pass plan).
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

from lis_tpu.matrix.cst import CSTMatrix as JCST
from lis_tpu_torch.interop.state import from_numpy_state
from lis_tpu_torch.matrix.cst import CSTMatrix as TCST, cst_front

GRIDS = [(1 << 15, 5), (1 << 16, 8)]


def spd(n, k, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, size=n * k)
    a = sp.coo_matrix((rng.standard_normal(n * k), (rows, cols)),
                      shape=(n, n)).tocsr()
    a = (a + a.T + sp.eye(n) * (4 * k)).tocsr()
    a.sort_indices()
    return a


@pytest.fixture(scope="module", params=GRIDS, ids=["n15k5", "n16k8"])
def grid(request):
    n, k = request.param
    a = spd(n, k)
    args = (a.indptr, a.indices, a.data, a.shape)
    return a, JCST.from_csr_arrays(*args), TCST.from_csr_arrays(*args)


def to_state(obj):
    """A lis_tpu format/plan as the (kind, arrays, statics) triple that
    from_numpy_state takes, leaves turned into numpy arrays."""
    from lis_tpu.ops.shuffle import ShufflePlan
    if obj is None:
        return None
    if isinstance(obj, ShufflePlan):
        small = None if obj.small is None else np.asarray(obj.small)
        return ("plan", {"idxs": [np.asarray(i) for i in obj.idxs],
                         "small": small}, {"meta": obj.meta, "M": obj.M})
    arrays, statics = {}, {}
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if f.metadata.get("static"):
            statics[f.name] = val
        elif val is None or dataclasses.is_dataclass(val):
            arrays[f.name] = to_state(val)
        else:
            arrays[f.name] = np.asarray(val)
    return (obj.format_name, arrays, statics)


def _assert_same_build(t, j):
    for name in ("nrows", "ncols", "nnz", "n_pad", "Kp", "beta", "RBc"):
        assert getattr(t, name) == getattr(j, name), name
    for name in ("val", "lidx", "rowf", "diag"):
        tv, jv = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert tv.dtype == jv.dtype, name
        np.testing.assert_array_equal(tv, jv, err_msg=name)
    assert t.plan.meta == j.plan.meta and t.plan.M == j.plan.M
    for ti, ji in zip(t.plan.idxs, j.plan.idxs, strict=True):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (t.rem is None) == (j.rem is None)
    if t.rem is not None:
        for name in ("ptr", "index", "value", "row_ids"):
            np.testing.assert_array_equal(getattr(t.rem, name).numpy(),
                                          np.asarray(getattr(j.rem, name)))


def test_build_equals_lis_tpu(grid):
    a, J, T = grid
    _assert_same_build(T, J)
    assert T.at is not None and J.at is not None
    _assert_same_build(T.at, J.at)
    assert T.at.at is None


def test_grid_shapes(grid):
    """The plans the slice's dispatch sees: 3 tile-local passes below
    M = 2^21, 5 passes with the 16384-stride pair from M = 2^21 on."""
    a, J, T = grid
    if T.n_pad == 1 << 15:
        assert (T.Kp, T.RBc) == (16, 32)
        assert T.plan.meta == ((128, 128), (128, 1), (128, 128))
        assert T.rem is not None
    else:
        assert (T.Kp, T.RBc, T.beta) == (32, 1, 4096)
        assert T.plan.meta == ((128, 16384), (128, 128), (128, 1),
                               (128, 128), (128, 16384))


def test_profile_and_pick_kp(grid):
    a, J, T = grid
    assert TCST.profile(a.indptr, a.indices, a.shape) == \
        JCST.profile(a.indptr, a.indices, a.shape)
    for mean_k in (0.5, 3.0, 11.0, 200.0, 900.0):
        assert TCST._pick_kp(mean_k) == JCST._pick_kp(mean_k)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plain_front_equals_unfused_front(grid, dtype):
    """cst_front's CPU version == lis_tpu's unfused front (cst.py:323-327:
    select, times val, bucket transpose) — the same products, bit-equal."""
    a, J, T = grid
    x = np.random.default_rng(2).standard_normal(a.shape[0]).astype(dtype)
    Jd = J if dtype == np.float64 else dataclasses.replace(
        J, val=J.val.astype(jnp.float32))
    CB = J.n_pad // 128
    sel = Jd._select(jnp.asarray(x))
    want = jnp.swapaxes((sel * Jd.val).reshape(CB, J.RBc, J.beta), 0, 1)
    xp = torch.nn.functional.pad(torch.from_numpy(x),
                                 (0, T.n_pad - a.shape[0]))
    got = cst_front(xp, T.lidx, T.val.to(xp.dtype), T.RBc, T.beta)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(-1))


def test_matvec_matches_lis_tpu_and_scipy(grid):
    a, J, T = grid
    x = np.random.default_rng(3).standard_normal(a.shape[0])
    xt = torch.from_numpy(x)
    ref = a @ x
    got = T.matvec(xt).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(J.matvec(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    goth = T.matvech(xt).numpy()
    np.testing.assert_allclose(goth, a.T @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(goth, np.asarray(J.matvech(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(T.get_diagonal().numpy(), a.diagonal())


def test_lis_tpu_grid_through_from_numpy_state(grid):
    """lis_tpu's own grid, carried over leaf by leaf, runs in the port."""
    a, J, T = grid
    C = from_numpy_state(*to_state(J))
    assert isinstance(C, TCST) and isinstance(C.at, TCST)
    _assert_same_build(C, J)
    x = np.random.default_rng(4).standard_normal(a.shape[0])
    np.testing.assert_allclose(C.matvec(torch.from_numpy(x)).numpy(),
                               a @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(C.matvech(torch.from_numpy(x)).numpy(),
                               a.T @ x, rtol=1e-12, atol=1e-12)


def test_to_csr_roundtrip_and_cast(grid):
    a, J, T = grid
    p, i, v = T.to_csr_arrays()
    b = sp.csr_matrix((v, i, p), shape=a.shape)
    assert abs(b - a).max() == 0
    T32 = T.to("cpu", dtype=torch.float32)
    assert T32.val.dtype == torch.float32 and T32.lidx.dtype == torch.uint8
    assert T32.at.val.dtype == torch.float32
    assert T32.plan.idxs[0].dtype == torch.uint8
    x = np.random.default_rng(5).standard_normal(a.shape[0])
    np.testing.assert_allclose(
        T32.matvec(torch.from_numpy(x).float()).numpy(), a @ x,
        rtol=1e-4, atol=1e-4)


def test_matvech_fallback_is_conjugate_transpose():
    """Without a transpose grid matvech is one scatter-add.  On complex
    data it must give Aᴴx; lis_tpu's conjugates x as well (cst.py:347)."""
    rng = np.random.default_rng(6)
    n, k = 3000, 6
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, size=n * k)
    vals = rng.standard_normal(n * k) + 1j * rng.standard_normal(n * k)
    a = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    a.sum_duplicates()
    a.sort_indices()
    T = TCST.from_csr_arrays(a.indptr, a.indices, a.data, a.shape,
                             transpose=False)
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    np.testing.assert_allclose(T.matvech(torch.from_numpy(x)).numpy(),
                               a.conj().T @ x, rtol=1e-12, atol=1e-12)
    xr = rng.standard_normal(n)
    ar = a.real.tocsr()
    Tr = TCST.from_csr_arrays(ar.indptr, ar.indices, ar.data, ar.shape,
                              transpose=False)
    np.testing.assert_allclose(Tr.matvech(torch.from_numpy(xr)).numpy(),
                               ar.T @ xr, rtol=1e-12, atol=1e-12)


def test_scaling_not_ported():
    a = spd(1 << 14, 3)
    T = TCST.from_csr_arrays(a.indptr, a.indices, a.data, a.shape,
                             transpose=False)
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        T.scale_symm(torch.ones(a.shape[0], dtype=torch.float64))
