"""lis_tpu_torch.ops.shuffle.lane_shuffle (kernel #1) and the passes with a
digit below 128, against lis_tpu.ops.shuffle.

``lane_shuffle``'s plain version must reproduce lis_tpu's dtype-generic
``_lane_shuffle`` bit for bit in f32, f64, complex64 and complex128 (a
gather moves values, it rounds nothing), with and without the chunk
repeat that ``CSTMatrix._select`` folds into it.  ``benes_pass`` with
d < 128 (the legacy route around ``lane_shuffle``) must equal
``apply_host``, and a plan without block digits, real or complex, must
equal lis_tpu's CPU application.  The CUDA kernel is held against the
plain version in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lis_tpu.ops import shuffle as jsh
from lis_tpu_torch.ops import shuffle as tsh
from tests.test_torch_shuffle import _perm, _row_perms

DTYPES = [np.float32, np.float64, np.complex64, np.complex128]


def _values(rng, shape, dtype):
    x = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


@pytest.mark.parametrize("rep", [1, 16])
@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_matches_lis_tpu(dtype, rep):
    rng = np.random.default_rng(rep)
    R = 1 << 9
    x = _values(rng, (R // rep, 128), dtype)
    idx = rng.integers(0, 128, size=(R, 128), dtype=np.uint8)
    want = np.asarray(jsh._lane_shuffle(jnp.repeat(jnp.asarray(x), rep,
                                                   axis=0),
                                        jnp.asarray(idx)))
    got = tsh.lane_shuffle(torch.from_numpy(x), torch.from_numpy(idx),
                           rep=rep)
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_checks_and_counts_no_cpu_launch():
    before = tsh.lane_shuffle.launches
    x = torch.zeros((4, 128), dtype=torch.float64)
    idx = torch.zeros((16, 128), dtype=torch.uint8)
    assert tsh.lane_shuffle(x, idx, rep=4).shape == (16, 128)
    assert tsh.lane_shuffle.launches == before
    for bad in (dict(rep=3), dict(rep=2), dict(rep=8)):
        with pytest.raises(ValueError, match="lane_shuffle"):
            tsh.lane_shuffle(x, idx, **bad)
    with pytest.raises(ValueError, match="no kernel or plain path"):
        tsh.lane_shuffle(x.to("meta"), idx.to("meta"), rep=4)


@pytest.mark.parametrize("d,s", [(2, 16384), (16, 128), (16, 1), (64, 8)])
def test_benes_pass_small_digit_matches_apply_host(d, s):
    rng = np.random.default_rng(d + s)
    M = max(1 << 15, d * s * 2)
    idx = _row_perms(rng, M)
    x = rng.standard_normal(M)
    got = tsh.benes_pass(torch.from_numpy(x), torch.from_numpy(idx), d, s)
    np.testing.assert_array_equal(got.numpy(),
                                  jsh.apply_host([(d, s, idx)], x, M))


@pytest.mark.parametrize("M,first", [(1 << 15, 2), (1 << 18, 16)])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_plan_without_block_digits_matches_lis_tpu(M, first, dtype):
    """A general plan_shuffle plan (digits from factor_digits, the first
    one below 128) runs its leading and trailing passes through the
    legacy route; complex vectors go through as two planes."""
    perm = _perm(M, M // 2, seed=M)
    pj = jsh.plan_shuffle(perm, exact_holes=True, validate=False)
    pt = tsh.plan_shuffle(perm, exact_holes=True, validate=False,
                          device="cpu")
    assert pt.meta == pj.meta and pt.meta[0][0] == first
    v = np.zeros(M, dtype=dtype)
    v[perm >= 0] = _values(np.random.default_rng(2), M // 2, dtype)
    np.testing.assert_array_equal(pt.apply(torch.from_numpy(v)).numpy(),
                                  np.asarray(pj.apply(jnp.asarray(v))))
    np.testing.assert_allclose(
        pt.apply_rowsum(torch.from_numpy(v), 8).numpy(),
        np.asarray(pj.apply_rowsum(jnp.asarray(v), 8)),
        rtol=1e-13, atol=1e-13)
