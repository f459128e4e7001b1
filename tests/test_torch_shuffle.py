"""lis_tpu_torch.ops.shuffle against lis_tpu.ops.shuffle.

Host routing must give equal pass tables for the same permutation (both
packages call the same native colouring); the plain versions of kernels
B, C and D must reproduce lis_tpu's CPU application bit for bit for
permutations (row sums: rtol 1e-13 at f64, the summation order differs)
and lis_tpu's interpreted Pallas run kernel at f32.  The CUDA kernels are
held against these plain versions in tests/test_torch_gpu.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lis_tpu.ops import shuffle as jsh
from lis_tpu_torch.ops import shuffle as tsh


def _perm(M, n_real, seed, block=None):
    """A partial permutation of M slots with n_real real entries; with
    ``block`` every element stays inside its block-aligned span."""
    rng = np.random.default_rng(seed)
    src = np.sort(rng.choice(M, size=n_real, replace=False))
    if block is None:
        dst = rng.choice(M, size=n_real, replace=False)
    else:
        dst = np.empty(n_real, dtype=np.int64)
        for b0 in range(0, M, block):
            sel = (src >= b0) & (src < b0 + block)
            dst[sel] = b0 + rng.choice(block, size=int(sel.sum()),
                                       replace=False)
    perm = np.full(M, -1, dtype=np.int64)
    perm[src] = dst
    return perm


def _row_perms(rng, M):
    return np.argsort(rng.random((M // 128, 128)), axis=1).astype(np.uint8)


@pytest.mark.parametrize("M,n_real,block,exact_holes,skip_identity", [
    (1 << 15, 20000, None, False, True),
    (1 << 15, 32768, None, True, True),
    (1 << 16, 30000, 1 << 14, True, True),
    (1 << 16, 30000, 1 << 14, True, False),
])
def test_plan_tables_equal(M, n_real, block, exact_holes, skip_identity):
    perm = _perm(M, n_real, seed=M + n_real, block=block)
    digits = tsh.block_digits(M, block) if block else None
    assert digits == (jsh.block_digits(M, block) if block else None)
    kw = dict(digits=digits, exact_holes=exact_holes,
              skip_identity=skip_identity)
    pj = jsh.plan_shuffle(perm, **kw)
    pt = tsh.plan_shuffle(perm, **kw)
    assert pt.meta == pj.meta and pt.M == pj.M
    assert len(pt.idxs) == len(pj.idxs)
    for it, ij in zip(pt.idxs, pj.idxs):
        assert it.dtype == torch.uint8
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    # the plan realises the permutation
    v = np.arange(M, dtype=np.float64)
    out = pt.apply(torch.from_numpy(v)).numpy()
    real = perm >= 0
    np.testing.assert_array_equal(out[perm[real]], v[real])


def test_digits_and_small_plans_match():
    for M in (1 << 14, 1 << 15, 1 << 21, 1 << 25):
        assert tsh.factor_digits(M) == jsh.factor_digits(M)
    assert tsh.block_digits(1 << 25, 1 << 21) == [16, 128, 128, 128]
    perm = _perm(1 << 12, 3000, seed=3)
    pj = jsh.plan_shuffle(perm)
    pt = tsh.plan_shuffle(perm)
    np.testing.assert_array_equal(pt.small.numpy(), np.asarray(pj.small))
    v = np.random.default_rng(0).standard_normal(1 << 12)
    np.testing.assert_array_equal(
        pt.apply_rowsum(torch.from_numpy(v), 4).numpy(),
        np.asarray(pj.apply_rowsum(jnp.asarray(v), 4)))


@pytest.mark.parametrize("s", [1, 128, 16384])
def test_benes_pass_plain_matches_apply_host(s):
    rng = np.random.default_rng(s)
    M = max(1 << 15, 128 * s)
    idx = _row_perms(rng, M)
    x = rng.standard_normal(M)
    got = tsh.benes_pass(torch.from_numpy(x), torch.from_numpy(idx), 128, s)
    np.testing.assert_array_equal(got.numpy(),
                                  jsh.apply_host([(128, s, idx)], x, M))


@pytest.mark.parametrize("s,Kp", [(16384, 32), (16384, 2), (1024, 256),
                                  (128, 16)])
def test_benes_pass_rowsum_plain_matches_apply_host(s, Kp):
    rng = np.random.default_rng(s + Kp)
    M = max(1 << 15, 128 * s)
    idx = _row_perms(rng, M)
    x = rng.standard_normal(M)
    got = tsh.benes_pass_rowsum(torch.from_numpy(x), torch.from_numpy(idx),
                                s, Kp)
    want = jsh.apply_host([(128, s, idx)], x, M).reshape(-1, Kp).sum(axis=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("Kp", [None, 16, 32, 128])
def test_benes_small_run_plain_matches_apply_host(Kp):
    rng = np.random.default_rng(7)
    M = 1 << 15
    ss = [128, 1, 128]
    idx = [_row_perms(rng, M) for _ in ss]
    x = rng.standard_normal(M)
    got = tsh.benes_small_run(torch.from_numpy(x),
                              [torch.from_numpy(i) for i in idx], ss, Kp=Kp)
    want = jsh.apply_host([(128, s, i) for s, i in zip(ss, idx)], x, M)
    if Kp is None:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(),
                                   want.reshape(-1, Kp).sum(axis=1),
                                   rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("Kp", [None, 2, 128])
def test_benes_small_run_plain_matches_pallas_interpret_f32(Kp):
    """At f32 the plain run equals lis_tpu's _fused_small32 run in Pallas
    interpret mode (as tests/test_formats.py runs it); row sums to rtol
    1e-5, the f32 summation order differs."""
    rng = np.random.default_rng(9)
    M = 1 << 15
    ss = [128, 1, 128]
    idx = [_row_perms(rng, M) for _ in ss]
    x = rng.standard_normal(M).astype(np.float32)
    want = np.asarray(jsh._fused_small32(
        jnp.asarray(x), [jnp.asarray(i) for i in idx], ss, M, Kp=Kp,
        interpret=True))
    got = tsh.benes_small_run(torch.from_numpy(x),
                              [torch.from_numpy(i) for i in idx], ss,
                              Kp=Kp).numpy()
    if Kp is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("M,block,Kp", [(1 << 16, 1 << 14, 8),
                                        (1 << 21, 1 << 21, 32)])
def test_plan_apply_matches_lis_tpu(M, block, Kp):
    """ShufflePlan.apply / apply_rowsum (the dispatch over kernels B, C,
    D, here through their plain versions) against lis_tpu's CPU path."""
    n_real = M // 2
    perm = _perm(M, n_real, seed=11, block=block)
    kw = dict(digits=tsh.block_digits(M, block), exact_holes=True,
              validate=False)
    pj = jsh.plan_shuffle(perm, **kw)
    pt = tsh.plan_shuffle(perm, **kw)
    rng = np.random.default_rng(1)
    v = np.zeros(M)
    v[perm >= 0] = rng.standard_normal(n_real)      # holes carry zeros
    np.testing.assert_array_equal(pt.apply(torch.from_numpy(v)).numpy(),
                                  np.asarray(pj.apply(jnp.asarray(v))))
    np.testing.assert_allclose(
        pt.apply_rowsum(torch.from_numpy(v), Kp).numpy(),
        np.asarray(pj.apply_rowsum(jnp.asarray(v), Kp)),
        rtol=1e-13, atol=1e-13)


def test_small_run_takes_only_strides_1_and_128():
    """lis_tpu's run detector admits 1 < s < 128 (ops/shuffle.py:668),
    which its tile kernel would permute wrongly; the port's does not, and
    the run kernel's wrapper refuses such a stride."""
    meta = ((128, 128), (128, 2), (128, 1))
    assert jsh._small_run(meta) == (0, 3)
    assert tsh._small_run(meta) is None
    assert tsh._small_run(((128, 16384), (128, 128), (128, 1), (128, 128),
                           (128, 16384))) == (1, 4)
    x = torch.zeros(1 << 15)
    idx = torch.zeros((1 << 8, 128), dtype=torch.uint8)
    with pytest.raises(ValueError, match="strides 1 and 128"):
        tsh.benes_small_run(x, [idx, idx], [128, 2])


def test_plan_cache_key_includes_validate(monkeypatch):
    """lis_tpu keys its plan cache without ``validate`` (ops/shuffle.py:
    824), so a plan cached unvalidated skips a later validate=True check.
    Here a corrupt routing cached with validate=False is still caught."""
    monkeypatch.setattr(tsh, "_PLAN_CACHE", {})
    real_route = tsh._route

    def bad_route(*a, **k):
        passes = real_route(*a, **k)
        d, s, idx = passes[0]
        return [(d, s, np.roll(idx, 1, axis=1))] + passes[1:]

    monkeypatch.setattr(tsh, "_route", bad_route)
    perm = _perm(1 << 15, 20000, seed=5)
    tsh.plan_shuffle(perm, validate=False)
    with pytest.raises(AssertionError, match="wrong plan"):
        tsh.plan_shuffle(perm, validate=True)


def test_plan_cache_bounded_by_bytes(monkeypatch):
    """The cache evicts by bytes held, not by plan count (lis_tpu keeps 16
    plans of any size, ops/shuffle.py:801)."""
    monkeypatch.setattr(tsh, "_PLAN_CACHE", {})
    perms = [_perm(1 << 15, 20000, seed=s) for s in range(3)]
    size = tsh.plan_shuffle(perms[0], validate=False).nbytes
    tsh._PLAN_CACHE.clear()
    monkeypatch.setattr(tsh, "_PLAN_CACHE_MAX_BYTES", 2 * size + size // 2)
    plans = [tsh.plan_shuffle(p, validate=False) for p in perms]
    assert len(tsh._PLAN_CACHE) == 2
    assert sum(p.nbytes for p in tsh._PLAN_CACHE.values()) \
        <= tsh._PLAN_CACHE_MAX_BYTES
    assert plans[0] not in tsh._PLAN_CACHE.values()      # oldest evicted
    assert tsh.plan_shuffle(perms[2], validate=False) is plans[2]
    monkeypatch.setattr(tsh, "_PLAN_CACHE_MAX_BYTES", size // 2)
    tsh._PLAN_CACHE.clear()
    tsh.plan_shuffle(perms[1], validate=False)
    assert not tsh._PLAN_CACHE                 # larger than the budget


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1 << 15, device="meta")
    idx = torch.zeros((1 << 8, 128), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain path"):
        tsh.benes_pass(x, idx, 128, 128)
