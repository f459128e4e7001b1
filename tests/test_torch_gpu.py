"""The lis_tpu_torch CUDA kernels against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one.  The file
imports neither jax nor lis_tpu, so it runs where only the port is
installed:

    python -m pytest tests/test_torch_gpu.py -q --noconftest -p no:cacheprovider

Pure permutations must be bit-equal.  Row sums are compared to rtol 1e-12
(f64) or 1e-5 (f32): the kernels sum in another order.  The CSR remainder
of a CST matvec sums with atomics on the card, hence 1e-12 there too.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from lis_tpu_torch.matrix.cst import CSTMatrix, cst_front
from lis_tpu_torch.ops import shuffle as tsh

DTYPES = [torch.float32, torch.float64]


def _rtol(dtype):
    return 1e-12 if dtype == torch.float64 else 1e-5


def _row_perms(rng, M):
    idx = np.argsort(rng.random((M // 128, 128)), axis=1).astype(np.uint8)
    return torch.from_numpy(idx)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (gpu tier)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [1, 2, 128, 16384])
def test_benes_pass(cuda, dtype, s):
    rng = np.random.default_rng(s)
    M = max(1 << 16, 128 * s)
    idx = _row_perms(rng, M)
    x = torch.from_numpy(rng.standard_normal(M)).to(dtype)
    want = tsh.benes_pass(x, idx, 128, s)
    got = tsh.benes_pass(x.to(cuda), idx.to(cuda), 128, s)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s,Kp", [(16384, 32), (16384, 2), (1024, 256),
                                  (128, 16), (16, 4)])
def test_benes_pass_rowsum(cuda, dtype, s, Kp):
    rng = np.random.default_rng(s + Kp)
    M = max(1 << 16, 128 * s)
    idx = _row_perms(rng, M)
    x = torch.from_numpy(rng.standard_normal(M)).to(dtype)
    want = tsh.benes_pass_rowsum(x, idx, s, Kp)
    got = tsh.benes_pass_rowsum(x.to(cuda), idx.to(cuda), s, Kp).cpu()
    torch.testing.assert_close(got, want, rtol=_rtol(dtype),
                               atol=_rtol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Kp", [None, 16, 32, 128])
def test_benes_small_run(cuda, dtype, Kp):
    rng = np.random.default_rng(3)
    M = 1 << 16
    ss = [128, 1, 128]
    idx = [_row_perms(rng, M) for _ in ss]
    x = torch.from_numpy(rng.standard_normal(M)).to(dtype)
    want = tsh.benes_small_run(x, idx, ss, Kp=Kp)
    got = tsh.benes_small_run(x.to(cuda), [i.to(cuda) for i in idx], ss,
                              Kp=Kp).cpu()
    if Kp is None:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=_rtol(dtype),
                                   atol=_rtol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("CB,RBc,beta", [(128, 16, 256), (64, 1, 4096),
                                         (256, 32, 64), (256, 1, 16)])
def test_cst_front(cuda, dtype, CB, RBc, beta):
    rng = np.random.default_rng(CB + beta)
    xp = torch.from_numpy(rng.standard_normal(CB * 128)).to(dtype)
    lidx = torch.from_numpy(rng.integers(0, 128, size=CB * RBc * beta,
                                         dtype=np.uint8))
    val = torch.from_numpy(rng.standard_normal(CB * RBc * beta)).to(dtype)
    want = cst_front(xp, lidx, val, RBc, beta)
    got = cst_front(xp.to(cuda), lidx.to(cuda), val.to(cuda), RBc, beta)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(1 << 15, 5), (1 << 16, 8)])
def test_cst_matvec(cuda, n, k):
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, size=n * k)
    a = sp.coo_matrix((rng.standard_normal(n * k), (rows, cols)),
                      shape=(n, n)).tocsr()
    a = (a + a.T + sp.eye(n) * (4 * k)).tocsr()
    a.sort_indices()
    T = CSTMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape)
    x = torch.from_numpy(rng.standard_normal(n))
    want = T.matvec(x)
    Tc = T.to(cuda)
    got = Tc.matvec(x.to(cuda)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(Tc.matvech(x.to(cuda)).cpu(), T.matvech(x),
                               rtol=1e-12, atol=1e-12)


def test_kernel_wrappers_need_cuda_for_kernels():
    """CPU tensors take the plain version and count no launch."""
    before = (tsh.benes_pass.launches, cst_front.launches)
    x = torch.zeros(1 << 15, dtype=torch.float64)
    idx = torch.zeros((1 << 8, 128), dtype=torch.uint8)
    tsh.benes_pass(x, idx, 128, 128)
    cst_front(torch.zeros(128, dtype=torch.float64), idx.view(-1)[:4096],
              torch.zeros(4096, dtype=torch.float64), 1, 4096)
    assert (tsh.benes_pass.launches, cst_front.launches) == before
