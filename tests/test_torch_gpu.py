"""The lis_tpu_torch CUDA kernels against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one.  The file
imports neither jax nor lis_tpu, so it runs where only the port is
installed:

    python -m pytest tests/test_torch_gpu.py -q --noconftest -p no:cacheprovider

Pure permutations (lane_shuffle in every dtype it takes, Benes passes)
must be bit-equal.  Row sums are compared to rtol 1e-12 (f64) or 1e-5
(f32): the kernels sum in another order.  The CSR remainder of a CST
matvec sums with atomics on the card, hence 1e-12 there too, and a solve
on the card may take one iteration more or less than on the CPU.

A matrix built with no ``device`` argument lives on the card (the port's
default device); the CPU side of each comparison asks for ``device="cpu"``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lis_tpu_torch
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


# runs of 1, 2, 3, 4 and 8 passes; 1 tile, 4 tiles, and 133 tiles (more
# than the grid's blocks, and a count that no grid divides)
RUNS = [[128, 1, 128], [1], [128], [1, 128], [128, 1], [1, 128, 1, 128],
        [128, 1, 1, 128, 128, 1, 128, 1]]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Kp", [None, 2, 16, 32, 128])
@pytest.mark.parametrize("ss", RUNS, ids=lambda ss: "-".join(map(str, ss)))
@pytest.mark.parametrize("M", [16384, 1 << 16, 16384 * 133])
def test_benes_small_run(cuda, dtype, Kp, ss, M):
    rng = np.random.default_rng(3)
    idx = [_row_perms(rng, M) for _ in ss]
    x = torch.from_numpy(rng.standard_normal(M)).to(dtype)
    want = tsh.benes_small_run(x, tsh.RunTables(idx, ss), Kp=Kp)
    before = tsh.benes_small_run.launches
    run = tsh.RunTables([i.to(cuda) for i in idx], ss)
    got = tsh.benes_small_run(x.to(cuda), run, Kp=Kp).cpu()
    assert tsh.benes_small_run.launches == before + 1
    if Kp is None:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=_rtol(dtype),
                                   atol=_rtol(dtype))


@pytest.mark.gpu
def test_benes_small_run_tables_are_reused(cuda):
    """A RunTables serves many launches and both dtypes, and refuses an x
    of another size, an x on another device than its tables, and a lane
    id of 128 or more."""
    rng = np.random.default_rng(4)
    M, ss = 1 << 15, [1, 128]
    idx = [_row_perms(rng, M) for _ in ss]
    run = tsh.RunTables([i.to(cuda) for i in idx], ss)
    host = tsh.RunTables(idx, ss)
    for dtype in DTYPES:
        x = torch.from_numpy(rng.standard_normal(M)).to(dtype)
        for Kp in (None, 8):
            want = tsh.benes_small_run(x, host, Kp=Kp)
            got = tsh.benes_small_run(x.to(cuda), run, Kp=Kp).cpu()
            torch.testing.assert_close(got, want, rtol=_rtol(dtype),
                                       atol=_rtol(dtype))
    with pytest.raises(ValueError, match="slots"):
        tsh.benes_small_run(torch.zeros(1 << 14, device=cuda), run)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tsh.benes_small_run(torch.zeros(M, device=cuda), host)
    bad = [i.to(cuda) for i in idx]
    bad[1] = bad[1] | 128
    with pytest.raises(ValueError, match="lane id"):
        tsh.benes_small_run(torch.zeros(M, device=cuda),
                            tsh.RunTables(bad, ss))


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


def _system(n, k, kind="spd"):
    """a + aᵀ + 4k·I, a − 0.5·aᵀ + 4k·I ("nonsym") or a complex-symmetric
    a + aᵀ + 4k·I ("csym"), a with k random columns per row."""
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, size=n * k)
    vals = rng.standard_normal(n * k)
    if kind == "csym":
        vals = vals + 1j * rng.standard_normal(n * k)
    a = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    a = (a - 0.5 * a.T if kind == "nonsym" else a + a.T) + sp.eye(n) * (4 * k)
    a = a.tocsr()
    a.sort_indices()
    return a


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(1 << 15, 5), (1 << 16, 8)])
def test_cst_matvec(cuda, n, k):
    a = _system(n, k)
    Tc = CSTMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape)
    assert Tc.device.type == Tc.at.plan.device.type == "cuda"
    T = Tc.to("cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(n))
    want = T.matvec(x)
    got = Tc.matvec(x.to(cuda)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(Tc.matvech(x.to(cuda)).cpu(), T.matvech(x),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES + [torch.complex64,
                                            torch.complex128])
@pytest.mark.parametrize("R,rep", [(4096, 1), (4096, 32), (1000, 1),
                                   (40, 8)])
def test_lane_shuffle(cuda, dtype, R, rep):
    rng = np.random.default_rng(R + rep)
    x = rng.standard_normal((R // rep, 128, 2))
    x = torch.from_numpy(x[..., 0] + 1j * x[..., 1] if dtype.is_complex
                         else x[..., 0]).to(dtype)
    idx = torch.from_numpy(rng.integers(0, 128, size=(R, 128),
                                        dtype=np.uint8))
    want = tsh.lane_shuffle(x, idx, rep=rep)
    before = tsh.lane_shuffle.launches
    got = tsh.lane_shuffle(x.to(cuda), idx.to(cuda), rep=rep)
    assert tsh.lane_shuffle.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("d,s", [(2, 16384), (16, 128), (16, 1), (64, 8)])
def test_benes_pass_small_digit(cuda, d, s):
    rng = np.random.default_rng(d + s)
    M = max(1 << 15, d * s * 2)
    idx = _row_perms(rng, M)
    x = torch.from_numpy(rng.standard_normal(M))
    want = tsh.benes_pass(x, idx, d, s)
    got = tsh.benes_pass(x.to(cuda), idx.to(cuda), d, s)
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k", [(1 << 15, 5), (1 << 16, 8)])
def test_complex_cst_matvec(cuda, n, k):
    """The select (lane_shuffle), then B, C and D on two planes; matvech
    through the transpose grid."""
    a = _system(n, k, "csym")
    Tc = CSTMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape)
    T = Tc.to("cpu")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(n) + 1j * rng.standard_normal(n))
    before = tsh.lane_shuffle.launches
    got = Tc.matvec(x.to(cuda)).cpu()
    assert tsh.lane_shuffle.launches > before
    torch.testing.assert_close(got, T.matvec(x), rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(Tc.matvech(x.to(cuda)).cpu(), T.matvech(x),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.gpu
def test_scaled_prebuilt_cst_bicg(cuda):
    """-scale 1 on a prebuilt CST scales the grid and its transpose grid
    on the card (lane_shuffle), then BiCG walks A and Aᴴ."""
    n = 1 << 15
    a = _system(n, 5, "nonsym")
    Tc = CSTMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape)
    b = np.random.default_rng(3).standard_normal(n)
    opts = "-i bicg -p jacobi -storage cst -scale 1 -tol 1e-10"
    want = lis_tpu_torch.solve(Tc.to("cpu"), b, options=opts)
    assert want.x.device.type == "cpu"
    before = tsh.lane_shuffle.launches
    got = lis_tpu_torch.solve(Tc, b, options=opts)
    assert got.x.is_cuda
    assert tsh.lane_shuffle.launches > before
    assert got.status == want.status == lis_tpu_torch.LIS_SUCCESS
    assert abs(got.iters - want.iters) <= 1
    x = got.x.cpu().numpy()
    assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) <= 1e-9


@pytest.mark.gpu
def test_from_csr_arrays_then_solve_runs_on_the_card(cuda):
    """The README's usage: no device anywhere, so the CSR input, the CST
    that -storage cst converts it to, and the solve are all on the card."""
    n = 1 << 15
    a = _system(n, 5)
    A = lis_tpu_torch.CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data,
                                                a.shape)
    assert A.device.type == "cuda"
    before = tsh.benes_small_run.launches
    r = lis_tpu_torch.solve(A, np.ones(n),
                            options="-i cg -p jacobi -storage cst -tol 1e-10")
    assert r.x.is_cuda and tsh.benes_small_run.launches > before
    assert r.status == lis_tpu_torch.LIS_SUCCESS and r.true_resid <= 1e-9


def test_kernel_wrappers_need_cuda_for_kernels():
    """CPU tensors take the plain version and count no launch."""
    before = (tsh.benes_pass.launches, cst_front.launches,
              tsh.lane_shuffle.launches)
    x = torch.zeros(1 << 15, dtype=torch.float64)
    idx = torch.zeros((1 << 8, 128), dtype=torch.uint8)
    tsh.benes_pass(x, idx, 128, 128)
    tsh.benes_pass(x, idx, 16, 8)
    tsh.lane_shuffle(x.view(-1, 128), idx)
    cst_front(torch.zeros(128, dtype=torch.float64), idx.view(-1)[:4096],
              torch.zeros(4096, dtype=torch.float64), 1, 4096)
    assert (tsh.benes_pass.launches, cst_front.launches,
            tsh.lane_shuffle.launches) == before
