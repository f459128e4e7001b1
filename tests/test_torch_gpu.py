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


# ---- kernels E and F (DIA products) and G (the fused CG step) ---------------

ALL_DTYPES = DTYPES + [torch.complex64, torch.complex128]


def _randn(rng, shape, dtype):
    a = rng.standard_normal(shape)
    if dtype.is_complex:
        a = a + 1j * rng.standard_normal(shape)
    return torch.from_numpy(a).to(dtype)


def _banded(rng, n, offsets, dtype, ncols=None):
    """A DIAMatrix on the CPU with random diagonals at ``offsets``, zeros
    where a diagonal leaves the matrix."""
    from lis_tpu_torch.matrix.dia import DIAMatrix
    ncols = n if ncols is None else ncols
    val = _randn(rng, (len(offsets), n), dtype)
    cols = torch.arange(n)[None, :] + torch.tensor(offsets)[:, None]
    val = val * ((cols >= 0) & (cols < ncols))
    return DIAMatrix.from_diagonals(val, offsets, (n, ncols),
                                    nnz=int(torch.count_nonzero(val)))


def _tol(dtype):
    return 1e-13 if dtype in (torch.float64, torch.complex128) else 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("vdtype,xdtype", [(d, d) for d in ALL_DTYPES] + [
    (torch.float32, torch.complex64), (torch.float64, torch.complex128),
    (torch.complex128, torch.float64), (torch.float32, torch.float64)],
    ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("n,offsets", [
    (1, (0,)), (33, (-32, -1, 0, 1, 32)), (1001, (-1000, -501, -3, 0, 7, 600)),
    (70001, tuple(range(-13, 14))), (4099, tuple(range(-256, 256)))],
    ids=lambda v: str(v) if isinstance(v, int) else f"nnd{len(v)}")
def test_dia_spmv_and_spmvh(cuda, vdtype, xdtype, n, offsets):
    """E and F against their plain versions: odd n, one diagonal, 512
    diagonals, offsets beyond n/2 and up to n − 1, every dtype pair the
    kernels take directly and two that cast the diagonals."""
    from lis_tpu_torch.matrix import dia
    rng = np.random.default_rng(n)
    A = _banded(rng, n, offsets, vdtype)
    x = _randn(rng, n, xdtype)
    Ac, xc = A.to(cuda), x.to(cuda)
    tol = max(_tol(vdtype), _tol(xdtype))
    for fn, name in ((dia.dia_spmv, "matvec"), (dia.dia_spmvh, "matvech")):
        want = getattr(A, name)(x)
        before = fn.launches
        got = getattr(Ac, name)(xc)
        assert fn.launches == before + 1
        assert got.dtype == want.dtype and got.is_cuda
        torch.testing.assert_close(got.cpu(), want, rtol=tol,
                                   atol=tol * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=lambda d: str(d)[6:])
def test_dia_rectangular(cuda, dtype):
    """A rectangular DIA: E guards against ncols, matvech takes the plain
    scatter on the card."""
    rng = np.random.default_rng(5)
    for n, m in ((300, 517), (517, 300)):
        A = _banded(rng, n, (-250, -2, 0, 1, 40, 299), dtype, ncols=m)
        x, y = _randn(rng, m, dtype), _randn(rng, n, dtype)
        Ac = A.to(cuda)
        tol = _tol(dtype)
        torch.testing.assert_close(Ac.matvec(x.to(cuda)).cpu(), A.matvec(x),
                                   rtol=tol, atol=tol * 10)
        torch.testing.assert_close(Ac.matvech(y.to(cuda)).cpu(),
                                   A.matvech(y), rtol=tol, atol=tol * 10)


def _cg_case(rng, n, dtype, device, nrm1=False, zero_pq=False):
    """A KrylovScalars and vectors as CG has them in mid-solve."""
    from lis_tpu_torch.core import vector as v
    r, p, x, dinv = (_randn(rng, n, dtype).to(device) for _ in range(4))
    q = torch.zeros_like(p) if zero_pq else _randn(rng, n, dtype).to(device)
    one = torch.ones((), dtype=dtype, device=device)
    ws = v.KrylovScalars(r, 50, 1e-10, one * 0.25, one * 3.0, nrm1=nrm1,
                         running=-99, breakdown=2)
    rh = torch.full((52,), float("nan"), dtype=dtype, device=device)
    return ws, rh, x, r, p, q, dinv


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("n", [1, 255, 70001, 300007])
@pytest.mark.parametrize("mode", ["jacobi", "none", "z", "nrm1", "breakdown"])
def test_fused_cg_step(cuda, dtype, n, mode):
    """One fused CG step, kernels G on the card against their plain
    versions on the CPU, from equal inputs: sums to rtol 1e-12 / 1e-5,
    then x, r and p to a few ulp (the scalars differ by the summation
    order), the loop scalars, and the breakdown freeze."""
    from lis_tpu_torch.core import vector as v
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    out = {}
    for device in ("cpu", cuda):
        rng = np.random.default_rng(n)
        ws, rh, x, r, p, q, dinv = _cg_case(
            rng, n, dtype, device, nrm1=mode == "nrm1",
            zero_pq=mode == "breakdown")
        x0, r0 = x.clone(), r.clone()
        fns = (v.krylov_dot, v.cg_direction, v.cg_update, v.cg_finish)
        before = [f.launches for f in fns]
        folded = mode != "z"
        d = dinv if mode in ("jacobi", "nrm1", "breakdown") else None
        z = None if folded else dinv * r
        if d is not None:
            v.krylov_dot(r, d, r, ws, v.P_RHO)
        else:
            v.krylov_dot(r, r if z is None else z, None, ws, v.P_RHO)
        v.cg_direction(p, r, z, d, ws)
        if mode != "breakdown":
            q = q + p                       # a q that depends on the new p
        v.krylov_dot(p, q, None, ws, v.P_PQ)
        v.cg_update(x, r, p, q, d, ws, next_rho=folded)
        v.cg_finish(ws, rh)
        counts = [f.launches - b for f, b in zip(fns, before)]
        assert counts == ([0] * 4 if device == "cpu" else [2, 1, 1, 1])
        if mode == "breakdown":
            assert torch.equal(x, x0) and torch.equal(r, r0)
            assert int(ws.flag) == 2 and int(ws.live) == 0
            assert float(ws.nrm) == 3.0
        else:
            assert int(ws.flag) == -99 and int(ws.live) == 1
        assert int(ws.it) == 2
        # a step after the loop has ended changes nothing
        if mode == "breakdown":
            xs = x.clone()
            v.cg_update(x, r, p, q + 1, d, ws, next_rho=folded)
            v.cg_finish(ws, rh)
            assert torch.equal(x, xs) and int(ws.it) == 2
        out[str(device)] = [t.cpu() for t in (
            x, r, p, ws.sc[:4], ws.part.sum(1), rh[1:2])]
    for got, want in zip(out[str(cuda)], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=rtol,
                                   atol=rtol * float(want.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("opts", [
    "-i cg -p jacobi -tol 1e-10", "-i cg -p none -tol 1e-10",
    "-i cg -p jacobi -tol 1e-6 -f single", "-i cg -p jacobi -scale 2",
    "-i cg -p jacobi -conv_cond nrm1_b -tol_w 1e-10 -tol 0",
    "-i bicg -p jacobi -tol 1e-10", "-i cr -p jacobi -tol 1e-10"])
def test_default_routed_solve_on_the_card(cuda, opts):
    """solve() with no -storage: a banded CSR input on the card is routed
    to DIA and iterated through kernel E (bicg: F too) and, for cg, the
    fused step; iteration counts are the CPU plain path's ±1."""
    from lis_tpu_torch.core import vector as v
    from lis_tpu_torch.matrix import dia
    from lis_tpu_torch.solvers.driver import transform_operator
    from lis_tpu_torch.utils.testmat import poisson3d27
    A = poisson3d27(17, 19, 23)
    assert A.device.type == "cuda"
    A_cpu = poisson3d27(17, 19, 23, device="cpu")
    b = np.random.default_rng(9).standard_normal(A.nrows)
    want = lis_tpu_torch.solve(A_cpu, b, options=opts)
    fns = (dia.dia_spmv, dia.dia_spmvh, v.krylov_dot, v.cg_direction,
           v.cg_update, v.cg_finish)
    before = [f.launches for f in fns]
    got = lis_tpu_torch.solve(A, b, options=opts)
    e, f, g1, g2, g3, g4 = (fn.launches - b0 for fn, b0 in zip(fns, before))
    assert transform_operator(A, got.options).format_name == "dia" \
        or "-scale" in opts
    assert got.x.is_cuda and got.status == want.status == 0
    assert abs(got.iters - want.iters) <= 1
    single = "-f single" in opts
    torch.testing.assert_close(got.x.cpu(), want.x,
                               rtol=1e-3 if single else 1e-7,
                               atol=1e-4 if single else 1e-9)
    if "-i cg" in opts:
        # one E per iteration and one for the initial residual (the true
        # residual is taken on the CSR input)
        assert e == got.iters + 1
        assert (g1, g2, g3, g4) == (got.iters + 1,) + (got.iters,) * 3
    elif "-i bicg" in opts:
        assert e >= got.iters and f >= got.iters and g2 == 0
    else:
        assert e >= got.iters and g2 == 0


@pytest.mark.gpu
def test_fused_cg_with_a_general_preconditioner_and_other_operators(cuda):
    """The fused step takes z from any M.psolve, and serves CSR and HDI
    operators as well as DIA."""
    import dataclasses
    from lis_tpu_torch.core import vector as v
    from lis_tpu_torch.matrix.base import TensorFields
    from lis_tpu_torch.utils.testmat import poisson2d

    @dataclasses.dataclass(frozen=True, eq=False)
    class Scaled(TensorFields):
        w: torch.Tensor

        def psolve(self, r):
            return self.w * r

    A_cpu = poisson2d(40, 31, device="cpu")
    b = np.random.default_rng(1).standard_normal(A_cpu.nrows)
    w = torch.from_numpy(np.random.default_rng(2).uniform(0.2, 0.3,
                                                          A_cpu.nrows))
    for storage in ("-auto_storage false", "-storage hdi", "-storage dia"):
        opts = f"-i cg -tol 1e-10 {storage}"
        want = lis_tpu_torch.solve(A_cpu, b, options=opts, M=Scaled(w))
        before = v.krylov_dot.launches
        got = lis_tpu_torch.solve(A_cpu.to(cuda), b, options=opts,
                                  M=Scaled(w.to(cuda)))
        assert v.krylov_dot.launches == before + 2 * got.iters
        assert got.status == want.status == 0
        assert abs(got.iters - want.iters) <= 1
        torch.testing.assert_close(got.x.cpu(), want.x, rtol=1e-7, atol=1e-9)


def test_dia_and_fused_wrappers_take_the_plain_version_on_the_cpu():
    """CPU tensors count no launch."""
    from lis_tpu_torch.core import vector as v
    from lis_tpu_torch.matrix import dia
    fns = (dia.dia_spmv, dia.dia_spmvh, v.krylov_dot, v.cg_direction,
           v.cg_update, v.cg_finish)
    before = [f.launches for f in fns]
    A = _banded(np.random.default_rng(0), 50, (-3, 0, 2), torch.float64)
    A = A.to("cpu")
    x = torch.ones(50, dtype=torch.float64)
    A.matvec(x), A.matvech(x)
    ws, rh, x, r, p, q, dinv = _cg_case(np.random.default_rng(0), 50,
                                        torch.float64, "cpu")
    v.krylov_dot(r, dinv, r, ws, v.P_RHO)
    v.cg_direction(p, r, None, dinv, ws)
    v.krylov_dot(p, q, None, ws, v.P_PQ)
    v.cg_update(x, r, p, q, dinv, ws, next_rho=True)
    v.cg_finish(ws, rh)
    assert [f.launches for f in fns] == before


# ---- kernels H and I (relaxed sweeps) and K (level-scheduled solve) ---------

_SWEEPS = [dict(y=True, s=True, w=True, rs=True), dict(y=True),
           dict(start=True, w=True, rs=True), dict(start=True), dict(),
           dict(w=True), dict(y=True, s=True)]


@pytest.mark.gpu
@pytest.mark.parametrize("vdtype,xdtype", [(d, d) for d in ALL_DTYPES] + [
    (torch.float32, torch.complex64), (torch.float64, torch.complex128)],
    ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("n,offsets", [
    (1, (0,)), (33, (-32, -1, 1, 32)), (1001, (-1000, -501, -3, 7, 600)),
    (70001, tuple(range(-13, 0))), (4099, tuple(range(-256, 256)))],
    ids=lambda v: str(v) if isinstance(v, int) else f"nnd{len(v)}")
def test_dia_relax_and_relaxh(cuda, vdtype, xdtype, n, offsets):
    """H and I against their plain versions for every term mode, with and
    without each scale: odd n, offsets beyond n/2, 512 diagonals; real data
    bit for bit (every product and sum rounded on its own, in offset
    order)."""
    from lis_tpu_torch.matrix import dia
    rng = np.random.default_rng(n)
    T = _banded(rng, n, offsets, vdtype)
    Tc = T.to(cuda)
    vecs = {k: _randn(rng, n, xdtype) for k in ("rhs", "y")}
    vecs.update({k: _randn(rng, n, vdtype) for k in ("s", "w", "rs")})
    for fn in (dia.dia_relax, dia.dia_relaxh):
        for case in _SWEEPS:
            kw = {k: vecs[k] for k in ("y", "s", "w", "rs") if case.get(k)}
            kw["start"] = case.get("start", False)
            want = fn(T, vecs["rhs"], **kw)
            before = fn.launches
            got = fn(Tc, vecs["rhs"].to(cuda),
                     **{k: (t.to(cuda) if isinstance(t, torch.Tensor) else t)
                        for k, t in kw.items()})
            assert fn.launches == before + 1
            assert got.dtype == want.dtype and got.is_cuda
            if not xdtype.is_complex:
                assert torch.equal(got.cpu(), want)
            tol = _tol(xdtype)
            torch.testing.assert_close(got.cpu(), want, rtol=tol,
                                       atol=tol * float(want.abs().max()))


_NP_OF = {torch.float64: np.float64, torch.float32: np.float32,
          torch.complex128: np.complex128, torch.complex64: np.complex64}


def _k_against_plain(cuda, plan, b, rs=None, tol=None):
    """One launch of K against the plain version of the same plan on the
    CPU; NaN and Inf must sit where the plain version has them."""
    from lis_tpu_torch.ops import trisolve as ts
    want = ts._trisolve_plain(plan, b, rs)
    before = ts.trisolve.launches
    got = ts.trisolve(plan.to(cuda), b.to(cuda),
                      None if rs is None else rs.to(cuda))
    torch.cuda.synchronize()
    assert ts.trisolve.launches == before + 1
    tol = _tol(want.dtype) if tol is None else tol
    fin = want[torch.isfinite(want)]
    scale = float(fin.abs().max()) if fin.numel() else 1.0
    torch.testing.assert_close(got.cpu(), want, rtol=tol, atol=tol * scale,
                               equal_nan=True)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.complex128, torch.complex64],
                         ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("shape", [(17, 19, 23), (31, 1, 1), (40, 40, 9)],
                         ids=lambda s: "x".join(map(str, s)))
def test_trisolve_levels(cuda, dtype, lower, shape):
    """K against its plain version and scipy: plans of poisson3d27 on odd
    grids (one level per row on a line; levels of many units), every
    dtype, a real plan with a complex right-hand side."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve_triangular
    from lis_tpu_torch.ops import trisolve as ts
    from lis_tpu_torch.utils.testmat import poisson3d27
    p, i, val = poisson3d27(*shape, device="cpu").to_csr_arrays()
    n = len(p) - 1
    a = sp.csr_matrix((val, i, p), shape=(n, n))
    tri = (sp.tril(a, -1) if lower else sp.triu(a, 1)).tocsr()
    tri.sort_indices()
    rng = np.random.default_rng(n)
    vals = tri.data * rng.uniform(0.5, 1.5, tri.nnz)
    d = a.diagonal() + (1j if dtype.is_complex else 0)
    npt = _NP_OF[dtype]
    plan = ts.make_plan(tri.indptr, tri.indices, vals.astype(npt),
                        (1.0 / d).astype(npt), lower=lower, device="cpu")
    b = _randn(rng, n, dtype)
    got = _k_against_plain(cuda, plan, b)
    if dtype == torch.float64:
        full = (sp.csr_matrix((vals, tri.indices, tri.indptr), shape=(n, n))
                + sp.diags(d)).tocsr()
        ref = spsolve_triangular(full, b.numpy(), lower=lower)
        np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())
        bz = _randn(rng, n, torch.complex128)
        _k_against_plain(cuda, plan, bz)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("which", ["lower", "upper", "lower_t", "upper_t"])
def test_trisolve_levels_long_rows(cuda, dtype, which):
    """K on the ILU(1) factors of poisson3d27: rows longer than one chunk
    of 16 entries."""
    from lis_tpu_torch.precon.ilu import create_iluk
    from lis_tpu_torch.runtime.options import SolverOptions
    from lis_tpu_torch.utils.testmat import poisson3d27
    A = poisson3d27(11, 10, 9, device="cpu")
    M = create_iluk(A, SolverOptions.from_string("-ilu_fill 1"))
    plan = getattr(M, which).to(dtype=dtype)
    width = (plan.sbase[1:] - plan.sbase[:-1]) // 32
    assert int(width.max()) > 16
    b = _randn(np.random.default_rng(1), A.nrows, dtype)
    _k_against_plain(cuda, plan, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["one_level", "level_per_row", "nan_inf"])
def test_trisolve_levels_edge_plans(cuda, case):
    """K on a plan of one level (no triangle), on a plan of one level per
    row (a bidiagonal of 5000 rows), and with NaN and Inf in b: the same
    result as the plain version, NaN where it has NaN, and no hang."""
    import scipy.sparse as sp
    from lis_tpu_torch.ops import trisolve as ts
    rng = np.random.default_rng(3)
    n = 5000
    if case == "one_level":
        tri = sp.csr_matrix((n, n))
    else:
        tri = sp.diags(rng.uniform(-1, 1, n - 1), -1, shape=(n, n)).tocsr()
    if case == "nan_inf":
        tri = (tri + sp.diags(rng.uniform(-1, 1, n - 7), -7)).tocsr()
    tri.sort_indices()
    plan = ts.make_plan(tri.indptr, tri.indices, tri.data,
                        rng.uniform(0.5, 1.5, n), device="cpu")
    assert plan.nlev == {"one_level": 1, "level_per_row": n}.get(
        case, plan.nlev)
    b = _randn(rng, n, torch.float64)
    if case == "nan_inf":
        b[[10, 2000]] = float("nan")
        b[[500, 4000]] = float("inf")
        b[3000] = -float("inf")
    got = _k_against_plain(cuda, plan, b)
    if case == "nan_inf":
        assert got.isnan().any() and torch.isfinite(got[:10]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.complex128],
                         ids=lambda d: str(d)[6:])
def test_trisolve_rs_fold(cuda, dtype):
    """trisolve(plan, b, rs) on the card against the plain version of
    b·rs: SSOR's backward solve with its y·(D/ω) folded in."""
    import scipy.sparse as sp
    from lis_tpu_torch.ops import trisolve as ts
    from lis_tpu_torch.utils.testmat import poisson3d27
    p, i, val = poisson3d27(17, 19, 23, device="cpu").to_csr_arrays()
    n = len(p) - 1
    a = sp.csr_matrix((val, i, p), shape=(n, n))
    tri = sp.triu(a, 1).tocsr()
    tri.sort_indices()
    npt = _NP_OF[torch.float32 if dtype == torch.float32 else torch.float64]
    plan = ts.make_plan(tri.indptr, tri.indices, tri.data.astype(npt),
                        (1.0 / a.diagonal()).astype(npt), lower=False,
                        device="cpu")
    rng = np.random.default_rng(4)
    rs = _randn(rng, n, plan.sdinv.dtype)
    _k_against_plain(cuda, plan, _randn(rng, n, dtype), rs)


def test_trisolve_kernel_has_no_grid_barrier():
    """K's source launches no cooperative kernel and has no grid-wide
    barrier: rows wait on per-row ready flags, polled with a time limit
    (read from the source, so this runs without a card)."""
    import pathlib
    src = (pathlib.Path(lis_tpu_torch.__file__).parent / "csrc"
           / "trisolve.cu").read_text()
    code = "\n".join(ln.split("//")[0] for ln in src.splitlines())
    for banned in ("cudaLaunchCooperativeKernel", "grid_sync",
                   "this_grid", "cooperative_groups"):
        assert banned not in code
    assert "ld.relaxed.gpu" in code and "st.relaxed.gpu" in code
    assert "%%globaltimer" in code and "__trap()" in code


@pytest.mark.gpu
def test_trisolve_broken_plan_traps(cuda, tmp_path):
    """A plan whose two rows of one unit wait on each other makes K trap
    after its spin limit instead of hanging: the synchronize after the
    launch raises.  Run in a child process, since a trap leaves that
    process's CUDA context unusable."""
    import os
    import pathlib
    import subprocess
    import sys
    import textwrap
    script = tmp_path / "broken.py"
    script.write_text(textwrap.dedent("""
        import dataclasses
        import numpy as np, torch
        from lis_tpu_torch.ops import trisolve as ts
        n = 64
        plan = ts.make_plan(np.zeros(n + 1, np.int32), np.zeros(0, np.int32),
                            np.zeros(0), np.ones(n), device="cuda")
        # rows 0 and 1, lanes 0 and 1 of unit 0, each read the other
        cols = torch.full((32,), n, dtype=torch.int32)
        cols[:2] = torch.tensor([1, 0])
        plan = dataclasses.replace(
            plan, sbase=torch.tensor([0, 32, 32], dtype=torch.int32).cuda(),
            scols=cols.cuda(), svals=torch.ones(32, dtype=torch.float64).cuda())
        ts.trisolve(plan, torch.ones(n, dtype=torch.float64, device="cuda"))
        try:
            torch.cuda.synchronize()
        except RuntimeError as e:
            print("TRAPPED", str(e).splitlines()[0])
            raise SystemExit(0)
        print("NO TRAP")
        raise SystemExit(1)
    """))
    root = str(pathlib.Path(lis_tpu_torch.__file__).parent.parent)
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=120, cwd=root,
                       env={**os.environ, "PYTHONPATH": root})
    assert r.returncode == 0 and "TRAPPED" in r.stdout, r.stdout + r.stderr


@pytest.mark.gpu
def test_trisolve_levels_on_two_streams(cuda):
    """K solves enqueued on two streams at once: each launch has its own
    ready flags and claim counter, so every solve agrees with the plain
    version."""
    import scipy.sparse as sp
    from lis_tpu_torch.ops import trisolve as ts
    from lis_tpu_torch.utils.testmat import poisson3d27
    p, i, val = poisson3d27(40, 40, 9, device="cpu").to_csr_arrays()
    n = len(p) - 1
    a = sp.csr_matrix((val, i, p), shape=(n, n))
    tri = sp.tril(a, -1).tocsr()
    tri.sort_indices()
    plan = ts.make_plan(tri.indptr, tri.indices, tri.data,
                        1.0 / a.diagonal(), device="cpu")
    rng = np.random.default_rng(2)
    bs = [_randn(rng, n, torch.float64) for _ in range(2)]
    want = [ts.trisolve(plan, b) for b in bs]
    pc, bc = plan.to(cuda), [b.to(cuda) for b in bs]
    streams = [torch.cuda.Stream() for _ in bs]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(8):
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[k].append(ts.trisolve(pc, bc[k]))
    torch.cuda.synchronize()
    for k in range(2):
        for g in got[k]:
            torch.testing.assert_close(g.cpu(), want[k], rtol=1e-12,
                                       atol=1e-12 * float(want[k].abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("opts,kernel", [
    ("-i cg -p ssor -adds true", "dia_relax"), ("-i cg -p ilu", "dia_relax"),
    ("-i bicg -p ssor", "dia_relaxh"), ("-i gs", "dia_relax"),
    ("-i cg -p ssor -auto_storage false", "trisolve"),
    ("-i sor -tol 1e-8", "trisolve"),
    ("-i gmres -restart 30 -p ssor", "dia_relax")])
def test_preconditioned_solve_on_the_card(cuda, opts, kernel):
    """The hpcg slice on the card: SSOR, ILU(0), ADDS, GS/SOR and GMRES
    through kernels H, I and K, with the CPU plain path's iterations ±1."""
    from lis_tpu_torch.matrix import dia
    from lis_tpu_torch.ops import trisolve as ts
    from lis_tpu_torch.utils.testmat import poisson3d27
    A = poisson3d27(17, 19, 23)
    A_cpu = poisson3d27(17, 19, 23, device="cpu")
    b = np.random.default_rng(9).standard_normal(A.nrows)
    want = lis_tpu_torch.solve(A_cpu, b, options=opts)
    fn = {"dia_relax": dia.dia_relax, "dia_relaxh": dia.dia_relaxh,
          "trisolve": ts.trisolve}[kernel]
    before = fn.launches
    got = lis_tpu_torch.solve(A, b, options=opts)
    assert got.x.is_cuda and got.status == want.status == 0
    assert abs(got.iters - want.iters) <= 1
    assert fn.launches - before >= got.iters
    torch.testing.assert_close(got.x.cpu(), want.x, rtol=1e-7, atol=1e-9)


@pytest.mark.gpu
def test_hpcg_default_on_the_card(cuda, capsys):
    """python -m lis_tpu_torch.cli.hpcg with its defaults runs on the card
    through kernel H, with the CPU run's iteration count ±1."""
    from lis_tpu_torch.cli import hpcg
    from lis_tpu_torch.matrix import dia
    from lis_tpu_torch.ops import trisolve as ts
    assert hpcg.main(["24", "20", "18"], device="cpu") == 0
    cpu = capsys.readouterr().out
    before = (dia.dia_relax.launches, ts.trisolve.launches)
    assert hpcg.main(["24", "20", "18"]) == 0
    card = capsys.readouterr().out

    def iters(out):
        return int(next(ln for ln in out.splitlines()
                        if "number of iterations" in ln).split("=")[1])
    assert abs(iters(card) - iters(cpu)) <= 1
    assert dia.dia_relax.launches - before[0] >= 9 * iters(card)
    assert ts.trisolve.launches == before[1]


def test_sweep_and_trisolve_wrappers_take_the_plain_version_on_the_cpu():
    """CPU tensors count no launch of H, I or K."""
    from lis_tpu_torch.matrix import dia
    from lis_tpu_torch.ops import trisolve as ts
    fns = (dia.dia_relax, dia.dia_relaxh, ts.trisolve)
    before = [f.launches for f in fns]
    T = _banded(np.random.default_rng(0), 50, (-3, -1), torch.float64)
    x = torch.ones(50, dtype=torch.float64)
    dia.dia_relax(T, x, x, w=x)
    dia.dia_relaxh(T, x, start=True)
    plan = ts.make_plan(np.arange(51, dtype=np.int32) * 0, np.zeros(0, int),
                        np.zeros(0), np.ones(50), device="cpu")
    torch.testing.assert_close(ts.trisolve(plan, x), x)
    assert [f.launches for f in fns] == before


# ---- the router's other branches on the card: CSS, HDI, CSR ----------------

def _windowed(n=1 << 15, w=2000):
    """6 random columns per row within ±w of the diagonal, nonsymmetric,
    diagonally dominant: the router's CSS case."""
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(n), 6)
    cols = np.clip(rows + rng.integers(-w, w, n * 6), 0, n - 1)
    a = sp.coo_matrix((rng.standard_normal(n * 6), (rows, cols)),
                      shape=(n, n)).tocsr()
    return (a + sp.eye(n) * 30).tocsr()


def _quasi_banded(n=400, stragglers=30):
    """A tridiagonal matrix plus a few entries off the band (HDI)."""
    rng = np.random.default_rng(0)
    a = sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(n, n)).tolil()
    for _ in range(stragglers):
        i, j = rng.integers(0, n, 2)
        a[i, j] = rng.standard_normal()
    return a.tocsr()


def _power_law(n=3000, seed=0, cplx=False):
    """Hub columns attract most entries: CSS spills them to its CSR
    remainder, and the router leaves the matrix as it is."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 6)
    cols = np.minimum((rng.pareto(1.2, n * 6) * 40).astype(np.int64), n - 1)
    vals = rng.standard_normal(n * 6)
    if cplx:
        vals = vals + 1j * rng.standard_normal(n * 6)
    a = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    a = (a + sp.eye(n) * 8).tocsr()
    a.sum_duplicates()
    return a


ROUTED = {"windowed": (_windowed, "css"), "quasi_banded": (_quasi_banded,
                                                           "hdi"),
          "power_law": (_power_law, "csr")}


@pytest.mark.gpu
@pytest.mark.parametrize("solver", ["bicgstab", "bicg"])
@pytest.mark.parametrize("name", list(ROUTED))
def test_routed_css_hdi_csr_on_the_card(cuda, name, solver):
    """A CSR input on the card through the router's branches after DIA:
    the routed operator's matvec and matvech against scipy, and a solve
    against the same solve on the CPU."""
    from lis_tpu_torch.solvers.driver import transform_operator
    make, route = ROUTED[name]
    a = make()
    a.sort_indices()
    csr = (a.indptr, a.indices, a.data, a.shape)
    A = lis_tpu_torch.CSRMatrix.from_csr_arrays(*csr)
    A_cpu = lis_tpu_torch.CSRMatrix.from_csr_arrays(*csr, device="cpu")
    n = a.shape[0]
    b = np.random.default_rng(7).standard_normal(n)
    opts = f"-i {solver} -p jacobi -tol 1e-10"
    want = lis_tpu_torch.solve(A_cpu, b, options=opts)
    got = lis_tpu_torch.solve(A, b, options=opts)
    T = transform_operator(A, got.options)
    assert T.format_name == route and T.device.type == "cuda"
    x = np.random.default_rng(8).standard_normal(n)
    xc = torch.from_numpy(x).to(cuda)
    np.testing.assert_allclose(T.matvec(xc).cpu().numpy(), a @ x,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(T.matvech(xc).cpu().numpy(), a.T @ x,
                               rtol=1e-12, atol=1e-12)
    assert got.x.is_cuda and got.status == want.status == 0
    assert abs(got.iters - want.iters) <= 1
    torch.testing.assert_close(got.x.cpu(), want.x, rtol=1e-7, atol=1e-9)


CSS_ON_CARD = {
    "windowed": lambda: _windowed(1 << 13, 500),
    "power_law": _power_law,
    "power_law_complex": lambda: _power_law(seed=5, cplx=True),
    "rectangular": lambda: sp.random(700, 1000, density=0.01, format="csr",
                                     random_state=np.random.default_rng(6)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("transpose", [True, False], ids=["at", "scatter"])
@pytest.mark.parametrize("name", list(CSS_ON_CARD))
def test_css_on_the_card(cuda, name, transpose):
    """CSSMatrix on the card against its CPU copy and scipy: matvec,
    matvech through the transpose and by the scatter fallback, the
    diagonal, row and symmetric scaling, a complex vector on real values
    (the int32 ``rowf`` feeds index_add_ and index_select there)."""
    from lis_tpu_torch.matrix.css import CSSMatrix
    a = CSS_ON_CARD[name]().tocsr()
    a.sort_indices()
    S = CSSMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape,
                                  transpose=transpose)
    assert S.device.type == "cuda" and (S.at is not None) == transpose
    assert S.rem is not None and S.rem.device.type == "cuda"
    S_cpu = S.to("cpu")
    n, m = a.shape
    rng = np.random.default_rng(3)
    x, y = rng.standard_normal(m), rng.standard_normal(n)
    z = x + 1j * rng.standard_normal(m)

    def close(got, want):
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-12,
                                   atol=1e-12 * max(np.abs(want).max(), 1))

    def dev(v):
        return torch.from_numpy(v).to(cuda)

    close(S.matvec(dev(x)), a @ x)
    close(S.matvec(dev(z)), a @ z)
    close(S.matvech(dev(y)), a.conj().T @ y)
    close(S.matvec(dev(x)), S_cpu.matvec(torch.from_numpy(x)).numpy())
    if n == m:
        close(S.get_diagonal(), a.diagonal())
        d = rng.uniform(0.5, 2.0, n)
        R, Y = S.scale_rows(dev(d)), S.scale_symm(dev(d))
        close(R.matvec(dev(x)), d * (a @ x))
        close(R.matvech(dev(y)), a.conj().T @ (d * y))
        close(Y.matvec(dev(x)), d * (a @ (d * x)))
        close(Y.matvech(dev(y)), d * (a.conj().T @ (d * y)))


def _krylov_pair(kind):
    """poisson3d27 17 x 19 x 23 as CSR on the card and on the CPU ("spd"),
    or its nonsymmetric variant (lower diagonals times 0.7, upper ones
    times 1.3, 28 on the diagonal: chip_smoke.py's phase 10 system)."""
    from lis_tpu_torch.utils.testmat import poisson3d27
    ptr, idx, val = poisson3d27(17, 19, 23, device="cpu").to_csr_arrays()
    n = len(ptr) - 1
    a = sp.csr_matrix((val, idx, ptr), shape=(n, n))
    if kind == "nonsym":
        c = a.tocoo()
        scale = np.where(c.col < c.row, 0.7,
                         np.where(c.col > c.row, 1.3, 28 / 26))
        a = sp.csr_matrix((c.data * scale, (c.row, c.col)), shape=(n, n))
    a.sort_indices()
    args = (a.indptr, a.indices, a.data, a.shape)
    return (lis_tpu_torch.CSRMatrix.from_csr_arrays(*args),
            lis_tpu_torch.CSRMatrix.from_csr_arrays(*args, device="cpu"))


KRYLOV_OPTS = [f"-i {s} -p jacobi -tol 1e-10" for s in (
    "cgs", "crs", "tfqmr", "orthomin", "gpbicg", "gpbicr", "bicgsafe",
    "bicrsafe", "bicgstabl", "idrs", "idr1", "minres")] + [
    "-i bicgstabl -p ssor -tol 1e-10", "-i idrs -irestart 4 -p ssor -tol 1e-10"]


@pytest.mark.gpu
@pytest.mark.parametrize("opts", KRYLOV_OPTS)
def test_krylov_solver_on_the_card(cuda, opts):
    """The Krylov slice's solvers on a small routed DIA on the card
    against the same solve on the CPU: equal count and status, x to 1e-9,
    and E, F and H launched exactly as often as the solver's matvecs, Aᴴ
    products and SSOR sweeps (``chip_smoke.krylov_counts``; the true
    residual is taken on the CSR input)."""
    from chip_smoke import krylov_counts
    from lis_tpu_torch.matrix import dia
    from lis_tpu_torch.runtime.options import SolverOptions
    o = SolverOptions.from_string(opts)
    A, A_cpu = _krylov_pair("spd" if o.solver in ("minres", "orthomin")
                            else "nonsym")
    b = np.random.default_rng(9).standard_normal(A.nrows)
    want = lis_tpu_torch.solve(A_cpu, b, options=opts)
    fns = (dia.dia_spmv, dia.dia_spmvh, dia.dia_relax, dia.dia_relaxh)
    before = [f.launches for f in fns]
    got = lis_tpu_torch.solve(A, b, options=opts)
    e, f, h, i = (fn.launches - b0 for fn, b0 in zip(fns, before))
    assert got.x.is_cuda and got.status == want.status == 0
    assert got.iters == want.iters
    torch.testing.assert_close(got.x.cpu(), want.x, rtol=1e-9,
                               atol=1e-9 * float(want.x.abs().max()))
    mv, mvh, ps = krylov_counts(o.solver, got.iters, ell=o.ell,
                                s=o.irestart)
    assert (e, f, h, i) == (mv, mvh, 4 * ps if o.precon == "ssor" else 0, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("opts", ["-i bicgstabl -p jacobi -storage cst",
                                  "-i idrs -irestart 4 -p jacobi -storage cst"])
def test_krylov_solver_over_cst_on_the_card(cuda, opts):
    """BiCGSTAB(l) and IDR(s) over a CST on the card: the CPU's count ±1
    (the CSR remainder sums with atomics), a true residual at the
    tolerance, and kernel A launched once per matvec."""
    from chip_smoke import krylov_counts
    from lis_tpu_torch.runtime.options import SolverOptions
    n = 1 << 15
    a = _system(n, 5, "nonsym")
    Tc = CSTMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape,
                                   transpose=False)
    b = np.random.default_rng(3).standard_normal(n)
    opts += " -tol 1e-10"
    want = lis_tpu_torch.solve(Tc.to("cpu"), b, options=opts)
    before = cst_front.launches
    got = lis_tpu_torch.solve(Tc, b, options=opts)
    assert got.x.is_cuda and got.status == want.status == 0
    assert abs(got.iters - want.iters) <= 1
    x = got.x.cpu().numpy()
    assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) <= 1e-9
    o = SolverOptions.from_string(opts)
    mv, _, _ = krylov_counts(o.solver, got.iters, ell=o.ell, s=o.irestart)
    assert cst_front.launches - before == mv + 1


# ---- kernels J and L (SA-AMG's lattice transfers) ---------------------------

def _lattice_level(dims, dtype, seed=0):
    """The transfer of a random nonsymmetric stencil on the lattice
    ``dims`` (3^d points), its smoothed prolongator assembled as on the
    solve path, on the CPU in the real type of ``dtype``."""
    import scipy.sparse as sp
    from lis_tpu_torch.ops.amg import LatticeTransfer
    from lis_tpu_torch.precon.saamg import lattice_prolongator
    rng = np.random.default_rng(seed)
    n = int(np.prod(dims))
    coords = np.unravel_index(np.arange(n), dims)
    rows, cols, vals = [], [], []
    for digits in np.ndindex(*(3,) * len(dims)):
        nb = [c + d - 1 for c, d in zip(coords, digits)]
        ok = np.all([(x >= 0) & (x < f) for x, f in zip(nb, dims)], axis=0)
        rows.append(np.arange(n)[ok])
        cols.append(np.ravel_multi_index([x[ok] for x in nb], dims))
        vals.append(rng.uniform(-1, 1, ok.sum())
                    + (3.0 ** len(dims) if digits == (1,) * len(dims)
                       else 0.0))
    a = sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                              np.concatenate(cols))),
                      shape=(n, n))
    a.sort_indices()
    rdt = torch.float32 if dtype in (torch.float32, torch.complex64) \
        else torch.float64
    P = lattice_prolongator(a, tuple(dims))[0]
    return LatticeTransfer.from_scipy(P, "cpu").to(dtype=rdt)


def _jl_against_plain(cuda, T, dtype, poison=False, seed=0):
    """J and L on the card against their plain versions on the card (bit
    for bit) and on the CPU (rtol 1e-13 / 1e-5)."""
    from lis_tpu_torch.ops import amg
    rng = np.random.default_rng(seed + 1)
    ec, x, r = (_randn(rng, k, dtype) for k in (T.nc, T.n, T.n))
    if poison:
        ec[[0, T.nc // 2]] = float("nan")
        x[T.n // 3] = float("inf")
        r[[1, T.n - 2]] = float("nan")
        r[T.n // 2] = -float("inf")
    Tc = T.to(cuda)
    before = (amg.lattice_prolong.launches, amg.lattice_restrict.launches)
    got_j = amg.lattice_prolong(Tc, ec.to(cuda), x.to(cuda))
    got_l = amg.lattice_restrict(Tc, r.to(cuda))
    torch.cuda.synchronize()
    assert (amg.lattice_prolong.launches, amg.lattice_restrict.launches) \
        == (before[0] + 1, before[1] + 1)
    on_card = (amg._prolong_plain(Tc, ec.to(cuda), x.to(cuda)),
               amg._restrict_plain(Tc, r.to(cuda)))
    on_cpu = (amg._prolong_plain(T, ec, x), amg._restrict_plain(T, r))
    tol = 1e-5 if dtype in (torch.float32, torch.complex64) else 1e-13
    for got, card, cpu in zip((got_j, got_l), on_card, on_cpu):
        torch.testing.assert_close(got, card, rtol=0, atol=0,
                                   equal_nan=True)
        torch.testing.assert_close(got.cpu(), cpu, rtol=tol, atol=tol,
                                   equal_nan=True)
    return got_j, got_l


LATTICE_DIMS = [(12, 12, 12), (13, 14, 16), (31, 29, 40), (40, 31), (64, 3),
                (100,), (3, 4, 5), (7, 1, 9)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("dims", LATTICE_DIMS,
                         ids=lambda d: "x".join(map(str, d)))
def test_lattice_prolong_and_restrict(cuda, dims, dtype):
    """J and L on 1-D, 2-D and 3-D lattices, with cropped edge boxes
    (dims not divisible by 3) and dims of 1; real and complex vectors."""
    _jl_against_plain(cuda, _lattice_level(dims, dtype), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_lattice_prolong_and_restrict_nan_inf(cuda, dtype):
    """NaN and Inf in ec, x and r: the same pattern as the plain version,
    and a NaN in ec[0] reaches only the rows that hold column 0 (no padded
    slot multiplies by zero)."""
    from lis_tpu_torch.ops import amg
    T = _lattice_level((13, 11, 10), dtype)
    got_j, got_l = _jl_against_plain(cuda, T, dtype, poison=True)
    assert got_j.isnan().any() and got_l.isnan().any()
    assert torch.isfinite(got_l).any()
    ec = torch.ones(T.nc, dtype=dtype)
    ec[0] = float("nan")
    got = amg.lattice_prolong(T.to(cuda), ec.to(cuda),
                              torch.zeros(T.n, dtype=dtype, device=cuda))
    touch = torch.zeros(T.n, dtype=torch.bool)        # P's rows holding 0
    touch[T.rcol[T.rptr[0]:T.rptr[1]].long()] = True
    assert torch.equal(got.isnan().cpu(), touch)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=lambda d: str(d)[6:])
def test_lattice_transfer_full_stage_long_rows(cuda, dtype):
    """A P whose rows all hold the most entries J stages (8 a row, 256 a
    warp: a full stage) and Pᵀ rows of about 600 entries, far past a
    lattice's 125 (L takes many rounds): both still equal their plain
    versions bit for bit."""
    import scipy.sparse as sp
    from lis_tpu_torch.ops.amg import MAX_ROW, LatticeTransfer
    rng = np.random.default_rng(7)
    n, nc, k = 3000, 40, MAX_ROW
    cols = np.stack([rng.choice(nc, k, replace=False) for _ in range(n)])
    P = sp.csr_matrix((rng.standard_normal(n * k),
                       (np.repeat(np.arange(n), k), cols.ravel())),
                      shape=(n, nc))
    rdt = torch.float32 if dtype in (torch.float32, torch.complex64) \
        else torch.float64
    T = LatticeTransfer.from_scipy(P, "cpu").to(dtype=rdt)
    _jl_against_plain(cuda, T, dtype, seed=3)


@pytest.mark.gpu
def test_lattice_kernels_on_two_streams(cuda):
    """J and L enqueued on two streams at once agree with their plain
    versions."""
    from lis_tpu_torch.ops import amg
    Tc = _lattice_level((31, 29, 40), torch.float64).to(cuda)
    rng = np.random.default_rng(4)
    ins = [(_randn(rng, Tc.nc, torch.float64).to(cuda),
            _randn(rng, Tc.n, torch.float64).to(cuda)) for _ in range(2)]
    want = [(amg._prolong_plain(Tc, ec, x), amg._restrict_plain(Tc, x))
            for ec, x in ins]
    streams = [torch.cuda.Stream() for _ in ins]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(8):
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                ec, x = ins[k]
                got[k].append((amg.lattice_prolong(Tc, ec, x),
                               amg.lattice_restrict(Tc, x)))
    torch.cuda.synchronize()
    for k in range(2):
        for gj, gl in got[k]:
            assert torch.equal(gj, want[k][0]) and torch.equal(gl, want[k][1])


@pytest.mark.gpu
@pytest.mark.parametrize("opts", [
    "-i cg -p saamg", "-i cg -p saamg -saamg_smoother jacobi",
    "-i cg -p saamg -saamg_lattice false", "-i bicgstab -p ilut",
    "-i bicgstab -p iluc -iluc_drop 0.01 -auto_storage false",
    "-i cg -p sainv",
    "-i bicgstab -p is", "-i cg -p bjacobi", "-i gmres -p hybrid"])
def test_remaining_preconditioners_on_the_card(cuda, opts):
    """The preconditioners of the last slice on a small routed operator on
    the card against the same solve on the CPU: equal status, the count
    ±1, x to 1e-8; the lattice SA-AMG launches J and L.  ILUC runs at
    -iluc_drop 0.01: at 0.05 it drops every off-diagonal entry of this
    operator, and BiCGSTAB with the Jacobi-like result moves its count by
    3 under a 1e-14 change of b (poisson3d27 64³ on the CPU,
    lis_tpu_torch/tools/count_spread.py), so the CSR's atomic sums on the
    card move it as far."""
    from lis_tpu_torch.ops import amg
    from lis_tpu_torch.utils.testmat import poisson3d27
    A = poisson3d27(20, 21, 22)
    A_cpu = A.to("cpu")
    b = np.random.default_rng(5).standard_normal(A.nrows)
    opts += " -tol 1e-10"
    want = lis_tpu_torch.solve(A_cpu, b, options=opts)
    before = amg.lattice_prolong.launches
    got = lis_tpu_torch.solve(A, b, options=opts)
    assert got.x.is_cuda and got.status == want.status == 0
    assert abs(got.iters - want.iters) <= 1
    torch.testing.assert_close(got.x.cpu(), want.x, rtol=1e-8,
                               atol=1e-8 * float(want.x.abs().max()))
    if "saamg" in opts and "lattice false" not in opts:
        assert amg.lattice_prolong.launches > before


# ---- kernels M-P: the double-double path (csrc/dd.cu) ----------------------
# Each against its plain version on the card, bit for bit (NaN where the
# plain version has NaN): f64 pairs and f32 pairs ("df"), odd lengths, the
# grid reduction (above 2^15 padded terms), and a NaN in x[0].

from lis_tpu_torch.core import ddreal as dq  # noqa: E402


def _dd_vec(rng, n, dtype, dev, nan=False):
    eps = torch.finfo(dtype).eps
    hi = rng.standard_normal(n)
    hi[::97] = 0.0
    lo = hi * rng.uniform(-0.5, 0.5, n) * eps
    hi, lo = (torch.from_numpy(a).to(dtype).to(dev) for a in (hi, lo))
    if nan:
        hi[0] = float("nan")
    return dq.DD(hi, lo)


def _dd_same(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("n", [1, 7, 1001, 32768, (1 << 17) + 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dd_reduce_and_update(cuda, dtype, n, nan):
    rng = np.random.default_rng(n)
    x = _dd_vec(rng, n, dtype, cuda, nan)
    y = _dd_vec(rng, n, dtype, cuda)
    a = dq.DD(*(t.reshape(()) for t in _dd_vec(rng, 1, dtype, cuda)))
    for mode in range(4):
        before = dq.dd_reduce.launches
        got = dq.dd_reduce(mode, x, y if mode == 1 else None)
        assert dq.dd_reduce.launches == before + 1
        _dd_same(got, dq._reduce_plain(mode, x, y if mode == 1 else None))
    for mode in range(8):          # axpy xpay scal add sub mul div sqrt
        alpha = None if mode >= 3 else a
        other = None if mode in (2, 7) else y
        xin = dq._mul(x, x) if mode == 7 else x
        got = dq.dd_update(mode, alpha, xin, other)
        _dd_same(got, dq._update_plain(mode, alpha, xin, other))
    # the scalar algebra: 0-d pairs
    b = dq.DD(*(t.reshape(()) for t in _dd_vec(rng, 1, dtype, cuda)))
    for fn, plain in ((dq.add, dq._add), (dq.sub, dq._sub), (dq.mul, dq._mul),
                      (dq.div, dq._div)):
        _dd_same(fn(a, b), plain(a, b))
    _dd_same(dq.sqrt(dq._mul(a, a)), dq._sqrt(dq._mul(a, a)))


def _dd_dia(rng, n, offs, dev):
    vals = rng.standard_normal((len(offs), n))
    for k, o in enumerate(offs):            # zeros outside the matrix
        lo, hi = max(0, -o), min(n, n - o)
        vals[k, :lo] = 0.0
        vals[k, hi:] = 0.0
    return lis_tpu_torch.DIAMatrix.from_diagonals(
        torch.from_numpy(vals), offs, (n, n), int((vals != 0).sum()),
        device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("limb", [None, torch.float32])
@pytest.mark.parametrize("n", [5, 1001, 40000])
def test_dd_dia_spmv(cuda, n, limb, nan):
    rng = np.random.default_rng(n)
    D = _dd_dia(rng, n, (-33, -7, -1, 0, 2, 9, 40), cuda)
    op = dq.make_dd_operator(D, limb)
    x = _dd_vec(rng, n, limb or torch.float64, cuda, nan)
    for trans in (False, True):
        got = dq.dd_dia_spmv(op, x, trans)
        _dd_same(got, dq._dia_plain(op.value, op.offsets, x, op.value_lo,
                                    trans))


@pytest.mark.gpu
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("limb", [None, torch.float32])
@pytest.mark.parametrize("n", [7, 1001, 40000])
def test_dd_ell_spmv(cuda, n, limb, nan):
    rng = np.random.default_rng(n)
    a = sp.random(n, n, density=min(1.0, 9.0 / n), random_state=n,
                  format="csr") + sp.eye(n) * 4
    a = a.tocsr()
    a.sort_indices()
    A = lis_tpu_torch.CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data,
                                                a.shape, device=cuda)
    op = dq.make_dd_operator(A, limb)
    x = _dd_vec(rng, n, limb or torch.float64, cuda, nan)
    for idx, val, vlo in ((op.index, op.value, op.value_lo),
                          (op.index_t, op.value_t, op.value_t_lo)):
        got = dq.dd_ell_spmv(idx, val, x, vlo)
        _dd_same(got, dq._ell_plain(idx, val, x, vlo))


@pytest.mark.gpu
@pytest.mark.parametrize("limb", [None, torch.float32])
@pytest.mark.parametrize("w", [129, 300, 1000])
def test_dd_ell_spmv_long_rows(cuda, w, limb):
    """Rows past 128 entries: kernel N's shared-memory path (odd and even
    level counts), and the short rows of the same matrix beside them."""
    rng = np.random.default_rng(w)
    n = 2000
    a = sp.lil_matrix(sp.random(n, n, density=4.0 / n, random_state=w))
    for r, cnt in ((0, w), (7, w - 1), (n - 1, w // 2 + 1)):
        a[r, rng.choice(n, cnt, replace=False)] = rng.standard_normal(cnt)
    a = (a.tocsr() + sp.eye(n) * 4).tocsr()
    a.sort_indices()
    A = lis_tpu_torch.CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data,
                                                a.shape, device=cuda)
    op = dq.make_dd_operator(A, limb)
    assert op.value.shape[1] >= w
    x = _dd_vec(rng, n, limb or torch.float64, cuda)
    _dd_same(dq.dd_ell_spmv(op.index, op.value, x, op.value_lo),
             dq._ell_plain(op.index, op.value, x, op.value_lo))


# Kernel O's schedules (``_reduce_plan``): one block up to 2^15 padded
# terms, then grids of 32 to 128 blocks; 884,736 is 96^3, 2^23 192^3.
@pytest.mark.gpu
@pytest.mark.parametrize("nan", [False, True])
@pytest.mark.parametrize("n", [2, 1000, 1 << 15, (1 << 15) + 1, 1 << 16,
                               (1 << 17) + 5, 1 << 19, 884736, 1 << 20,
                               1 << 23])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dd_reduce_plans(cuda, dtype, n, nan):
    rng = np.random.default_rng(n)
    x = _dd_vec(rng, n, dtype, cuda, nan)
    y = _dd_vec(rng, n, dtype, cuda)
    for mode in range(4):
        other = y if mode == 1 else None
        before = dq.dd_reduce.launches
        got = dq.dd_reduce(mode, x, other)
        assert dq.dd_reduce.launches == before + 1
        _dd_same(got, dq._reduce_plain(mode, x, other))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_dd_reduce_grids(cuda, dtype):
    """Grids the C entry accepts beyond the plan's, bit-equal."""
    rng = np.random.default_rng(11)
    n = (1 << 20) - 3
    x = _dd_vec(rng, n, dtype, cuda, nan=False)
    y = _dd_vec(rng, n, dtype, cuda)
    want = dq._reduce_plain(1, x, y)
    for G, R in ((4, 1), (4, 4), (32, 8), (64, 8), (128, 16), (128, 128)):
        _dd_same(dq._reduce_launch(1, x, y, (G, R)), want)


@pytest.mark.gpu
def test_dd_reduce_on_two_streams(cuda):
    """O enqueued on two streams at once: each call's partials live in its
    own scratch and its grid meets at its own barriers, so every result
    agrees with the plain version."""
    rng = np.random.default_rng(3)
    xs = [_dd_vec(rng, 884736, torch.float64, cuda) for _ in range(2)]
    want = [dq._reduce_plain(2, x) for x in xs]
    streams = [torch.cuda.Stream() for _ in xs]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(16):
        for k, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[k].append(dq.dd_reduce(2, xs[k]))
    torch.cuda.synchronize()
    for k in range(2):
        for g in got[k]:
            _dd_same(g, want[k])


# ---- kernels S: cg_quad's fused step (csrc/dd_cg.cu) -----------------------
# Each pass against its plain version on the card, bit for bit, from equal
# inputs; then whole solves of the fused step against the plain step.

def _ddcg_case(rng, n, dtype, dev, mode, resident=None):
    from lis_tpu_torch.core import ddcg
    r = _dd_vec(rng, n, dtype, dev)
    rho = dq.DD(*(t.reshape(()) for t in _dd_vec(rng, 1, dtype, dev)))
    ws = ddcg.DDCGScalars(r, 50, 1e-30, 0.25, 3.0, rho,
                          nrm1=mode == "nrm1", running=-99, breakdown=2,
                          resident=resident)
    vecs = dict(x=_dd_vec(rng, n, dtype, dev), r=r,
                p=_dd_vec(rng, n, dtype, dev), q=_dd_vec(rng, n, dtype, dev))
    for v in vecs.values():
        v.hi[0] += 1.0          # _dd_vec's zero at 0 would be a breakdown at n = 1
    if mode == "breakdown":
        vecs["q"] = dq.zeros_like(vecs["q"])
    dinv = None
    if mode != "none":
        dinv = torch.from_numpy(rng.uniform(0.02, 0.05, n)).to(dtype).to(dev)
    rh = torch.full((52,), float("nan"), dtype=torch.float64, device=dev)
    return ws, vecs, dinv, rh


def _ddcg_state(ws, vecs, rh):
    return [ws.dd, ws.f, ws.ic, rh] + [t for v in vecs.values() for t in v]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["jacobi", "none", "nrm1", "breakdown"])
@pytest.mark.parametrize("n", [1, 1001, 1 << 15, (1 << 15) + 1,
                               (1 << 20) + 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ddcg_passes(cuda, dtype, n, mode):
    """S1, S2 and S3, one launch each, bit-equal to their plain versions
    (the plain step's own functions on the card's tensors); a breakdown
    keeps x and r; a pass after the loop has ended changes nothing."""
    from lis_tpu_torch.core import ddcg
    fns = (ddcg.ddcg_direction, ddcg.ddcg_pq, ddcg.ddcg_update)
    plains = (ddcg._direction_plain, ddcg._pq_plain, ddcg._update_plain)
    out = []
    for run in (fns, plains):
        ws, v, dinv, rh = _ddcg_case(np.random.default_rng(n), n, dtype,
                                     cuda, mode)
        x0, r0 = [t.clone() for t in v["x"]], [t.clone() for t in v["r"]]
        before = [f.launches for f in fns]
        run[0](v["p"], v["r"], dinv, ws)
        run[1](v["p"], v["q"], ws)
        run[2](v["x"], v["r"], v["p"], v["q"], dinv, ws, rh)
        got = [f.launches - b for f, b in zip(fns, before)]
        assert got == ([1, 1, 1] if run is fns else [0, 0, 0])
        if mode == "breakdown":
            assert all(torch.equal(a, b) for a, b in zip(v["x"], x0))
            assert all(torch.equal(a, b) for a, b in zip(v["r"], r0))
            assert int(ws.flag) == 2 and int(ws.live) == 0
            assert float(ws.nrm) == 3.0
        else:
            assert int(ws.flag) == -99 and int(ws.live) == 1
        assert int(ws.it) == 2
        out.append([t.clone() for t in _ddcg_state(ws, v, rh)])
        # once live is 0 every pass returns at once
        ws.ic[2] = 0
        run[0](v["p"], v["r"], dinv, ws)
        run[1](v["p"], v["q"], ws)
        run[2](v["x"], v["r"], v["p"], v["q"], dinv, ws, rh)
        ws.ic[2] = out[-1][2][2]
        for a, b in zip(_ddcg_state(ws, v, rh), out[-1]):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("resident, plan", [
    (None, None), (114, (64, 8)), (57, (32, 8)), (7, (4, 2)), (3, (0, 0))])
@pytest.mark.parametrize("dtype", DTYPES)
def test_ddcg_grid_capped(cuda, dtype, resident, plan):
    """S2 and S3 planned against fewer resident blocks than this card
    holds (114: an H100 PCIe's SMs at one S3 block each; 57, 7, 3: slices
    of a card) launch and stay bit-equal to their plain versions; the
    default plan fits the card's own count."""
    from lis_tpu_torch.core import ddcg
    n = (1 << 20) + 3
    out = []
    for run in ((ddcg.ddcg_direction, ddcg.ddcg_pq, ddcg.ddcg_update),
                (ddcg._direction_plain, ddcg._pq_plain, ddcg._update_plain)):
        ws, v, dinv, rh = _ddcg_case(np.random.default_rng(n), n, dtype,
                                     cuda, "jacobi", resident)
        if plan is None:
            G, R = ws.plan
            assert 0 < G <= ddcg.resident_blocks(dtype, cuda)
        else:
            assert ws.plan == plan
        run[0](v["p"], v["r"], dinv, ws)
        run[1](v["p"], v["q"], ws)
        run[2](v["x"], v["r"], v["p"], v["q"], dinv, ws, rh)
        out.append(_ddcg_state(ws, v, rh))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _ddcg_solve(dev, dims, limb, zero):
    """A 27-point DIA operator (or the zero operator: p·q = 0 at the first
    step) and a right-hand side, as DD operands on ``dev``."""
    from lis_tpu_torch.utils.testmat import poisson3d27_dia
    A = poisson3d27_dia(*dims, device=dev)
    n = A.nrows
    if zero:
        A = lis_tpu_torch.DIAMatrix.from_diagonals(
            torch.zeros((1, n), dtype=torch.float64), (0,), (n, n), 0,
            device=dev)
    b = torch.from_numpy(np.random.default_rng(n).standard_normal(n)).to(dev)
    if limb == torch.float32:
        b = dq.DD(b.float(), (b - b.float().double()).float())
    return dq.make_dd_operator(A, limb), b, n


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["converged", "maxiter", "breakdown",
                                  "nrm1"])
@pytest.mark.parametrize("precon", ["jacobi", "none"])
@pytest.mark.parametrize("dims", [(7, 9, 11), (33, 33, 33)],
                         ids=["693", "35937"])
@pytest.mark.parametrize("limb", DTYPES, ids=["df", "quad"])
def test_cg_quad_fused_equals_the_plain_step_on_the_card(cuda, limb, dims,
                                                          precon, case):
    """The fused cg_quad against the plain step, both on the card: x, the
    residual history, the count, the status and the residual bit for bit,
    in f32 and f64 limbs, on an odd n and an n past O's one-block reach
    (2^15), converged, at maxiter, under nrm1_b and on a breakdown; and at
    most 6 launches an iteration, the matvec included (4: S1, M, S2, S3)."""
    from lis_tpu_torch.core import ddcg
    from lis_tpu_torch.precon.base import NonePrecon
    from lis_tpu_torch.precon.jacobi import JacobiPrecon
    from lis_tpu_torch.solvers import quad as Q
    from lis_tpu_torch.solvers.base import SolverSpec
    D, b, n = _ddcg_solve(cuda, dims, limb, case == "breakdown")
    x0 = torch.zeros(n, dtype=limb, device=cuda)
    dinv = None
    if precon == "jacobi":
        dinv = torch.from_numpy(np.random.default_rng(7).uniform(
            0.02, 0.05, n)).to(limb).to(cuda)
    tol = 1e-20 if limb == torch.float64 else 1e-11
    kw = {"maxiter": dict(tol=1e-30, maxiter=30),
          "nrm1": dict(tol=0.0, tol_w=tol, conv_cond=2)}.get(case,
                                                              dict(tol=tol))
    spec = SolverSpec(solver="cg_quad", **{"maxiter": 1000, **kw})
    fns = (ddcg.ddcg_direction, ddcg.ddcg_pq, ddcg.ddcg_update,
           dq.dd_dia_spmv)
    before = [f.launches for f in fns]
    r, bi, te, n0 = Q._init_dd(D, b, x0, spec)
    fused = Q.cg_quad_fused(D, x0, spec, r, bi, te, n0, dinv)
    got = [f.launches - c for f, c in zip(fns, before)]
    M = NonePrecon() if dinv is None else JacobiPrecon(dinv=dinv)
    r, bi, te, n0 = Q._init_dd(D, b, x0, spec)
    plain = Q.cg_quad_plain(D, b, x0, M, spec, r, bi, te, n0)
    for k in ("x", "rhistory", "iters", "status", "resid"):
        torch.testing.assert_close(getattr(fused, k), getattr(plain, k),
                                   rtol=0, atol=0, equal_nan=True)
    status = {"maxiter": 4, "breakdown": 2}.get(case, 0)
    assert int(fused.status) == status
    its = int(fused.iters)
    # one matvec before the loop (the initial residual), one a step
    assert got == [its, its, its, its + 1]
    assert (sum(got) - 1) / its <= 6


def _ell_width(rng, n, w, dev):
    """A CSR matrix whose longest row has w entries (row lengths 0 to w,
    so Aᵀ has other widths)."""
    lens = rng.integers(0, w + 1, n)
    lens[n // 2] = w
    ptr = np.concatenate([[0], np.cumsum(lens)])
    idx = np.concatenate([np.sort(rng.choice(n, k, replace=False))
                          for k in lens])
    val = rng.standard_normal(len(idx))
    return lis_tpu_torch.CSRMatrix.from_csr_arrays(ptr, idx, val, (n, n),
                                                   device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("limb", [None, torch.float32])
@pytest.mark.parametrize("w", [1, 2, 3, 31, 32, 33, 34, 63, 64, 65, 127,
                               128, 129])
def test_dd_ell_spmv_widths(cuda, w, limb):
    """N at every width class, A and Aᵀ, n = 4001 (prime: no plan's rows
    a block divides it), through the plan and, up to 128 entries, through
    both the staged and the warp-per-row kernel; one count a call."""
    rng = np.random.default_rng(w)
    n = 4001
    op = dq.make_dd_operator(_ell_width(rng, n, w, cuda), limb)
    assert op.value.shape[1] == w
    x = _dd_vec(rng, n, limb or torch.float64, cuda, nan=w == 33)
    for idx, val, vlo in ((op.index, op.value, op.value_lo),
                          (op.index_t, op.value_t, op.value_t_lo)):
        want = dq._ell_plain(idx, val, x, vlo)
        before = dq.dd_ell_spmv.launches
        _dd_same(dq.dd_ell_spmv(idx, val, x, vlo), want)
        assert dq.dd_ell_spmv.launches == before + 1
        wt = val.shape[1]
        if wt <= 128:       # the staged kernel's reach, and a warp a row
            _dd_same(dq._ell_launch(idx, val, x, vlo, dq._ell_rows(
                wt, x.hi.element_size())), want)
            _dd_same(dq._ell_launch(idx, val, x, vlo, 0), want)


SCALAR_FORMATS = ["coo", "csc", "msr", "ell", "jad", "dns"]


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", SCALAR_FORMATS)
def test_storage_cg_jacobi_on_the_card(cuda, fmt):
    """CG + Jacobi over each scalar format on the card: the torch
    matvec of the format, the fused step (G once an iteration, no E), the
    CPU's count ±1 and the card's -storage csr count ±1 (the scatters sum
    with atomics)."""
    from lis_tpu_torch.core import vector as v
    from lis_tpu_torch.matrix import dia
    from lis_tpu_torch.utils.testmat import poisson2d
    A_cpu = poisson2d(40, 31, device="cpu")
    A = A_cpu.to(cuda)
    b = np.random.default_rng(11).standard_normal(A.nrows)
    opts = f"-i cg -p jacobi -tol 1e-10 -storage {fmt}"
    want = lis_tpu_torch.solve(A_cpu, b, options=opts)
    fns = (dia.dia_spmv, v.krylov_dot, v.cg_direction, v.cg_update,
           v.cg_finish)
    before = [f.launches for f in fns]
    got = lis_tpu_torch.solve(A, b, options=opts)
    e, g1, g2, g3, g4 = (f.launches - b0 for f, b0 in zip(fns, before))
    csr = lis_tpu_torch.solve(A, b, options=opts.replace(fmt, "csr"))
    assert got.x.is_cuda and got.status == want.status == 0
    assert abs(got.iters - want.iters) <= 1
    assert abs(got.iters - csr.iters) <= 1
    assert got.true_resid <= 1e-9
    torch.testing.assert_close(got.x.cpu(), want.x, rtol=1e-7, atol=1e-9)
    assert e == 0
    assert (g1, g2, g3, g4) == (got.iters + 1,) + (got.iters,) * 3


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["coo", "jad", "msr"])
def test_storage_quad_count_on_the_card(cuda, fmt):
    """BiCGSTAB -f quad over a scalar format: the ELL pair of the same
    canonical CSR, so kernel N (twice an iteration and once for the
    initial residual) gives the -storage csr solve's iterates bit for bit
    and the CPU's count exactly."""
    from lis_tpu_torch.core import ddreal as dq
    from lis_tpu_torch.utils.testmat import poisson2d
    A_cpu = poisson2d(40, 31, device="cpu")
    A = A_cpu.to(cuda)
    b = np.random.default_rng(12).standard_normal(A.nrows)
    opts = f"-i bicgstab -f quad -tol 1e-12 -storage {fmt}"
    want = lis_tpu_torch.solve(A_cpu, b, options=opts)
    before = dq.dd_ell_spmv.launches
    got = lis_tpu_torch.solve(A, b, options=opts)
    launches = dq.dd_ell_spmv.launches - before
    csr = lis_tpu_torch.solve(A, b, options=opts.replace(fmt, "csr"))
    assert got.status == want.status == 0
    assert got.iters == want.iters == csr.iters
    assert launches == 2 * got.iters + 1
    assert torch.equal(got.x, csr.x)


# ---- the eigensolvers on a card DIA ----------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("opts", ["-e ii -i cg -etol 1e-8",
                                  "-e ii -i cg -ef quad -etol 1e-8",
                                  "-e li -ss 2 -etol 1e-8",
                                  "-e gii -etol 1e-8"])
def test_esolve_on_a_card_dia(cuda, opts):
    """esolve / gesolve on poisson3d27 16³ built in DIA on the card: the
    inner solves run kernels E and G (CG), M-P (-ef quad) or E and F
    (BiCG), and the status, counts, eigenvalues and pair residuals are
    those of the same eigensolve on the CPU, which runs the kernels' plain
    versions (eigenvalues to 1e-10 relative, residuals to 1e-3).

    ``-e li -ss 2`` ends MAXITER on the CPU and in lis_tpu alike: its
    second Ritz pair (31.205) is refined by 50 fixed-shift inverse
    iterations in a dense part of the spectrum and stops at a residual of
    5.76e-6, above 10·etol; the first pair reaches 1.7e-9."""
    from lis_tpu_torch.core import ddreal as dq, vector as v
    from lis_tpu_torch.matrix import dia
    from lis_tpu_torch.utils.testmat import poisson3d27_dia
    A = poisson3d27_dia(16, 16, 16)
    A_cpu = A.to("cpu")
    B = B_cpu = None
    if "gii" in opts:
        d = torch.linspace(1.0, 2.0, A.nrows, dtype=torch.float64)[None, :]
        B = dia.DIAMatrix.from_diagonals(d, (0,), A.shape, A.nrows,
                                         device=cuda)
        B_cpu = B.to("cpu")
    want = lis_tpu_torch.gesolve(A_cpu, B_cpu, options=opts)
    fns = (dia.dia_spmv, dia.dia_spmvh, v.krylov_dot, dq.dd_dia_spmv)
    before = [f.launches for f in fns]
    got = lis_tpu_torch.gesolve(A, B, options=opts)
    e, f, g1, m = (fn.launches - b0 for fn, b0 in zip(fns, before))
    assert got.evector.is_cuda
    assert got.status == want.status == (4 if "-ss 2" in opts else 0)
    assert list(got.iters_all) == list(want.iters_all)
    np.testing.assert_allclose(got.evalues, want.evalues, rtol=1e-10)
    np.testing.assert_allclose(got.resids_all, want.resids_all, rtol=1e-3)
    if "quad" in opts:
        assert m > got.iters
    elif "-i cg" in opts:
        assert e > got.iters and g1 > got.iters and f == 0
    else:
        assert e > 0 and f > 0


def _bes_case(shape, seed):
    """(slab, c0, s, nrows, ncols) of a random BES: dense, square (s = R)
    or strided (a rectangular prolongator, s < R), with rows past nrows;
    or sparse like a routed windowed matrix (5 % of the slots, in a band
    about the diagonal), with an all-zero tile, an empty row and an empty
    window column, at W = 256 (8-bit offsets), 512 (16-bit), 4096 (x's
    window in passes at complex128) and 8192 (in passes at f64)."""
    rng = np.random.default_rng(seed)
    if shape == "square":
        nrows = ncols = 5000
        s, W, c0 = 128, 384, -100
    elif shape == "strided":
        nrows, ncols = 6001, 700
        s, W, c0 = 15, 45, -10
    else:
        W = {"sparse": 256, "w512": 512, "w4096": 4096, "w8192": 8192}[shape]
        nrows = 5000 if W <= 512 else 1000
        s, c0 = 128, -(W - 128) // 2
        ncols = nrows + W
    T = -(-nrows // 128)
    slab = rng.standard_normal((T, W, 128))
    if shape not in ("square", "strided"):
        w, r = np.arange(W)[:, None], np.arange(128)[None, :]
        band = np.abs(c0 + w - r) <= min(W // 2, 200)
        keep = band & (rng.random((T, W, 128)) < 0.05 * W * 128 / band.sum())
        slab = np.where(keep, slab, 0.0)
        slab[1] = 0                             # an all-zero tile
        slab[2, :, 7] = 0                       # an empty row
        slab[0, W // 2, :] = 0                  # an empty window column
    return torch.from_numpy(slab), c0, s, nrows, ncols


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,xdtype", [
    (torch.float32, torch.float32), (torch.float64, torch.float64),
    (torch.complex128, torch.complex128), (torch.float64, torch.complex128),
    (torch.complex64, torch.complex64)],
    ids=["f32", "f64", "c128", "f64-x-c128", "c64"])
@pytest.mark.parametrize("shape", ["square", "strided", "sparse", "w512",
                                   "w4096", "w8192"])
def test_bes_kernels_match_their_plain_versions(cuda, dtype, xdtype, shape):
    """Kernels Q (bes_spmv) and R (bes_spmvh), over the slab's compact
    form derived on the card, against their plain versions over the dense
    slab to rtol 1e-13 (f64, complex128) / 1e-5 (f32); a complex x on a
    real slab keeps its imaginary part; one launch counted per call."""
    from lis_tpu_torch.matrix import bes
    slab, c0, s, nrows, ncols = _bes_case(shape, 3)
    if dtype.is_complex:
        slab = torch.complex(slab, slab.flip(0)).to(dtype)
    else:
        slab = slab.to(dtype)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(2 * ncols))
    y = torch.from_numpy(rng.standard_normal(2 * nrows))
    if xdtype.is_complex:
        x, y = torch.complex(x[:ncols], x[ncols:]), \
            torch.complex(y[:nrows], y[nrows:])
    else:
        x, y = x[:ncols], y[:nrows]
    x, y = x.to(xdtype), y.to(xdtype)
    rtol = 1e-5 if torch.float32 in (dtype, xdtype) or \
        torch.complex64 in (dtype, xdtype) else 1e-13
    sc = slab.to(cuda)
    pack = bes.bes_pack(sc)
    assert pack.qoff.dtype == (torch.uint8 if slab.shape[1] <= 256
                               else torch.int16)
    for fn, v, plain in ((bes.bes_spmv, x, bes._spmv_plain),
                         (bes.bes_spmvh, y, bes._spmvh_plain)):
        before = fn.launches
        got = fn(sc, pack, v.to(cuda), c0, s, nrows, ncols)
        assert fn.launches == before + 1
        want = plain(slab, v, c0, s, nrows, ncols)
        oracle = plain(sc, v.to(cuda), c0, s, nrows, ncols)
        assert fn.launches == before + 1
        assert got.dtype == want.dtype == torch.promote_types(dtype, xdtype)
        for w in (want, oracle.cpu()):
            err = (got.cpu() - w).abs().max().item()
            assert err <= rtol * w.abs().max().item(), err


@pytest.mark.gpu
def test_bes_on_the_card_needs_its_compact_form(cuda):
    """No fallback: a BES on the card reads its compact form, and one
    without it, with one of another shape or type, or with one left on
    the CPU raises rather than streaming the slab."""
    import dataclasses
    from lis_tpu_torch.matrix import bes
    rng = np.random.default_rng(5)
    n = 3000
    rows = np.repeat(np.arange(n), 6)
    cols = np.clip(rows + rng.integers(-40, 40, 6 * n), 0, n - 1)
    a = (sp.coo_matrix((rng.standard_normal(6 * n), (rows, cols)),
                       shape=(n, n)) + 30 * sp.eye(n)).tocsr()
    B = bes.BESMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape)
    assert B.slab.is_cuda and B.pack.qval.is_cuda
    x = torch.from_numpy(rng.standard_normal(n)).to(cuda)
    want = torch.from_numpy(a @ x.cpu().numpy())
    assert (B.matvec(x).cpu() - want).abs().max() <= 1e-13 * want.abs().max()
    for pack in (None, bes.bes_pack(B.slab[:-1]),
                 bes.bes_pack(B.slab.to(torch.float32)),
                 B.pack.to("cpu")):
        bad = dataclasses.replace(B, pack=pack)
        q0, r0 = bes.bes_spmv.launches, bes.bes_spmvh.launches
        for meth in ("matvec", "matvech"):
            with pytest.raises(ValueError, match="compact form"):
                getattr(bad, meth)(x)
        assert (bes.bes_spmv.launches, bes.bes_spmvh.launches) == (q0, r0)


@pytest.mark.gpu
@pytest.mark.parametrize("opts", ["-i cg -p jacobi", "-i bicg -p jacobi",
                                  "-i bicgstab -p jacobi -f df",
                                  "-i cg -p jacobi -f quad"])
def test_bes_route_on_the_card(cuda, opts):
    """A windowed matrix routes to BES on the card as on the CPU; the solve
    launches Q (and R for bicg) and matches the CPU's count ±1, x to
    1e-8; -f quad takes the ELL pair (N), -f df the slab path (Q)."""
    from lis_tpu_torch.core import ddreal as dq
    from lis_tpu_torch.matrix import bes
    from lis_tpu_torch.solvers.driver import transform_operator
    from lis_tpu_torch.runtime.options import SolverOptions
    n = 1 << 15
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(n), 6)
    cols = np.clip(rows + rng.integers(-40, 40, 6 * n), 0, n - 1)
    a = sp.coo_matrix((rng.standard_normal(6 * n), (rows, cols)),
                      shape=(n, n)).tocsr()
    a = (a + a.T + 30 * sp.eye(n)).tocsr()
    a.sort_indices()
    args = (a.indptr, a.indices, a.data, a.shape)
    A = lis_tpu_torch.CSRMatrix.from_csr_arrays(*args)
    A_cpu = lis_tpu_torch.CSRMatrix.from_csr_arrays(*args, device="cpu")
    opts += " -tol 1e-10"
    assert transform_operator(A, SolverOptions.from_string(opts)) \
        .format_name == "bes"
    b = np.ones(n)
    want = lis_tpu_torch.solve(A_cpu, b, options=opts)
    q0, r0, n0 = bes.bes_spmv.launches, bes.bes_spmvh.launches, \
        dq.dd_ell_spmv.launches
    got = lis_tpu_torch.solve(A, b, options=opts)
    q, r, nn = (bes.bes_spmv.launches - q0, bes.bes_spmvh.launches - r0,
                dq.dd_ell_spmv.launches - n0)
    assert got.status == want.status == 0
    assert abs(got.iters - want.iters) <= 1
    np.testing.assert_allclose(got.x.cpu().numpy(), want.x.numpy(),
                               rtol=1e-8, atol=1e-8)
    if "quad" in opts:
        assert q == 0 and nn >= got.iters
    else:
        assert q >= got.iters
        assert (r >= got.iters) == ("bicg " in opts + " ")


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["bsr", "bsc", "vbr"])
def test_block_formats_on_the_card(cuda, fmt):
    """The block formats' torch products on the card against the CPU's
    (rtol 1e-13), and block ILU (K twice a psolve) against the CPU's."""
    from lis_tpu_torch.ops import trisolve as tsm
    from lis_tpu_torch.precon.ilu import create_iluk
    from lis_tpu_torch.runtime.options import SolverOptions
    g = 24
    t = sp.diags([-np.ones(g - 1), 2 * np.ones(g), -np.ones(g - 1)],
                 [-1, 0, 1])
    p2 = sp.kron(t, sp.eye(g)) + sp.kron(sp.eye(g), t)
    blk = np.array([[4.0, 1.0, 0.5], [1.0, 3.0, 0.25], [0.5, 0.25, 2.0]])
    a = sp.kron(p2, blk).tocsr()
    a.sort_indices()
    args = (a.indptr, a.indices, a.data, a.shape)
    kw = {} if fmt == "vbr" else {"bnr": 3}
    C = lis_tpu_torch.CSRMatrix.from_csr_arrays(*args, device="cpu")
    M_cpu = lis_tpu_torch.convert_matrix(C, fmt, device="cpu", **kw)
    M = lis_tpu_torch.convert_matrix(C, fmt, device=cuda, **kw)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(a.shape[0]))
    for meth in ("matvec", "matvech"):
        got = getattr(M, meth)(x.to(cuda)).cpu()
        want = getattr(M_cpu, meth)(x)
        assert (got - want).abs().max() <= 1e-13 * want.abs().max()
    if fmt != "bsc":
        opts = SolverOptions.from_string("-ilu_fill 0")
        P, P_cpu = create_iluk(M, opts), create_iluk(M_cpu, opts)
        k0 = tsm.trisolve.launches
        got = P.psolve(x.to(cuda)).cpu()
        assert tsm.trisolve.launches - k0 == 2
        want = P_cpu.psolve(x)
        assert (got - want).abs().max() <= 1e-12 * want.abs().max()


# ---- the lis.h compatibility layer, the scipy bindings and the shim ------

def _scipy_of(A):
    ptr, index, value = A.to_csr_arrays()
    return sp.csr_matrix((value, index, ptr), shape=A.shape)


def _compat_system(T, a):
    """A compat matrix handle assembled from scipy CSR ``a`` by
    lis_matrix_set_csr (on the default device, the card), and b = ones."""
    n = a.shape[0]
    A = T.lis_matrix_create(0)
    T.lis_matrix_set_size(A, 0, n)
    T.lis_matrix_set_csr(a.nnz, a.indptr, a.indices, a.data, A)
    T.lis_matrix_assemble(A)
    b, x = T.lis_vector_create(0), T.lis_vector_create(0)
    T.lis_vector_set_size(b, 0, n)
    T.lis_vector_set_all(1.0, b)
    T.lis_vector_set_size(x, 0, n)
    return A, b, x


@pytest.mark.gpu
def test_compat_test4_flow_on_the_card(cuda):
    """The test4.c flow through lis_tpu_torch.compat on the card: the
    same status, count and x (bit for bit) as lis_tpu_torch.solve on the
    same matrix, E once per iteration plus one, G as the fused step."""
    import lis_tpu_torch.compat as T
    from lis_tpu_torch.core import vector as v
    from lis_tpu_torch.matrix import dia
    from lis_tpu_torch.utils.testmat import poisson3d27
    a = _scipy_of(poisson3d27(16, 16, 16, device="cpu"))
    A, b, x = _compat_system(T, a)
    assert A.m.device.type == "cuda" and b.value.is_cuda
    s = T.lis_solver_create()
    T.lis_solver_set_option("-i cg -p jacobi -tol 1e-10", s)
    fns = (dia.dia_spmv, v.krylov_dot, v.cg_direction, v.cg_update,
           v.cg_finish)
    before = [f.launches for f in fns]
    assert T.lis_solve(A, b, x, s) == T.LIS_SUCCESS
    e, g1, g2, g3, g4 = (f.launches - b0 for f, b0 in zip(fns, before))
    it = T.lis_solver_get_iter(s)
    assert e == it + 1 and (g1, g2, g3, g4) == (it + 1,) + (it,) * 3
    want = lis_tpu_torch.solve(A.m, np.ones(a.shape[0]),
                               options="-i cg -p jacobi -tol 1e-10")
    assert want.iters == it and want.status == T.lis_solver_get_status(s)
    assert torch.equal(x.value, want.x)
    assert T.lis_solver_get_residualnorm(s) <= 1e-10
    assert T.lis_solver_get_time(s) > 0


@pytest.mark.gpu
def test_compat_cst_route_on_the_card(cuda):
    """A locality-free system through the compat layer with -storage
    cst (and -scale 1): kernels A and D at least once per iteration (on
    this n = 2^15 grid B and C and, under -scale 1, #1 did not launch on
    the card; smoke phase 16b holds all five at n = 2^20), no #1 without
    -scale, the CPU's count ±1 and x to 1e-8."""
    import lis_tpu_torch.compat as T
    from lis_tpu_torch.matrix import cst as cstm
    n = 1 << 15
    a = _system(n, 5)
    A, b, x = _compat_system(T, a)
    y = T.lis_vector_duplicate(b)
    kern = (cstm.cst_front, tsh.benes_pass, tsh.benes_pass_rowsum,
            tsh.benes_small_run, tsh.lane_shuffle)
    for extra in ("", " -scale 1"):
        opts = "-i cg -p jacobi -storage cst -tol 1e-10" + extra
        s = T.lis_solver_create()
        T.lis_solver_set_option(opts, s)
        before = [f.launches for f in kern]
        assert T.lis_solve(A, b, x, s) == T.LIS_SUCCESS
        got = [f.launches - b0 for f, b0 in zip(kern, before)]
        it = T.lis_solver_get_iter(s)
        assert got[0] >= it and got[3] >= it
        assert extra or got[4] == 0
        want = lis_tpu_torch.solve(
            lis_tpu_torch.CSRMatrix.from_csr_arrays(
                a.indptr, a.indices, a.data, a.shape, device="cpu"),
            np.ones(n), options=opts)
        assert abs(want.iters - it) <= 1
        torch.testing.assert_close(x.value.cpu(), want.x, rtol=1e-8,
                                   atol=1e-10)
    T.lis_vector_set_all(1.0, x)
    T.lis_matvec(A, x, y)
    torch.testing.assert_close(y.value.cpu(),
                               torch.from_numpy(a @ np.ones(n)),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.gpu
def test_scipy_cg_on_the_card(cuda):
    import lis_tpu_torch.interop as I
    from lis_tpu_torch.utils.testmat import poisson3d27
    a = _scipy_of(poisson3d27(12, 12, 12, device="cpu"))
    b = np.ones(a.shape[0])
    x, info = I.cg(a, b, rtol=1e-10, M="jacobi")
    assert info == 0 and isinstance(x, np.ndarray)
    assert np.linalg.norm(b - a @ x) / np.linalg.norm(b) <= 1e-9


@pytest.mark.gpu
def test_fortran_shim_on_the_card(cuda, tmp_path):
    """test2f through the port's shim, with no device variable: the
    card.  Its count equals the in-process compat run on the card and
    its solution file matches it to 1e-12; with no visible card it
    fails (no CPU fallback)."""
    import os
    import re
    import subprocess
    import lis_tpu_torch.compat as T
    from lis_tpu_torch._native import lisf
    from lis_tpu_torch.io import lis_input_vector
    exes = lisf.build(str(tmp_path), drivers=("test2f",))
    env = {k: v for k, v in os.environ.items()
           if k != "LIS_TPU_TORCH_DEVICE"}
    args = [exes["test2f"], "64", "64", "1", "sol", "rh", "-i", "cg", "-p",
            "jacobi", "-tol", "1e-10"]
    r = subprocess.run(args, cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, (r.stdout, r.stderr)
    it = int(re.search(r"cg: number of iterations = (\d+)", r.stdout)[1])
    m = 64
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(m, m))
    a = sp.kronsum(t, t, format="csr")
    a.sort_indices()
    A, b, x = _compat_system(T, a)
    u = T.lis_vector_duplicate(b)
    T.lis_vector_set_all(1.0, u)
    T.lis_matvec(A, u, b)
    s = T.lis_solver_create()
    T.lis_solver_set_option("-i cg -p jacobi -tol 1e-10", s)
    T.lis_solve(A, b, x, s)
    assert it == T.lis_solver_get_iter(s)
    got = lis_input_vector(str(tmp_path / "sol"), device="cpu")
    torch.testing.assert_close(got, x.value.cpu(), rtol=1e-12, atol=1e-12)
    r = subprocess.run(args, cwd=tmp_path, timeout=300, text=True,
                       env=dict(env, CUDA_VISIBLE_DEVICES=""),
                       capture_output=True)
    assert r.returncode != 0 and "CHKERR" in r.stderr


# ---- kernel F's rectangular form and the distributed layer -------------------

@pytest.mark.gpu
@pytest.mark.parametrize("vdtype,xdtype", [
    (torch.float64, torch.float64), (torch.float32, torch.float32),
    (torch.complex128, torch.complex128), (torch.float64, torch.complex128)],
    ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("n,ncols,offsets", [
    (1003, 1117, tuple(o + 57 for o in (-57, -5, -1, 0, 1, 5, 57))),
    (1003, 700, (-300, -2, 0, 3, 400)), (70001, 70001 + 2 * 13,
                                         tuple(range(0, 27)))],
    ids=["shard", "narrow", "stencil"])
def test_dia_spmvh_rectangular(cuda, vdtype, xdtype, n, ncols, offsets):
    """Kernel F's rectangular form, y = Aᴴx with ncols entries for the
    n × ncols matrix of kernel E, against its plain version: the layout of
    a DistDIAMatrix rank (offsets + hw, ncols = n + 2 hw) and a narrower
    output."""
    from lis_tpu_torch.matrix import dia
    rng = np.random.default_rng(n)
    A = _banded(rng, n, offsets, vdtype, ncols=ncols)
    x = _randn(rng, n, xdtype)
    want = dia._spmvh_plain(A.value, A.offsets, x, ncols)
    before = dia.dia_spmvh.launches
    got = dia.dia_spmvh(A.value.to(cuda), A.off.to(cuda), A.offsets,
                        x.to(cuda), ncols)
    assert dia.dia_spmvh.launches == before + 1
    assert got.shape == (ncols,) and got.dtype == want.dtype
    tol = max(_tol(vdtype), _tol(xdtype))
    torch.testing.assert_close(got.cpu(), want, rtol=tol,
                               atol=tol * float(want.abs().max()))


def _dist_dia_rank(mesh, g, opts):
    """A rank of the card tests: poisson3d27 g^3 in DIA, distributed, one
    dist_solve of ones; (status, iters, x)."""
    from lis_tpu_torch import parallel as P
    from lis_tpu_torch.utils import testmat
    D = testmat.poisson3d27_dia(g, g, g)
    Ad = P.distribute_dia(D, mesh)
    r = P.dist_solve(Ad, np.ones(D.nrows), mesh, options=opts)
    return r.status, r.iters, r.x.cpu().numpy(), str(Ad.value.device)


@pytest.mark.gpu
@pytest.mark.parametrize("nprocs,backend,opts", [
    (1, "nccl", "-i cg -p jacobi -tol 1e-10"),
    (2, "gloo", "-i bicg -p jacobi -tol 1e-10")])
def test_dist_solve_on_the_card(cuda, nprocs, backend, opts):
    """dist_solve on the card against the serial solve: one rank over
    nccl (the same count, x to 1e-12), and two ranks sharing the card over
    gloo (staged; the matvech through the rectangular F; count ±1)."""
    from lis_tpu_torch.parallel import launch
    from lis_tpu_torch.utils import testmat
    st, it, x, where = launch(_dist_dia_rank, nprocs, 24, opts,
                              device="cuda", backend=backend, timeout=300)
    D = testmat.poisson3d27_dia(24, 24, 24)
    s = lis_tpu_torch.solve(D, np.ones(D.nrows), options=opts)
    assert where.startswith("cuda") and st == s.status == 0
    xs = s.x.cpu().numpy()
    if nprocs == 1:
        assert it == s.iters
        np.testing.assert_allclose(x, xs, rtol=0,
                                   atol=1e-12 * np.abs(xs).max())
    else:
        assert abs(it - s.iters) <= 1
        np.testing.assert_allclose(x, xs, rtol=0,
                                   atol=1e-8 * np.abs(xs).max())


def _dist_esolve_rank(mesh, g, opts):
    """A rank of the card tests: poisson3d27 g^3 in DIA, distributed, one
    dist_esolve; (status, iters, eigenvalues, E launches, the evector's
    device and length)."""
    from lis_tpu_torch import parallel as P
    from lis_tpu_torch.matrix import dia
    from lis_tpu_torch.utils import testmat
    Ad = P.distribute_dia(testmat.poisson3d27_dia(g, g, g), mesh)
    before = dia.dia_spmv.launches
    r = P.dist_esolve(Ad, mesh, options=opts)
    return (r.status, r.iters, r.evalues, dia.dia_spmv.launches - before,
            str(r.evector.device), r.evector.shape[0])


@pytest.mark.gpu
@pytest.mark.parametrize("nprocs,backend,opts", [
    (1, "nccl", "-e pi -etol 1e-8 -emaxiter 2000"),
    (1, "nccl", "-e ii -i cg -etol 1e-8"),
    (1, "nccl", "-e li -ss 2 -rval true"),
    (4, "gloo", "-e pi -emaxiter 100")])
def test_dist_esolve_on_the_card(cuda, nprocs, backend, opts):
    """dist_esolve on the card against the serial esolve: one rank over
    nccl (the same count, eigenvalues to 1e-10), and four ranks sharing
    the card over gloo (staged; the same capped count and eigenvalue, and
    on every rank E three times a matvec: the interior and the two
    boundary slabs)."""
    from lis_tpu_torch.parallel import RankPool
    from lis_tpu_torch.utils import testmat
    with RankPool(nprocs, device="cuda", backend=backend,
                  timeout=300) as pool:
        outs = pool.run_all(_dist_esolve_rank, 24, opts)
    D = testmat.poisson3d27_dia(24, 24, 24)
    s = lis_tpu_torch.esolve(D, options=opts)
    for st, it, ev, e_launches, where, n in outs:
        assert where.startswith("cuda") and n == D.nrows
        assert st == s.status and it == s.iters
        np.testing.assert_allclose(ev, s.evalues, rtol=1e-10)
        if nprocs == 1:
            assert e_launches >= it
        else:
            assert e_launches == 3 * (it + 1)    # pi: a matvec an iteration
