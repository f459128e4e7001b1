#!/usr/bin/env python3
"""Chip smoke for lis_tpu_torch: build, check and time the CUDA kernels,
then drive the ported solve paths on one CUDA device.

Usage: python3 chip_smoke.py [--seed N]

Phases (one or more lines each):
1. environment: the card (nvidia-smi name and power limit), torch and
   CUDA versions, and the nvcc build of lis_tpu_torch/csrc/*.cu (one nvcc
   per source, in parallel);
2. every kernel against its plain PyTorch version on the card, at the
   shapes of the solves below: permutations bit-equal (lane_shuffle in
   f32, f64, complex64 and complex128; a benes_pass with d = 16 through
   lane_shuffle), row sums to rtol 1e-12 (f64) / 1e-5 (f32); f64 and f32
   timed beside the plain version, beside the one PyTorch call that
   computes the same function where there is one (torch.gather with a
   prebuilt int64 index, for lane_shuffle and benes_pass), and beside
   the bound: the bytes each must move over 3.35 TB/s, or its additions
   and multiplications over the card's peak rate if that is more.
   benes_small_run is also checked, untimed, for runs of 1, 2, 4 and 8
   passes with Kp in {None, 2, 16, 32, 128} on 1 and on 133 tiles;
3. CG + Jacobi over the CST SpMV: solve(A, ones, "-i cg -p jacobi
   -storage cst -tol 1e-10") for the locality-free SPD system
   a + aᵀ + 32·I, n = 2^20, 8 random columns per row, made from --seed;
   SUCCESS with true residual <= 1e-9, the iteration count of the port's
   plain path on the CPU (±1: the CSR remainder sums with atomics on the
   card), and kernels A-D launched at least once per iteration; then once
   more at -f single.  Each solve rebuilds the CST on the host;
4. the CST matvec, kernels against plain torch on the card, in
   csr-equivalent GB/s = (nnz·12 + 2n·8) / t;
5. reuse: one CST of the nonsymmetric a − 0.5·aᵀ + 32·I (phase 3's
   pattern), built once with its transpose grid, solved with
   "-storage cst -scale 1 -p jacobi -tol 1e-10" by bicg, bicr, bicgstab
   and bicrstab, which scale the grid itself (lane_shuffle); then
   "-i cg -p jacobi -storage cst -scale 1" on phase 4's prebuilt SPD CST
   (scale_symm).  Each: SUCCESS, true residual <= 1e-9 (scipy too), the
   iteration count of the same CST on the CPU ±1, lane_shuffle launched;
   BiCG and BiCR launch kernels A-D at least once per iteration;
6. complex: the complex-symmetric a + aᵀ + 32·I with complex128 values on
   the same pattern, one CST; cocg and cocr with -p jacobi, checked as
   in phase 5 with lane_shuffle launched at least once per iteration;
   cocg at -f single, which must keep complex128 and is held against the
   CPU run at double; the complex CST matvec against its plain version
   to rel 1e-12, both timed.

The matrices of phases 3 to 6 are built with no ``device`` argument, so
they live on the default device, the card; each has a CPU copy for the
CPU iteration count it is held against.

Launch counts are set to 0 just before each solve of phases 3, 5 and 6
and read just after; launches made to compare a kernel with its plain
version are not counted.  It prints one JSON line of per-kernel results,
then as its last line {"ok": true, "device": {...}}.  Any failure exits
non-zero before that line; so does a machine without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def system(n: int, k: int, seed: int, kind: str = "spd"):
    """a + aᵀ + 4k·I ("spd"), a − 0.5·aᵀ + 4k·I ("nonsym") or a + aᵀ + 4k·I
    with standard-normal real and imaginary parts ("csym"), where a has k
    random columns per row: one sparsity pattern for every kind (scipy
    CSR)."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
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


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of fn() in ms over ``reps`` back-to-back calls,
    measured with CUDA events after ``warm`` untimed calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# The card's peaks (NVIDIA H100 SXM data sheet): device memory rate, and
# the arithmetic rate outside the tensor cores for each real type.
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "float64": 33.5e12}


def bound_ms(nbytes: int, flops: int, dtype) -> tuple[float, str]:
    """The least time the card could take: (ms, "bytes" | "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FLOPS_PER_S[str(dtype)[6:]]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a "
             "CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import lis_tpu_torch
        from lis_tpu_torch.matrix import cst as cstm
        from lis_tpu_torch.ops import _cuda, shuffle as sh
    except ImportError as e:
        fail(f"lis_tpu_torch is not importable next to this script ({e})")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. environment ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(smi_line)
    print(f"phase env: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _cuda.lib()
    print(f"phase build: kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_cuda.build_seconds or 0.0:.2f} s)")
    for ln in _cuda.build_log.splitlines():
        if "Compiling entry" in ln or "Used" in ln:
            print("  ptxas:", ln.split(":", 1)[-1].strip())

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def randn(n, dtype):
        if dtype.is_complex:
            re = torch.randn(2 * n, generator=gen, device=dev,
                             dtype=torch.float64)
            return torch.complex(re[:n], re[n:]).to(dtype)
        return torch.randn(n, generator=gen, device=dev,
                           dtype=torch.float64).to(dtype)

    def row_perms(M, d=128):
        """Random lane permutations of each 128-lane row, within aligned
        groups of d lanes (a pass with digit d)."""
        r = torch.rand(M // 128, 128 // d, d, generator=gen, device=dev)
        base = torch.arange(0, 128, d, device=dev).view(1, -1, 1)
        return (torch.argsort(r, dim=2) + base).view(-1, 128).to(torch.uint8)

    # ---- 2. kernels against their plain versions ---------------------------
    M = 1 << 25              # the slot count of the n = 2^20, Kp = 32 grid
    CB = (1 << 20) // 128
    mtag = f"M=2^{M.bit_length() - 1}"
    results = {}             # kernel -> dict of the f64 numbers
    results32 = {}          # the same at f32

    def check(name, dtype, shape, got, want, exact, timed=None):
        """Hold a kernel's output against its plain version's; with
        ``timed`` = (kernel fn, plain fn, library fn or None, bytes moved,
        additions and multiplications) also time them (the slice's shape:
        recorded per dtype)."""
        wide = torch.complex128 if got.is_complex() else torch.float64
        err = (got.to(wide) - want.to(wide)).abs().max().item()
        if exact:
            ok = torch.equal(got, want)
        else:
            rtol = 1e-12 if dtype == torch.float64 else 1e-5
            scale = want.to(wide).abs().max().item()
            ok = err <= rtol * max(scale, 1.0)
        line = (f"phase kernels: {name} {str(dtype)[6:]} {shape}: "
                f"max_abs_err {err:.3e} "
                f"({'bit-equal' if exact else 'rtol'}) "
                f"{'ok' if ok else 'MISMATCH'}")
        if timed is not None:
            kern, plain, library, nbytes, flops = timed
            ms, plain_ms = cuda_ms(kern), cuda_ms(plain)
            lib_ms = None if library is None else cuda_ms(library)
            b_ms, b_by = bound_ms(nbytes, flops, dtype)
            rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
            if dtype == torch.float64:
                results[name] = rec
            elif dtype == torch.float32:
                results32[name] = rec
            line += (f"; {ms:.4f} ms vs plain {plain_ms:.4f} ms, bound "
                     f"{b_ms:.4f} ms ({b_by}, {100 * b_ms / ms:.0f} %), "
                     f"library " + ("none" if lib_ms is None
                                    else f"{lib_ms:.4f} ms"))
        print(line, flush=True)
        if not ok:
            fail(f"{name} {dtype} {shape} disagrees with its plain version")

    def es(dtype):
        return torch.empty((), dtype=dtype).element_size()

    R = M // 128
    for dtype in (torch.float64, torch.float32, torch.complex128,
                  torch.complex64):
        for rep in (1, 32):     # rep 32: the select of the Kp = 32 grid
            x, idx = randn(R // rep * 128, dtype).view(-1, 128), row_perms(M)
            timed = None
            if rep == 1 and not dtype.is_complex:
                wide = idx.long()       # the library call's index, untimed
                timed = (lambda: sh.lane_shuffle(x, idx, rep),
                         lambda: sh._lane_shuffle_plain(x, idx, rep),
                         lambda: torch.gather(x, 1, wide),
                         M * (2 * es(dtype) + 1), 0)
            check("lane_shuffle", dtype, f"R=2^{R.bit_length() - 1} "
                  f"rep={rep}", sh.lane_shuffle(x, idx, rep),
                  sh._lane_shuffle_plain(x, idx, rep), True, timed)
            del timed
    for dtype in (torch.float64, torch.float32):
        for s in (1, 128, 16384):
            x, idx = randn(M, dtype), row_perms(M)
            timed = None
            if s == 16384:
                # out[p, a, w] = x[p, idx[p s + w, a], w] as one gather
                # along a of the (P, 128, s) view; the index is untimed
                x3 = x.view(-1, 128, s)
                i3 = idx.view(-1, s, 128).transpose(1, 2).long().contiguous()
                if not torch.equal(torch.gather(x3, 1, i3).reshape(-1),
                                   sh._pass_plain(x, idx, 128, s)):
                    fail("benes_pass: the library gather disagrees")
                timed = (lambda: sh.benes_pass(x, idx, 128, s),
                         lambda: sh._pass_plain(x, idx, 128, s),
                         lambda: torch.gather(x3, 1, i3),
                         M * (2 * es(dtype) + 1), 0)
            check("benes_pass", dtype, f"{mtag} s={s}",
                  sh.benes_pass(x, idx, 128, s),
                  sh._pass_plain(x, idx, 128, s), True, timed)
            if timed is not None:
                del timed, x3, i3
        d, s = 16, 1024         # a digit below 128: lane_shuffle's route
        x, idx = randn(M, dtype), row_perms(M, d)
        check("benes_pass", dtype, f"{mtag} d={d} s={s} (lane_shuffle)",
              sh.benes_pass(x, idx, d, s), sh._pass_plain(x, idx, d, s),
              True)
        for s, kp in ((16384, 32), (16384, 2), (1024, 256), (128, 16)):
            x, idx = randn(M, dtype), row_perms(M)
            check("benes_pass_rowsum", dtype, f"{mtag} s={s} Kp={kp}",
                  sh.benes_pass_rowsum(x, idx, s, kp),
                  sh._pass_plain(x, idx, 128, s).view(-1, kp).sum(1), False,
                  (lambda: sh.benes_pass_rowsum(x, idx, s, kp),
                   lambda: sh._pass_plain(x, idx, 128, s).view(-1, kp)
                   .sum(1), None,
                   M * (es(dtype) + 1) + M // kp * es(dtype),
                   M - M // kp) if (s, kp) == (16384, 32) else None)

        def run_plain(x, idxs, ss, kp):
            out = x
            for i, s in zip(idxs, ss):
                out = sh._pass_plain(out, i, 128, s)
            return out if kp is None else out.view(-1, kp).sum(1)

        # the slice's run at its size, timed; then every run shape on one
        # tile and on 133 tiles (a count that no grid divides), untimed
        ss = [128, 1, 128]
        x, idxs = randn(M, dtype), [row_perms(M) for _ in ss]
        run = sh.RunTables(idxs, ss)
        for kp in (None, 2, 16, 32, 128):
            check("benes_small_run", dtype, f"{mtag} s={ss} Kp={kp}",
                  sh.benes_small_run(x, run, Kp=kp),
                  run_plain(x, idxs, ss, kp), kp is None,
                  (lambda: sh.benes_small_run(x, run, Kp=kp),
                   lambda: run_plain(x, idxs, ss, kp), None,
                   M * (2 * es(dtype) + len(ss)), 0)
                  if kp is None else None)
        for Ms in (16384, 16384 * 133):
            for ss in ([1], [128], [1, 128], [128, 1], [1, 128, 1, 128],
                       [128, 1, 1, 128, 128, 1, 128, 1]):
                xs, idxs = randn(Ms, dtype), [row_perms(Ms) for _ in ss]
                run = sh.RunTables(idxs, ss)
                for kp in (None, 2, 16, 32, 128):
                    check("benes_small_run", dtype,
                          f"M={Ms} s={ss} Kp={kp}",
                          sh.benes_small_run(xs, run, Kp=kp),
                          run_plain(xs, idxs, ss, kp), kp is None)
        for beta, rbc in ((256, 16), (4096, 1), (64, 32)):
            n_slot = CB * rbc * beta
            xp = randn(CB * 128, dtype)
            lidx = torch.randint(0, 128, (n_slot,), generator=gen,
                                 device=dev, dtype=torch.uint8)
            val = randn(n_slot, dtype)
            check("cst_front", dtype, f"CB={CB} beta={beta} RBc={rbc}",
                  cstm.cst_front(xp, lidx, val, rbc, beta),
                  cstm._front_plain(xp, lidx, val, rbc, beta), True,
                  (lambda: cstm.cst_front(xp, lidx, val, rbc, beta),
                   lambda: cstm._front_plain(xp, lidx, val, rbc, beta), None,
                   n_slot * (2 * es(dtype) + 1) + CB * 128 * es(dtype),
                   n_slot) if (beta, rbc) == (4096, 1) else None)
    for name, r32 in results32.items():
        print(f"phase kernels: {name} float32 at the slice's shape: "
              f"{r32['ms']:.4f} ms vs plain {r32['plain_ms']:.4f} ms, "
              f"bound {r32['bound_ms']:.4f} ms, library "
              f"{r32['library_ms']}", flush=True)
    del x, xs, idx, idxs, run, xp, lidx, val, wide
    torch.cuda.empty_cache()

    # ---- 3. the slice: CG + Jacobi over the CST SpMV -----------------------
    kernels = {"lane_shuffle": sh.lane_shuffle, "cst_front": cstm.cst_front,
               "benes_pass": sh.benes_pass,
               "benes_pass_rowsum": sh.benes_pass_rowsum,
               "benes_small_run": sh.benes_small_run}
    matvec_kernels = ("cst_front", "benes_pass", "benes_pass_rowsum",
                      "benes_small_run")
    total = dict.fromkeys(kernels, 0)     # launches over the counted solves

    def counted(fn):
        """fn() with every launch count set to 0 just before it and read
        just after: (result, launches, wall s)."""
        for f in kernels.values():
            f.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {name: f.launches for name, f in kernels.items()}
        for name, cnt in got.items():
            total[name] += cnt
        return out, got, wall

    def need_launches(got, names, least, what):
        for name in names:
            if got[name] < least:
                fail(f"{what}: {name} launched {got[name]} times, "
                     f"expected at least {least}")

    n, k = 1 << 20, 8
    t0 = time.perf_counter()
    a = system(n, k, args.seed)
    csr = (a.indptr, a.indices, a.data, a.shape)
    A = lis_tpu_torch.CSRMatrix.from_csr_arrays(*csr)   # the default device
    A_cpu = lis_tpu_torch.CSRMatrix.from_csr_arrays(*csr, device="cpu")
    if A.device.type != "cuda" or A_cpu.device.type != "cpu":
        fail(f"a matrix built with no device lives on {A.device}, with "
             f"device='cpu' on {A_cpu.device}")
    b = np.ones(n)
    print(f"phase slice: system n={n} nnz={a.nnz} built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    opts = "-i cg -p jacobi -storage cst -tol 1e-10"
    r, launches, t_cold = counted(
        lambda: lis_tpu_torch.solve(A, b, options=opts))

    def report(tag, res, wall):
        print(f"phase slice: {tag}: status {res.status} iters {res.iters} "
              f"true_resid {res.true_resid:.3e} solve {wall:.2f} s "
              f"(itime {res.itime:.4f} s, "
              f"{1e3 * res.itime / max(res.iters, 1):.4f} ms/iter)",
              flush=True)

    report("cuda f64 cold (CST build included)", r, t_cold)
    x = r.x.cpu().numpy()
    res_scipy = np.linalg.norm(a @ x - b) / np.linalg.norm(b)
    print(f"phase slice: launches {launches}; scipy residual of x "
          f"{res_scipy:.3e}", flush=True)
    if r.status != lis_tpu_torch.LIS_SUCCESS:
        fail(f"slice status {r.status}")
    if not (r.true_resid <= 1e-9 and res_scipy <= 1e-9):
        fail(f"true residual {r.true_resid:.3e} / {res_scipy:.3e} > 1e-9")
    need_launches(launches, matvec_kernels, r.iters, "slice")
    t0 = time.perf_counter()
    r2 = lis_tpu_torch.solve(A, b, options=opts)
    t_warm = time.perf_counter() - t0
    report("cuda f64 warm", r2, t_warm)
    t0 = time.perf_counter()
    rc = lis_tpu_torch.solve(A_cpu, b, options=opts)
    report("cpu f64 plain path", rc, time.perf_counter() - t0)
    if abs(rc.iters - r.iters) > 1 or rc.status != r.status:
        fail(f"cuda iters {r.iters} vs cpu iters {rc.iters}")
    t0 = time.perf_counter()
    rs = lis_tpu_torch.solve(A, b, options=opts + " -f single")
    report("cuda -f single", rs, time.perf_counter() - t0)
    if not (np.isfinite(rs.x.cpu().numpy()).all()
            and rs.true_resid <= 1e-4):
        fail(f"-f single true residual {rs.true_resid:.3e}")

    # ---- 4. CST matvec: kernels against plain torch on the card ------------
    def cst_pair(a_sp, **kw):
        """A CST of ``a_sp`` built with no device (so on the card), and
        its CPU copy; one host build serves both."""
        Cd = cstm.CSTMatrix.from_csr_arrays(a_sp.indptr, a_sp.indices,
                                            a_sp.data, a_sp.shape, **kw)
        if Cd.device.type != "cuda" or Cd.plan.device.type != "cuda":
            fail(f"a CST built with no device lives on {Cd.device}")
        return Cd, Cd.to("cpu")

    C, C_cpu = cst_pair(a, transpose=False)

    def plain_matvec(C, xv):
        """C.matvec(xv) through the kernels' plain versions only."""
        xp = torch.nn.functional.pad(xv, (0, C.n_pad - xv.shape[0]))
        if xv.is_complex():
            t = sh._lane_shuffle_plain(xp.view(-1, 128), C.lidx, C.Kp) * C.val
            t = t.view(-1, C.RBc, C.beta).transpose(0, 1).reshape(-1)
        else:
            t = cstm._front_plain(xp, C.lidx, C.val, C.RBc, C.beta)

        def route(t):
            for (d, s), idx in zip(C.plan.meta, C.plan.idxs):
                t = sh._pass_plain(t, idx, d, s)
            return t.view(-1, C.Kp).sum(1)

        y = (torch.complex(route(t.real.contiguous()),
                           route(t.imag.contiguous()))
             if t.is_complex() else route(t))[: C.nrows]
        return y if C.rem is None else y + C.rem.matvec(xv)

    xv = randn(n, torch.float64)
    y_k, y_p = C.matvec(xv), plain_matvec(C, xv)
    err = ((y_k - y_p).abs().max() / y_p.abs().max()).item()
    ms_k = cuda_ms(lambda: C.matvec(xv))
    ms_p = cuda_ms(lambda: plain_matvec(C, xv))
    ms_csr = cuda_ms(lambda: A.matvec(xv))
    traffic = a.nnz * 12 + 2 * n * 8
    print(f"phase matvec: CST Kp={C.Kp} M=2^{C.plan.M.bit_length() - 1} "
          f"passes {C.plan.meta} rem {0 if C.rem is None else C.rem.nnz}: "
          f"kernels {ms_k:.4f} ms = {traffic / ms_k / 1e6:.2f} GB/s, "
          f"plain torch {ms_p:.4f} ms = {traffic / ms_p / 1e6:.2f} GB/s, "
          f"CSR gather {ms_csr:.4f} ms = {traffic / ms_csr / 1e6:.2f} GB/s "
          f"(csr-equivalent); kernel vs plain rel err {err:.2e}",
          flush=True)
    if err > 1e-12:
        fail(f"CST matvec kernels vs plain: relative error {err:.3e}")

    def solve_checked(tag, Ad, Ac, a_sp, b, opts, per_iter, once,
                      rc=None):
        """One counted solve on the card and the same prebuilt operator
        on the CPU (or the CPU result ``rc`` of an equivalent solve):
        SUCCESS, true residual <= 1e-9 (the port's and scipy's),
        iterations equal ±1, and the kernels in ``per_iter`` launched at
        least once per iteration, those in ``once`` at least once.
        Returns (result, wall s, CPU result)."""
        r, got, wall = counted(
            lambda: lis_tpu_torch.solve(Ad, b, options=opts))
        t0 = time.perf_counter()
        if rc is None:
            rc = lis_tpu_torch.solve(Ac, b, options=opts)
        wall_cpu = time.perf_counter() - t0
        x = r.x.cpu().numpy()
        res_scipy = np.linalg.norm(a_sp @ x - b) / np.linalg.norm(b)
        print(f"phase {tag}: {opts}: status {r.status} iters {r.iters} "
              f"(cpu {rc.iters}) true_resid {r.true_resid:.3e} "
              f"(scipy {res_scipy:.3e}) x {r.x.dtype}; solve {wall:.4f} s "
              f"(itime {r.itime:.4f} s, "
              f"{1e3 * r.itime / max(r.iters, 1):.4f} ms/iter; "
              f"cpu {wall_cpu:.2f} s); launches {got}", flush=True)
        if r.status != lis_tpu_torch.LIS_SUCCESS or rc.status != r.status:
            fail(f"{tag} {opts}: status {r.status} (cpu {rc.status})")
        if not (r.true_resid <= 1e-9 and res_scipy <= 1e-9):
            fail(f"{tag} {opts}: true residual {r.true_resid:.3e} / "
                 f"{res_scipy:.3e} > 1e-9")
        if abs(rc.iters - r.iters) > 1:
            fail(f"{tag} {opts}: cuda iters {r.iters} vs cpu {rc.iters}")
        need_launches(got, per_iter, r.iters, f"{tag} {opts}")
        need_launches(got, once, 1, f"{tag} {opts}")
        return r, wall, rc

    # ---- 5. reuse: one prebuilt CST, scaled by each solve ------------------
    t0 = time.perf_counter()
    an = system(n, k, args.seed, "nonsym")
    N, N_cpu = cst_pair(an)
    print(f"phase reuse: nonsymmetric system nnz={an.nnz}, CST with its "
          f"transpose grid built once in {time.perf_counter() - t0:.2f} s "
          f"(phase 3 rebuilt per solve: {t_cold:.2f} s cold, "
          f"{t_warm:.2f} s warm)", flush=True)
    walls = []
    for solver in ("bicg", "bicr", "bicgstab", "bicrstab"):
        _, wall, _ = solve_checked(
            "reuse", N, N_cpu, an, b,
            f"-i {solver} -p jacobi -storage cst -scale 1 -tol 1e-10",
            matvec_kernels if solver in ("bicg", "bicr") else (),
            ("lane_shuffle",) + matvec_kernels)
        walls.append(wall)
    _, wall, _ = solve_checked(
        "reuse", C, C_cpu, a, b,
        "-i cg -p jacobi -storage cst -scale 1 -tol 1e-10",
        matvec_kernels, ("lane_shuffle",))
    walls.append(wall)
    print(f"phase reuse: per-solve wall {min(walls):.4f}-{max(walls):.4f} s "
          f"on the prebuilt CST, against {t_warm:.2f} s for phase 3's warm "
          f"solve that rebuilds it", flush=True)
    del N, N_cpu
    torch.cuda.empty_cache()

    # ---- 6. complex: COCG / COCR over a complex CST -------------------------
    t0 = time.perf_counter()
    ac = system(n, k, args.seed, "csym")
    Z, Z_cpu = cst_pair(ac, transpose=False)
    rng = np.random.default_rng(args.seed + 1)
    bc = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    print(f"phase complex: complex-symmetric system nnz={ac.nnz}, CST built "
          f"once in {time.perf_counter() - t0:.2f} s", flush=True)
    cpu = {}
    for solver, single in (("cocg", ""), ("cocr", ""), ("cocg", " -f single")):
        opts = f"-i {solver} -p jacobi -storage cst -tol 1e-10" + single
        # a complex vector takes the select (lane_shuffle) in place of
        # kernel A, then B, C and D on its real and imaginary planes.
        # -f single leaves complex128 as it is, so it is held against
        # the CPU run at double
        r, _, cpu[solver] = solve_checked(
            "complex", Z, Z_cpu, ac, bc, opts,
            ("lane_shuffle",) + matvec_kernels[1:], (), cpu.get(solver))
        if r.x.dtype != torch.complex128:
            fail(f"complex {opts}: x is {r.x.dtype}")
    zv = randn(n, torch.complex128)
    y_k, y_p = Z.matvec(zv), plain_matvec(Z, zv)
    err = ((y_k - y_p).abs().max() / y_p.abs().max()).item()
    ms_zk = cuda_ms(lambda: Z.matvec(zv))
    ms_zp = cuda_ms(lambda: plain_matvec(Z, zv))
    print(f"phase complex: complex128 CST matvec: kernels {ms_zk:.4f} ms "
          f"({ms_zk / ms_k:.2f}x the real f64 matvec's {ms_k:.4f} ms), "
          f"plain torch {ms_zp:.4f} ms; kernel vs plain rel err {err:.2e}",
          flush=True)
    if err > 1e-12:
        fail(f"complex CST matvec kernels vs plain: relative error "
             f"{err:.3e}")

    # ---- results -----------------------------------------------------------
    where = {
        "lane_shuffle": ("lis_tpu_torch/csrc/lane_shuffle.cu",
                         "lis_tpu/ops/shuffle.py:350"),
        "cst_front": ("lis_tpu_torch/csrc/cst_front.cu",
                      "lis_tpu/matrix/cst.py:259"),
        "benes_pass": ("lis_tpu_torch/csrc/benes.cu",
                       "lis_tpu/ops/shuffle.py:419"),
        "benes_pass_rowsum": ("lis_tpu_torch/csrc/benes.cu",
                              "lis_tpu/ops/shuffle.py:509"),
        "benes_small_run": ("lis_tpu_torch/csrc/benes.cu",
                            "lis_tpu/ops/shuffle.py:583"),
    }
    print(f"phase results: launches over the counted solves {total}",
          flush=True)
    rows = []
    for name, (src, tpu) in where.items():
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": total[name],
                     **results[name]})
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
