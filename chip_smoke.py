#!/usr/bin/env python3
"""Chip smoke for lis_tpu_torch: build, check and time the CUDA kernels,
then drive the CG + Jacobi solve over the CST SpMV on one CUDA device.

Usage: python3 chip_smoke.py [--seed N]

Phases (one or more lines each):
1. environment: the card (nvidia-smi name and power limit), torch and
   CUDA versions, and the nvcc build of lis_tpu_torch/csrc/*.cu;
2. every kernel against its plain PyTorch version on the card, f64 and
   f32, at the shapes of the solve below: permutations bit-equal, row sums
   to rtol 1e-12 (f64) / 1e-5 (f32);
3. the slice: solve(A, ones, "-i cg -p jacobi -storage cst -tol 1e-10")
   for the locality-free SPD system a + aᵀ + 32·I, n = 2^20, 8 random
   columns per row, made from --seed; SUCCESS with true residual <= 1e-9,
   the iteration count of the port's plain path on the CPU (±1: the CSR
   remainder sums with atomics on the card), and every kernel launched at
   least once per iteration; then once more at -f single;
4. the CST matvec, kernels against plain torch on the card, in
   csr-equivalent GB/s = (nnz·12 + 2n·8) / t.

It prints one JSON line of per-kernel results, then as its last line
{"ok": true, "device": {...}}.  Any failure exits non-zero before that
line; so does a machine without CUDA.
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


def spd_system(n: int, k: int, seed: int):
    """a + aᵀ + 4k·I with k random columns per row (scipy CSR)."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, size=n * k)
    a = sp.coo_matrix((rng.standard_normal(n * k), (rows, cols)),
                      shape=(n, n)).tocsr()
    a = (a + a.T + sp.eye(n) * (4 * k)).tocsr()
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
        return torch.randn(n, generator=gen, device=dev,
                           dtype=torch.float64).to(dtype)

    def row_perms(M):
        r = torch.rand(M // 128, 128, generator=gen, device=dev)
        return torch.argsort(r, dim=1).to(torch.uint8)

    # ---- 2. kernels against their plain versions ---------------------------
    M = 1 << 25              # the slot count of the n = 2^20, Kp = 32 grid
    CB = (1 << 20) // 128
    mtag = f"M=2^{M.bit_length() - 1}"
    results = {}             # kernel -> (max_abs_err, ms, plain_ms)

    def check(name, dtype, shape, got, want, exact, main_shape, timed):
        err = (got.double() - want.double()).abs().max().item()
        if exact:
            ok = torch.equal(got, want)
        else:
            rtol = 1e-12 if dtype == torch.float64 else 1e-5
            scale = want.double().abs().max().item()
            ok = err <= rtol * max(scale, 1.0)
        line = (f"phase kernels: {name} {str(dtype)[6:]} {shape}: "
                f"max_abs_err {err:.3e} "
                f"({'bit-equal' if exact else 'rtol'}) "
                f"{'ok' if ok else 'MISMATCH'}")
        if main_shape:
            ms, plain_ms = cuda_ms(timed[0]), cuda_ms(timed[1])
            results[name] = (err, ms, plain_ms)
            line += f"; {ms:.4f} ms vs plain {plain_ms:.4f} ms"
        print(line, flush=True)
        if not ok:
            fail(f"{name} {dtype} {shape} disagrees with its plain version")

    for dtype in (torch.float64, torch.float32):
        f64 = dtype == torch.float64
        for s in (1, 128, 16384):
            x, idx = randn(M, dtype), row_perms(M)
            check("benes_pass", dtype, f"{mtag} s={s}",
                  sh.benes_pass(x, idx, 128, s),
                  sh._pass_plain(x, idx, 128, s), True, f64 and s == 16384,
                  (lambda: sh.benes_pass(x, idx, 128, s),
                   lambda: sh._pass_plain(x, idx, 128, s)))
        for s, kp in ((16384, 32), (16384, 2), (1024, 256), (128, 16)):
            x, idx = randn(M, dtype), row_perms(M)
            check("benes_pass_rowsum", dtype, f"{mtag} s={s} Kp={kp}",
                  sh.benes_pass_rowsum(x, idx, s, kp),
                  sh._pass_plain(x, idx, 128, s).view(-1, kp).sum(1), False,
                  f64 and (s, kp) == (16384, 32),
                  (lambda: sh.benes_pass_rowsum(x, idx, s, kp),
                   lambda: sh._pass_plain(x, idx, 128, s).view(-1, kp)
                   .sum(1)))
        ss = [128, 1, 128]
        x, idxs = randn(M, dtype), [row_perms(M) for _ in ss]

        def run_plain(kp):
            out = x
            for i, s in zip(idxs, ss):
                out = sh._pass_plain(out, i, 128, s)
            return out if kp is None else out.view(-1, kp).sum(1)

        for kp in (None, 16, 32, 128):
            check("benes_small_run", dtype, f"{mtag} s={ss} Kp={kp}",
                  sh.benes_small_run(x, idxs, ss, Kp=kp), run_plain(kp),
                  kp is None, f64 and kp is None,
                  (lambda: sh.benes_small_run(x, idxs, ss, Kp=kp),
                   lambda: run_plain(kp)))
        for beta, rbc in ((256, 16), (4096, 1), (64, 32)):
            n_slot = CB * rbc * beta
            xp = randn(CB * 128, dtype)
            lidx = torch.randint(0, 128, (n_slot,), generator=gen,
                                 device=dev, dtype=torch.uint8)
            val = randn(n_slot, dtype)
            check("cst_front", dtype, f"CB={CB} beta={beta} RBc={rbc}",
                  cstm.cst_front(xp, lidx, val, rbc, beta),
                  cstm._front_plain(xp, lidx, val, rbc, beta), True,
                  f64 and (beta, rbc) == (4096, 1),
                  (lambda: cstm.cst_front(xp, lidx, val, rbc, beta),
                   lambda: cstm._front_plain(xp, lidx, val, rbc, beta)))
    del x, idx, idxs, xp, lidx, val
    torch.cuda.empty_cache()

    # ---- 3. the slice: CG + Jacobi over the CST SpMV -----------------------
    n, k = 1 << 20, 8
    t0 = time.perf_counter()
    a = spd_system(n, k, args.seed)
    A_cpu = lis_tpu_torch.CSRMatrix.from_csr_arrays(a.indptr, a.indices,
                                                    a.data, a.shape)
    A = A_cpu.to(dev)
    b = np.ones(n)
    print(f"phase slice: system n={n} nnz={a.nnz} built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    opts = "-i cg -p jacobi -storage cst -tol 1e-10"
    kernels = {"cst_front": cstm.cst_front, "benes_pass": sh.benes_pass,
               "benes_pass_rowsum": sh.benes_pass_rowsum,
               "benes_small_run": sh.benes_small_run}
    for fn in kernels.values():
        fn.launches = 0
    t0 = time.perf_counter()
    r = lis_tpu_torch.solve(A, b, options=opts)
    t_cold = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in kernels.items()}

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
    for name, cnt in launches.items():
        if cnt < r.iters:
            fail(f"{name} launched {cnt} times in {r.iters} iterations")
    t0 = time.perf_counter()
    r2 = lis_tpu_torch.solve(A, b, options=opts)
    report("cuda f64 warm", r2, time.perf_counter() - t0)
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
    C = cstm.CSTMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape,
                                       transpose=False).to(dev)
    xv = randn(n, torch.float64)

    def plain_matvec():
        xp = torch.nn.functional.pad(xv, (0, C.n_pad - n))
        t = cstm._front_plain(xp, C.lidx, C.val, C.RBc, C.beta)
        for (d, s), idx in zip(C.plan.meta, C.plan.idxs):
            t = sh._pass_plain(t, idx, d, s)
        y = t.view(-1, C.Kp).sum(1)[:n]
        return y if C.rem is None else y + C.rem.matvec(xv)

    y_k, y_p = C.matvec(xv), plain_matvec()
    err = ((y_k - y_p).abs().max() / y_p.abs().max()).item()
    ms_k = cuda_ms(lambda: C.matvec(xv))
    ms_p = cuda_ms(plain_matvec)
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

    # ---- results -----------------------------------------------------------
    where = {
        "cst_front": ("lis_tpu_torch/csrc/cst_front.cu",
                      "lis_tpu/matrix/cst.py:259"),
        "benes_pass": ("lis_tpu_torch/csrc/benes.cu",
                       "lis_tpu/ops/shuffle.py:419"),
        "benes_pass_rowsum": ("lis_tpu_torch/csrc/benes.cu",
                              "lis_tpu/ops/shuffle.py:509"),
        "benes_small_run": ("lis_tpu_torch/csrc/benes.cu",
                            "lis_tpu/ops/shuffle.py:583"),
    }
    rows = []
    for name, (src, tpu) in where.items():
        e, ms, plain_ms = results[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": launches[name],
                     "max_abs_err": e, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
