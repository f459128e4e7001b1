#!/usr/bin/env python3
"""Time kernel D (benes_small_run) and the solves it serves in this
checkout beside other checkouts, on one CUDA device.

Usage:
    python3 lis_tpu_torch/tools/bench_small_run.py [--root NAME=DIR ...]

``--root`` names another checkout of the repository (an unpacked
``git archive`` of an earlier commit) to time beside this one, each in a
process of its own, a b b a (``_abba.py``).  Correctness is
chip_smoke.py's business; its helpers build the systems and time the
calls here.

A worker builds its checkout's kernels, prints ptxas's report for the run
kernel, and times with CUDA events (20 back-to-back calls after 3
warm-ups): D for the run [128, 1, 128] at M = 2^25 slots, f64 and f32,
alone and with Kp = 32; then, on chip_smoke.py's system (a + a^T + 32 I,
n = 2^20, 8 random columns per row, seed 0; real, then with complex128
values), the CST matvec, and the ms/iter of six "-i cg -p jacobi -storage
cst -tol 1e-10" solves and four cocg solves on the prebuilt CST (the
first of each is a warm-up and is left out; all others are listed).  One
JSON line per worker; the card's nvidia-smi name and power limit head the
output.  Exits non-zero without a CUDA device or when a solve fails.
"""

from __future__ import annotations

import json
import os
import sys

import _abba              # the a b b a runner, beside this file

_HERE = os.path.abspath(__file__)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))


def worker(root: str) -> None:
    sys.path.insert(0, _ROOT)
    from chip_smoke import cuda_ms, system    # this checkout's helpers
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import lis_tpu_torch
    from lis_tpu_torch.matrix.cst import CSTMatrix
    from lis_tpu_torch.ops import _cuda, shuffle as sh
    if not torch.cuda.is_available():
        sys.exit("bench_small_run: no CUDA device")
    dev = torch.device("cuda", 0)
    _cuda.lib()
    ptxas, keep = [], False
    for ln in _cuda.build_log.splitlines():
        if "Compiling entry" in ln:
            keep = "small_run" in ln
        elif keep and ("Used" in ln or "stack frame" in ln):
            ptxas.append(ln.split(":", 1)[-1].strip())
    out = {"ptxas": ptxas, "build_s": _cuda.build_seconds}

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    M, ss = 1 << 25, [128, 1, 128]
    idxs = [torch.argsort(torch.rand(M // 128, 128, generator=gen,
                                     device=dev), dim=1).to(torch.uint8)
            for _ in ss]
    if hasattr(sh, "RunTables"):
        tables = (sh.RunTables(idxs, ss),)
    else:                       # an earlier checkout: tables, then strides
        tables = (idxs, ss)
    for dtype, tag in ((torch.float64, "f64"), (torch.float32, "f32")):
        x = torch.randn(M, generator=gen, device=dev,
                        dtype=torch.float64).to(dtype)
        for kp, key in ((None, f"{tag}_ms"), (32, f"{tag}_kp32_ms")):
            out[key] = cuda_ms(
                lambda: sh.benes_small_run(x, *tables, Kp=kp))
    del x, idxs, tables
    torch.cuda.empty_cache()

    n = 1 << 20
    for kind, tag, solver in (("spd", "real", "cg"),
                              ("csym", "complex", "cocg")):
        a = system(n, 8, 0, kind)
        C = CSTMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape,
                                      transpose=False).to(dev)
        b = np.ones(n) if solver == "cg" else np.ones(n) * (1 + 1j)
        xv = torch.from_numpy(b).to(dev)
        out[f"{tag}_matvec_ms"] = cuda_ms(lambda: C.matvec(xv))
        per_iter = []
        for _ in range(6 if solver == "cg" else 4):
            r = lis_tpu_torch.solve(
                C, b, options=f"-i {solver} -p jacobi -storage cst -tol 1e-10")
            if r.status != 0 or not r.true_resid <= 1e-9:
                sys.exit(f"bench_small_run: {solver} status {r.status} "
                         f"true residual {r.true_resid}")
            per_iter.append(1e3 * r.itime / r.iters)
        out[f"{solver}_iters"] = r.iters
        out[f"{solver}_ms_per_iter"] = per_iter[1:]
        del C
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    _abba.main(__file__, worker, __doc__)
