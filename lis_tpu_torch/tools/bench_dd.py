#!/usr/bin/env python3
"""Time kernels N (dd_ell_spmv) and O (dd_reduce) and the double-double
solves they serve in this checkout beside other checkouts, on one CUDA
device.

Usage:
    python3 lis_tpu_torch/tools/bench_dd.py [--root NAME=DIR ...]

``--root`` names another checkout of the repository (an unpacked
``git archive`` of an earlier commit) to time beside this one, each in a
process of its own, a b b a (``_abba.py``).  Correctness is
chip_smoke.py's business; its ``cuda_ms`` times the calls here (20
back-to-back calls after 3 warm-ups, with CUDA events).

A worker builds its checkout's kernels and prints ptxas's report for N
and O.  It times O's dot on random DD vectors of 96³ (f64 and f32 limbs)
and 192³ (f64) entries, from the device's queue and, as ``_host_ms``, as
the host enqueues each call; N on the ELL pair of chip_smoke.py's
n = 2^20 system (8 random columns a row, a + aᵀ + 32·I: 34 entries in
the longest row), forward, f64 and f32 limbs.  Where the checkout has
them (``_reduce_launch``, ``_ell_launch``) it also times O's dot at 96³
and 192³ f64 on grids of 64 and 128 blocks in 8 and 16 groups, and N
with a warp a row (rows = 0) beside the plan at n = 2^20, and both
(staged and a warp a row) on random ELL arrays of 2^18 rows of 48, 64,
96 and 128 entries.  Then it solves "-i cg -p
jacobi -f quad -tol 1e-12" (b = 1) on poisson3d27 96³ (routed to DIA)
and 192³ (built in DIA), and "-i bicgstab -f quad -auto_storage false
-tol 1e-12" on the n = 2^20 system as CSR (the ELL pair), three times
each: iterations, and the ms/iter of the last two (the first warms up).
One JSON line per worker; the card's nvidia-smi name and power limit
head the output.  Exits non-zero without a CUDA device or when a solve
fails.
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
    from chip_smoke import cuda_ms, system      # this checkout's helpers
    sys.path.insert(0, root)
    import torch
    import lis_tpu_torch
    from lis_tpu_torch.core import ddreal as dq
    from lis_tpu_torch.ops import _cuda
    from lis_tpu_torch.utils import testmat
    if not torch.cuda.is_available():
        sys.exit("bench_dd: no CUDA device")
    dev = torch.device("cuda", 0)
    _cuda.lib()
    ptxas, keep = [], False
    for ln in _cuda.build_log.splitlines():
        if "Compiling entry" in ln:
            keep = "ell" in ln or "reduce" in ln
            name = ln.split("'")[1] if "'" in ln else ln
        elif keep and "Used" in ln:
            ptxas.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    out = {"ptxas": ptxas, "build_s": _cuda.build_seconds}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    f32, f64 = torch.float32, torch.float64

    def pair(n, dtype):
        hi = torch.randn(n, generator=gen, device=dev, dtype=f64)
        lo = hi * (torch.rand(n, generator=gen, device=dev, dtype=f64)
                   - 0.5) * torch.finfo(dtype).eps
        return dq.DD(hi.to(dtype), lo.to(dtype))

    def timed(key, fn):
        out[f"{key}_ms"] = cuda_ms(fn, queued=True)
        out[f"{key}_host_ms"] = cuda_ms(fn)

    # ---- O: the dots ------------------------------------------------------
    plans = hasattr(dq, "_reduce_launch")
    for g, dtype in ((96, f64), (96, f32), (192, f64)):
        x, y = pair(g ** 3, dtype), pair(g ** 3, dtype)
        tag = f"O_dot_{g}_{str(dtype)[6:]}"
        timed(tag, lambda: dq.dot(x, y))
        if plans and dtype == f64:
            for plan in ((64, 8), (128, 8), (128, 16)):
                timed(f"{tag}_G{plan[0]}_R{plan[1]}",
                      lambda: dq._reduce_launch(1, x, y, plan))
        del x, y

    # ---- N: the n = 2^20 ELL pair, and wider rows --------------------------
    a = system(1 << 20, 8, 0)
    A = lis_tpu_torch.CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data,
                                                a.shape)
    op64 = dq.DDOperator.from_matrix(A)
    n = a.shape[0]
    out["N_w"] = op64.value.shape[1]
    for dtype in (f64, f32):
        val, vlo = op64.value, None
        if dtype == f32:
            val, vlo = dq._split_limbs(op64.value, f32)
        x = pair(n, dtype)
        tag = f"N_2^20_{str(dtype)[6:]}"
        timed(tag, lambda: dq.dd_ell_spmv(op64.index, val, x, vlo))
        if hasattr(dq, "_ell_launch"):
            timed(f"{tag}_warp", lambda: dq._ell_launch(op64.index, val, x,
                                                        vlo, 0))
    if hasattr(dq, "_ell_launch"):
        nr = 1 << 18
        x = pair(nr, f64)
        for w in (48, 64, 96, 128):
            idx = torch.randint(0, nr, (nr, w), generator=gen, device=dev,
                                dtype=torch.int32)
            val = torch.randn(nr, w, generator=gen, device=dev, dtype=f64)
            timed(f"N_2^18_w{w}_f64_staged",
                  lambda: dq._ell_launch(idx, val, x, None,
                                         dq._ell_rows(w, 8)))
            timed(f"N_2^18_w{w}_f64_warp",
                  lambda: dq._ell_launch(idx, val, x, None, 0))
            del idx, val
    del op64, x
    torch.cuda.empty_cache()

    # ---- the solves they serve --------------------------------------------
    def solves(key, M, opts):
        b = torch.ones(M.nrows, dtype=f64, device=dev)
        per = []
        for _ in range(3):
            r = lis_tpu_torch.solve(M, b, options=opts)
            if r.status != 0:
                sys.exit(f"bench_dd: {key}: status {r.status}")
            per.append(1e3 * r.itime / r.iters)
        out[f"{key}_iters"] = r.iters
        out[f"{key}_ms_per_iter"] = per[1:]

    cg = "-i cg -p jacobi -f quad -tol 1e-12"
    solves("cg_quad_96", testmat.poisson3d27(96, 96, 96), cg)
    solves("cg_quad_192", testmat.poisson3d27_dia(192, 192, 192), cg)
    torch.cuda.empty_cache()
    solves("bicgstab_quad_2^20", A,
           "-i bicgstab -f quad -auto_storage false -tol 1e-12")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    _abba.main(__file__, worker, __doc__)
