#!/usr/bin/env python3
"""Time kernels J (lattice_prolong) and L (lattice_restrict) and the
SA-AMG solves they serve in this checkout beside other checkouts, on one
CUDA device.

Usage:
    python3 lis_tpu_torch/tools/bench_amg.py [--root NAME=DIR ...]

``--root`` names another checkout of the repository (an unpacked
``git archive`` of an earlier commit) to time beside this one, each in a
process of its own, a b b a (``_abba.py``).  Correctness is
chip_smoke.py's business; its ``cuda_ms`` times the calls here.

A worker builds its checkout's kernels and prints ptxas's report for J
and L.  For N = 96 and 192 it builds the SA-AMG preconditioner of
poisson3d27 N³ (in DIA on the card, ``-tol 1e-10``) with
``create_saamg`` (its wall time and the device memory it adds), then
times with CUDA events (20 back-to-back calls after 3 warm-ups) J and L
on the finest level, in f64 and, at the first size, f32 (from the
device's queue, and as the host enqueues each call: ``_host_ms``), and
one psolve (10 calls); then solves CG + SA-AMG with b = 1 three times
with the prebuilt preconditioner (the first is a warm-up and is left out
of the listed ms/iter).  The worker calls J and L with the signature of
its checkout: (transfer, ...) over the assembled P, or (A, dinv, tent,
...) for the implicit form of earlier commits.  One JSON line per
worker; the card's nvidia-smi name and power limit head the output.
Exits non-zero without a CUDA device or when a solve fails.
"""

from __future__ import annotations

import json
import os
import sys
import time

import _abba              # the a b b a runner, beside this file

_HERE = os.path.abspath(__file__)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))


def worker(root: str) -> None:
    sys.path.insert(0, _ROOT)
    from chip_smoke import cuda_ms            # this checkout's helper
    sys.path.insert(0, root)
    import torch
    import lis_tpu_torch
    from lis_tpu_torch.ops import _cuda, amg
    from lis_tpu_torch.precon import saamg as psa
    from lis_tpu_torch.runtime.options import SolverOptions
    from lis_tpu_torch.utils import testmat
    if not torch.cuda.is_available():
        sys.exit("bench_amg: no CUDA device")
    dev = torch.device("cuda", 0)
    _cuda.lib()
    ptxas, keep = [], False
    for ln in _cuda.build_log.splitlines():
        if "Compiling entry" in ln:
            keep = "prolong" in ln or "restrict" in ln
        elif keep and ("Used" in ln or "stack frame" in ln):
            ptxas.append(ln.split(":", 1)[-1].strip())
    out = {"ptxas": ptxas, "build_s": _cuda.build_seconds}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    opts = "-i cg -p saamg -tol 1e-10"

    def transfers(lv, dtype):
        """J and L of the level ``lv`` in its checkout's signature."""
        if hasattr(lv, "transfer"):
            T = lv.transfer.to(dtype=dtype)
            return (lambda ec, x: amg.lattice_prolong(T, ec, x),
                    lambda r: amg.lattice_restrict(T, r), T.nc)
        A, dinv, tent = (lv.A.to(dtype=dtype), lv.dinv.to(dtype),
                         lv.tent.to(dtype=dtype))
        return (lambda ec, x: amg.lattice_prolong(A, dinv, tent, ec, x),
                lambda r: amg.lattice_restrict(A, dinv, tent, r),
                tent.wc.shape[0])

    for k, g in enumerate((96, 192)):
        D = testmat.poisson3d27_dia(g, g, g)
        b = torch.ones(D.nrows, dtype=torch.float64, device=dev)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        M = psa.create_saamg(D, SolverOptions.from_string(opts))
        torch.cuda.synchronize()
        out[f"setup_{g}_s"] = time.perf_counter() - t0
        out[f"setup_{g}_device_mib"] = (torch.cuda.memory_allocated()
                                        - mem0) / 2 ** 20
        lv = M.levels[0]
        for dtype in (torch.float64, torch.float32)[:2 if k == 0 else 1]:
            J, L, nc = transfers(lv, dtype)
            x = torch.randn(D.nrows, generator=gen, device=dev,
                            dtype=torch.float64).to(dtype)
            ec = x[:nc].clone()
            tag = f"{g}_{str(dtype)[6:]}"
            for name, fn in (("J", lambda: J(ec, x)), ("L", lambda: L(x))):
                out[f"{name}_{tag}_ms"] = cuda_ms(fn, queued=True)
                out[f"{name}_{tag}_host_ms"] = cuda_ms(fn)
            del J, L, x, ec
        r = torch.randn(D.nrows, generator=gen, device=dev,
                        dtype=torch.float64)
        out[f"psolve_{g}_ms"] = cuda_ms(lambda: M.psolve(r), 10)
        per_iter = []
        for _ in range(3):
            res = lis_tpu_torch.solve(D, b, options=opts, M=M)
            if res.status != 0:
                sys.exit(f"bench_amg: {g}^3: status {res.status}")
            per_iter.append(1e3 * res.itime / res.iters)
        out[f"iters_{g}"] = res.iters
        out[f"ms_per_iter_{g}"] = per_iter[1:]
        del M, D, b, r, lv
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    _abba.main(__file__, worker, __doc__)
