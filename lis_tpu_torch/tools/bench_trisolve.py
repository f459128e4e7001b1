#!/usr/bin/env python3
"""Time kernel K (trisolve_levels) and the level-scheduled solves it
serves in this checkout beside other checkouts, on one CUDA device.

Usage:
    python3 lis_tpu_torch/tools/bench_trisolve.py [--root NAME=DIR ...]

``--root`` names another checkout of the repository (an unpacked
``git archive`` of an earlier commit) to time beside this one, each in a
process of its own, a b b a (``_abba.py``).  Correctness is
chip_smoke.py's business; its ``cuda_ms`` times the calls here.

A worker builds its checkout's kernels, prints ptxas's report for K, and
times with CUDA events (20 back-to-back calls after 3 warm-ups): K on
the level plans of poisson3d27 96³'s (D + L), in f64 and f32, and (D +
U), f64; K on the lower ILU(1) factor of poisson3d27 48³ (rows of up to
31 entries), f64; K on a bidiagonal of 20,000 rows (one level per row; 5
calls); and, on poisson3d27 64³ as CSR, the ms/iter of three "-i cg -p
ssor -auto_storage false" and three "-i sor -tol 1e-8" solves (the first
of each is a warm-up and is left out; the others are listed).  One JSON
line per worker; the card's nvidia-smi name and power limit head the
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
    from chip_smoke import cuda_ms            # this checkout's helper
    sys.path.insert(0, root)
    import numpy as np
    import scipy.sparse as sp
    import torch
    import lis_tpu_torch
    from lis_tpu_torch.ops import _cuda, trisolve as ts
    from lis_tpu_torch.utils import testmat
    if not torch.cuda.is_available():
        sys.exit("bench_trisolve: no CUDA device")
    dev = torch.device("cuda", 0)
    _cuda.lib()
    ptxas, keep = [], False
    for ln in _cuda.build_log.splitlines():
        if "Compiling entry" in ln:
            keep = "trisolve" in ln
        elif keep and ("Used" in ln or "stack frame" in ln):
            ptxas.append(ln.split(":", 1)[-1].strip())
    out = {"ptxas": ptxas, "build_s": _cuda.build_seconds}

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    p, i, v = testmat.poisson3d27(96, 96, 96, device="cpu").to_csr_arrays()
    n = len(p) - 1
    a = sp.csr_matrix((np.asarray(v), np.asarray(i), np.asarray(p)),
                      shape=(n, n))
    dinv = 1.0 / a.diagonal()
    b = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    for lower, tag in ((True, "lower"), (False, "upper")):
        tri = (sp.tril(a, -1) if lower else sp.triu(a, 1)).tocsr()
        tri.sort_indices()
        plan = ts.make_plan(tri.indptr, tri.indices, tri.data, dinv,
                            lower=lower, device=dev)
        out[f"nlev_{tag}"] = plan.nlev
        out[f"k96_{tag}_f64_ms"] = cuda_ms(lambda: ts.trisolve(plan, b))
        if lower:
            p32, b32 = plan.to(dtype=torch.float32), b.float()
            out["k96_lower_f32_ms"] = cuda_ms(lambda: ts.trisolve(p32, b32))
            del p32
        del plan
        torch.cuda.empty_cache()

    from lis_tpu_torch.precon.ilu import create_iluk
    from lis_tpu_torch.runtime.options import SolverOptions
    M = create_iluk(testmat.poisson3d27(48, 48, 48),
                    SolverOptions.from_string("-ilu_fill 1"))
    b48 = torch.randn(M.lower.n, generator=gen, device=dev,
                      dtype=torch.float64)
    out["nlev_ilu1_48"] = M.lower.nlev
    out["ilu1_48_lower_f64_ms"] = cuda_ms(
        lambda: ts.trisolve(M.lower, b48))
    del M

    nb = 20000
    hb = sp.diags(np.linspace(-0.9, 0.9, nb - 1), -1, shape=(nb, nb)).tocsr()
    plan = ts.make_plan(hb.indptr, hb.indices, hb.data, np.full(nb, 0.5),
                        device=dev)
    bb = torch.randn(nb, generator=gen, device=dev, dtype=torch.float64)
    out["bidiag_20000_ms"] = cuda_ms(lambda: ts.trisolve(plan, bb), 5)

    A = testmat.poisson3d27(64, 64, 64)
    b64 = np.ones(A.nrows)
    for opts, tag in (("-i cg -p ssor -auto_storage false", "cg_ssor"),
                      ("-i sor -tol 1e-8", "sor")):
        per_iter = []
        for _ in range(3):
            r = lis_tpu_torch.solve(A, b64, options=opts)
            if r.status != 0:
                sys.exit(f"bench_trisolve: {opts}: status {r.status}")
            per_iter.append(1e3 * r.itime / r.iters)
        out[f"{tag}_64_iters"] = r.iters
        out[f"{tag}_64_ms_per_iter"] = per_iter[1:]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    _abba.main(__file__, worker, __doc__)
