#!/usr/bin/env python3
"""Time kernels Q (bes_spmv) and R (bes_spmvh) and the solves they serve
in this checkout beside other checkouts, on one CUDA device.

Usage:
    python3 lis_tpu_torch/tools/bench_bes.py [--root NAME=DIR ...]

``--root`` names another checkout of the repository (an unpacked
``git archive`` of an earlier commit) to time beside this one, each in a
process of its own, a b b a (``_abba.py``).  Correctness is
chip_smoke.py's business; its ``cuda_ms`` times the calls here (20
back-to-back calls after 3 warm-ups, with CUDA events).

A worker builds its checkout's kernels and prints ptxas's report for Q
and R.  It routes chip_smoke.py's windowed(2^20, 40) (seed 0) to BES with
``auto_storage`` (its wall time and the device memory the routed matrix
holds), then times Q and R as the matrix's ``matvec`` and ``matvech``
(which every checkout has, whatever its kernels' signature) at f64 and
f32 (the matrix cast by ``.to(dtype=torch.float32)``), from the device's
queue and, as ``_host_ms``, as the host enqueues each call.  It solves
CG + Jacobi on that matrix, and BiCG and BiCGSTAB + Jacobi on its
nonsymmetric twin, each with no -storage (the BES route) and with
``-storage csr``, b = 1, -tol 1e-10, three times (the first warms up and
is left out of the listed ms/iter).  Then it builds SA-AMG's graph path
(``-saamg_lattice false``) on poisson3d27 64³ and times one psolve (10
calls) and the Q + R time a psolve spends: each slab part's matvec and
matvech from the device's queue, times the launches a V-cycle makes of
it (Q and R once a part of each prolongator, Q four times a part of a BES
level operator).  One JSON line per worker; the card's nvidia-smi name
and power limit head the output.  Exits non-zero without a CUDA device
or when a solve fails.
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
    from chip_smoke import cuda_ms, windowed   # this checkout's helpers
    sys.path.insert(0, root)
    import torch
    import lis_tpu_torch
    from lis_tpu_torch.ops import _cuda
    from lis_tpu_torch.precon import saamg as psa
    from lis_tpu_torch.runtime.options import SolverOptions
    from lis_tpu_torch.utils import testmat
    if not torch.cuda.is_available():
        sys.exit("bench_bes: no CUDA device")
    dev = torch.device("cuda", 0)
    _cuda.lib()
    ptxas, keep = [], False
    for ln in _cuda.build_log.splitlines():
        if "Compiling entry" in ln:
            keep = "bes_" in ln
            name = ln.split("'")[1] if "'" in ln else ln
        elif keep and "Used" in ln:
            ptxas.append(f"{name}: {ln.split(':', 1)[-1].strip()}")
    out = {"ptxas": ptxas, "build_s": _cuda.build_seconds}
    f32, f64 = torch.float32, torch.float64
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def timed(key, fn):
        out[f"{key}_ms"] = cuda_ms(fn, queued=True)
        out[f"{key}_host_ms"] = cuda_ms(fn)

    def parts(m):
        if getattr(m, "format_name", None) not in ("bes", "mbes"):
            return ()
        return getattr(m, "parts", (m,))

    # ---- Q and R on the routed windowed(2^20, 40) -------------------------
    n = 1 << 20
    a = windowed(n, 40, 0, symmetric=True)
    A = lis_tpu_torch.CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data,
                                                a.shape)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    B = lis_tpu_torch.auto_storage(A, need_at=False)
    torch.cuda.synchronize()
    out["route_s"] = time.perf_counter() - t0
    out["route_gib"] = (torch.cuda.memory_allocated() - mem0) / 2 ** 30
    out["format"] = B.format_name
    if B.format_name != "bes":
        sys.exit(f"bench_bes: windowed(2^20, 40) routed to {B.format_name}")
    pack = getattr(B, "pack", None)
    out["compact_gib"] = None if pack is None else pack.nbytes() / 2 ** 30
    for dtype in (f64, f32):
        M = B if dtype == f64 else B.to(dtype=dtype)
        x = torch.randn(n, generator=gen, device=dev, dtype=f64).to(dtype)
        tag = str(dtype)[6:]
        timed(f"Q_{tag}", lambda: M.matvec(x))
        timed(f"R_{tag}", lambda: M.matvech(x))
        del M, x
    del B
    torch.cuda.empty_cache()

    # ---- the solves on the BES route and on -storage csr -------------------
    def solves(key, mat, opts):
        b = torch.ones(mat.nrows, dtype=f64, device=dev)
        per = []
        for _ in range(3):
            r = lis_tpu_torch.solve(mat, b, options=opts)
            if r.status != 0:
                sys.exit(f"bench_bes: {key}: status {r.status}")
            per.append(1e3 * r.itime / r.iters)
        out[f"{key}_iters"] = r.iters
        out[f"{key}_ms_per_iter"] = per[1:]

    an = windowed(n, 40, 0, symmetric=False)
    An = lis_tpu_torch.CSRMatrix.from_csr_arrays(an.indptr, an.indices,
                                                 an.data, an.shape)
    for solver, mat in (("cg", A), ("bicg", An), ("bicgstab", An)):
        opts = f"-i {solver} -p jacobi -tol 1e-10"
        solves(f"{solver}_bes", mat, opts)
        solves(f"{solver}_csr", mat, opts + " -storage csr")
    del A, An
    torch.cuda.empty_cache()

    # ---- SA-AMG graph path at 64^3: the psolve and its Q + R ---------------
    A64 = testmat.poisson3d27(64, 64, 64)
    D64 = lis_tpu_torch.auto_storage(A64)
    M = psa.create_saamg(D64, SolverOptions.from_string(
        "-i cg -p saamg -saamg_lattice false -tol 1e-10"))
    rv = torch.randn(D64.nrows, generator=gen, device=dev, dtype=f64)
    out["psolve_ms"] = cuda_ms(lambda: M.psolve(rv), reps=10)
    qr, launches = 0.0, [0, 0]
    for lv in M.levels:
        for q in parts(lv.P):
            xc = torch.randn(q.ncols, generator=gen, device=dev, dtype=f64)
            xf = torch.randn(q.nrows, generator=gen, device=dev, dtype=f64)
            qr += cuda_ms(lambda: q.matvec(xc), queued=True) + cuda_ms(
                lambda: q.matvech(xf), queued=True)
            launches[0] += 1
            launches[1] += 1
        for q in parts(lv.A):
            xc = torch.randn(q.ncols, generator=gen, device=dev, dtype=f64)
            qr += 4 * cuda_ms(lambda: q.matvec(xc), queued=True)
            launches[0] += 4
    out["psolve_qr_ms"] = qr
    out["psolve_q_r_launches"] = launches
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    _abba.main(__file__, worker, __doc__)
