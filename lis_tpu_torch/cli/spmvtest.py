"""spmvtest1-5 — per-format SpMV benchmark sweep.

Port of ``lis_tpu/cli/spmvtest.py``.  Reference: test/spmvtest1.c (1-D
tridiag), spmvtest2/2b (2-D 5-pt), spmvtest3/3b (3-D 7-pt/27-pt),
spmvtest4 (file list), spmvtest5 (one file); metric MFLOPS =
2·nnz·iter/comptime (spmvtest1.c:225).

Usage:
  python -m lis_tpu_torch.cli.spmvtest 1 n iter
  python -m lis_tpu_torch.cli.spmvtest 2 m n iter
  python -m lis_tpu_torch.cli.spmvtest 3 l m n iter        (7-point)
  python -m lis_tpu_torch.cli.spmvtest 3b l m n iter       (27-point)
  python -m lis_tpu_torch.cli.spmvtest 4 list_file iter
  python -m lis_tpu_torch.cli.spmvtest 5 matrix.mtx iter

The sweep runs on the default device, the card; ``main(argv,
device="cpu")`` asks for the host.  Each format's time per product is
that of a loop of ``v = A·v / 4`` products: two loop lengths, each the
best of three runs, differenced, timed with CUDA events on the card and
the host clock on the CPU.
"""

from __future__ import annotations

import sys
import time

import torch

FORMATS = ["csr", "csc", "msr", "dia", "ell", "jad", "bsr", "bsc", "vbr",
           "coo", "dns",
           # lis_tpu's extensions: hybrid DIA+remainder and dense
           # sliding slabs for general sparsity
           "hdi", "bes"]


def _loop(A, x, k: int) -> torch.Tensor:
    v = x
    for _ in range(k):
        v = A.matvec(v) * 0.25
    return v


def _seconds(A, x, k: int) -> float:
    """Wall of one loop of k products, the device's work included."""
    if x.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        _loop(A, x, k)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e-3
    t0 = time.perf_counter()
    _loop(A, x, k)
    return time.perf_counter() - t0


def run_sweep(A0, iters: int, formats=None, dense_ok=True):
    """Time A·x in each format of ``formats`` (None: all of FORMATS) on
    A0's device; print a row each and return {format: MFLOPS}."""
    from lis_tpu_torch.matrix.convert import convert_matrix

    n, nnz = A0.nrows, A0.nnz
    x = torch.ones(n, dtype=torch.float64, device=A0.device)
    print(f"matrix size = {n} x {A0.ncols} ({nnz} nonzero entries)\n")
    results = {}
    for fmt in (formats or FORMATS):
        if fmt == "dns" and (not dense_ok or n > 20000):
            continue
        try:
            A = convert_matrix(A0, fmt, device=A0.device)
        except Exception as e:
            print(f"{fmt:4s}: conversion failed ({e})")
            continue

        # two loop lengths differenced: cancels the fixed cost of a run
        la, lb = max(1, iters // 10), iters + max(1, iters // 10)
        _seconds(A, x, la)                 # warm-up
        _seconds(A, x, lb)

        def best(k):
            return min(_seconds(A, x, k) for _ in range(3))

        t = (best(lb) - best(la)) / (lb - la)
        if t <= 0:
            # below timer noise — bound by the whole-loop time instead
            t = best(lb) / lb
        mflops = 2.0 * nnz / t / 1e6
        results[fmt] = mflops
        print(f"format = {fmt.upper():4s} ({FORMATS.index(fmt)+1:2d}), "
              f"computation = {t:.6e} sec, {mflops:10.2f} MFLOPS")
    return results


def main(argv=None, device=None):
    import lis_tpu_torch
    from lis_tpu_torch.utils.testmat import (poisson2d, poisson3d,
                                             poisson3d27, tridiag)

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    which = argv[0]
    lis_tpu_torch.initialize(argv)
    if which == "1":
        n, iters = int(argv[1]), int(argv[2])
        A = tridiag(n, device=device)
    elif which in ("2", "2b"):
        m, n, iters = int(argv[1]), int(argv[2]), int(argv[3])
        A = poisson2d(m, n, device=device)
    elif which == "3":
        l, m, n, iters = (int(a) for a in argv[1:5])
        A = poisson3d(l, m, n, device=device)
    elif which == "3b":
        l, m, n, iters = (int(a) for a in argv[1:5])
        A = poisson3d27(l, m, n, device=device)
    elif which == "4":
        # reference spmvtest4: argv[1] is a list file, one matrix path per
        # line (test/spmvtest4.c); run the sweep on each
        from lis_tpu_torch.io import lis_input
        iters = int(argv[2])
        with open(argv[1]) as f:
            paths = [ln.strip() for ln in f if ln.strip()]
        for p in paths:
            print(f"\n=== {p} ===")
            A, _, _ = lis_input(p, device=device)
            run_sweep(A, iters)
        return 0
    elif which == "5":
        from lis_tpu_torch.io import lis_input
        A, _, _ = lis_input(argv[1], device=device)
        iters = int(argv[2])
    else:
        print(__doc__)
        return 1
    run_sweep(A, iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
