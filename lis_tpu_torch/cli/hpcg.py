"""hpcg_kernel — HPCG-style benchmark solve.  Port of
``lis_tpu/cli/hpcg.py``.

Reference: test/test3b.c (installed as hpcg_kernel, doc/man/man1/
hpcg_kernel.1): CG + SSOR(+additive Schwarz) on the 27-point 3-D Poisson
operator with diag 26 / off-diag -1 (test3b.c:127,172).  The default
options are ``-i cg -p ssor -adds true``: the operator is routed to DIA,
SSOR runs as relaxed sweeps of its triangles (kernel H) inside additive
Schwarz, and CG takes the fused step.

Usage: python -m lis_tpu_torch.cli.hpcg l m n [options]

The solve runs on the default device, the card; ``main(argv,
device="cpu")`` asks for the host.
"""

from __future__ import annotations

import sys

import torch


def main(argv=None, device=None):
    import lis_tpu_torch
    from lis_tpu_torch import solve
    from lis_tpu_torch.utils.testmat import poisson3d27, poisson3d27_dia

    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 3:
        print("Usage: hpcg_kernel l m n [options]")
        return 1
    l, m, n = int(argv[0]), int(argv[1]), int(argv[2])
    options = " ".join(argv[3:])
    # the reference defaults hpcg to CG + SSOR + additive Schwarz
    if "-i" not in options:
        options = "-i cg " + options
    if "-p" not in options:
        options = "-p ssor -adds true " + options

    lis_tpu_torch.initialize(argv)
    if l * m * n > 1_000_000:
        # direct DIA construction: O(27N) memory and no host CSR
        A = poisson3d27_dia(l, m, n, device=device)
    else:
        A = poisson3d27(l, m, n, device=device)
    b = A.matvec(torch.ones(A.nrows, dtype=torch.float64, device=A.device))
    res = solve(A, b, options=options)
    gn = A.nrows
    print(f"matrix size = {gn} x {gn} ({A.nnz} nonzero entries)")
    print(f"linear solver         : {res.options.solver.upper()}")
    print(f"preconditioner        : {res.options.precon}"
          f"{' + adds' if res.options.adds else ''}")
    print(f"number of iterations  = {res.iters}")
    print(f"elapsed time          = {res.time:e} sec.")
    print(f"relative residual     = {res.resid:e}")
    err = float(torch.max(torch.abs(res.x - 1.0)))
    print(f"max abs error vs ones = {err:e}")
    return 0 if res.status == lis_tpu_torch.LIS_SUCCESS else res.status


if __name__ == "__main__":
    sys.exit(main())
