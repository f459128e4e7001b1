"""lsolve — solve Ax=b from a file (the reference's installed `lsolve`
binary = test/test1.c; see doc/man/man1/lsolve.1).  Port of
``lis_tpu/cli/lsolve.py``.

Usage: python -m lis_tpu_torch.cli.lsolve matrix_filename rhs_setting
       [solution_filename] [rhistory_filename] [options]

rhs_setting: 0 = use the rhs bundled in the file (or b = A·1 if absent),
1 = all ones, 2 = b = A·1, or a filename of a MatrixMarket vector.

The solve runs on the default device, the card; ``main(argv,
device="cpu")`` asks for the host.
"""

from __future__ import annotations

import sys

import torch


def main(argv=None, device=None):
    import lis_tpu_torch
    from lis_tpu_torch import solve
    from lis_tpu_torch.io import lis_input, lis_input_vector
    from lis_tpu_torch.io.mm import write_vector_mm

    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print("Usage: lsolve matrix_filename rhs_setting "
              "[solution_filename] [rhistory_filename] [options]")
        return 1
    path, rhs = argv[0], argv[1]
    opt_start = 2
    while opt_start < len(argv) and not argv[opt_start].startswith("-"):
        opt_start += 1
    # positional filenames stop at the first option token — option VALUES
    # are not filenames
    pos = argv[2:opt_start][:2]
    options = " ".join(argv[opt_start:])

    lis_tpu_torch.initialize(argv)
    A, b, _ = lis_input(path, device=device)

    def ones():
        return torch.ones(A.nrows, dtype=torch.float64, device=A.device)

    if rhs == "1":
        b = ones()
    elif rhs == "2":
        b = A.matvec(ones())
    elif rhs == "0":
        if b is None:                   # no rhs bundled in the file
            b = A.matvec(ones())
    else:
        b = lis_input_vector(rhs, device=A.device)

    kw = {} if "-print" in options else {"print_": 2}
    res = solve(A, b, options=options or None, **kw)
    print(f"{res.options.solver.upper()}: number of iterations = {res.iters}")
    print(f"{res.options.solver.upper()}: relative residual    = "
          f"{res.resid:e}")
    if len(pos) >= 1:
        write_vector_mm(pos[0], res.x)
    if len(pos) >= 2:
        with open(pos[1], "w") as f:
            for i, r in enumerate(res.rhistory):
                f.write(f"{i} {r:e}\n")
    return 0 if res.status == lis_tpu_torch.LIS_SUCCESS else res.status


if __name__ == "__main__":
    sys.exit(main())
