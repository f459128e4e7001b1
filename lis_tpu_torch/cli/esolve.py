"""esolve / gesolve — the eigenproblem command line (the reference's
`esolve` = etest5.c and `gesolve` = getest5.c binaries; doc/man/man1/
esolve.1).  Port of ``lis_tpu/cli/esolve.py``.

Usage: python -m lis_tpu_torch.cli.esolve matrix_file [evector_file]
       [options]
       python -m lis_tpu_torch.cli.esolve A.mtx B.mtx --general [options]

The eigensolve runs on the default device, the card; ``main(argv,
device="cpu")`` asks for the host.
"""

from __future__ import annotations

import sys


def main(argv=None, general: bool = False, device=None):
    import lis_tpu_torch
    from lis_tpu_torch import esolve, gesolve, read_matrix_market
    from lis_tpu_torch.io.mm import write_vector_mm

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print("Usage: esolve matrix_filename [evector_filename] [options]")
        return 1
    argv = [a for a in argv if a != "--general"]
    k = 0
    while k < len(argv) and not argv[k].startswith("-"):
        k += 1
    files, options = argv[:k], " ".join(argv[k:])

    if general and len(files) < 2:
        # getest5 prints its usage and exits when B is missing: solving
        # the standard problem instead would mislabel the results
        print("Usage: gesolve matrix_a_filename matrix_b_filename "
              "[evector_filename] [options]")
        return 1

    lis_tpu_torch.initialize(argv)
    A = read_matrix_market(files[0], device=device)
    if general:
        B = read_matrix_market(files[1], device=device)
        res = gesolve(A, B, options=options or None)
        out = files[2] if len(files) > 2 else None
    else:
        res = esolve(A, options=options or None)
        out = files[1] if len(files) > 1 else None

    mode = "gesolve" if general else "esolve"
    print(f"{mode}: eigenvalue           = {res.evalue:.15e}")
    print(f"{mode}: number of iterations = {res.iters}")
    print(f"{mode}: relative residual    = {res.resid:e}")
    if res.evalues is not None and len(res.evalues) > 1:
        for k, (ev, rr) in enumerate(zip(res.evalues, res.resids_all)):
            print(f"  mode {k}: evalue = {ev:.15e}  resid = {rr:e}")
    if out:
        write_vector_mm(out, res.evector)
    return 0 if res.status == lis_tpu_torch.LIS_SUCCESS else res.status


if __name__ == "__main__":
    sys.exit(main(general="--general" in sys.argv))
