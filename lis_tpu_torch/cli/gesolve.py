"""gesolve — the generalized eigenproblem command line (the reference's
installed `gesolve` = getest5.c; doc/man/man1/gesolve.1): esolve's driver
with the pencil path forced.  Port of ``lis_tpu/cli/gesolve.py``.

Usage: python -m lis_tpu_torch.cli.gesolve A.mtx B.mtx [evector_file]
       [options]
"""

from __future__ import annotations

import sys

from lis_tpu_torch.cli.esolve import main as _main


def main(argv=None, device=None):
    return _main(argv, general=True, device=device)


if __name__ == "__main__":
    sys.exit(main())
