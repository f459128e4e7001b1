"""esolver — the reference's installed `esolver` binary (= etest5b.c): the
multi-pair variant of `esolve`.  This driver prints every computed pair,
so it differs from esolve only in its name.  Port of
``lis_tpu/cli/esolver.py``.

Usage: python -m lis_tpu_torch.cli.esolver matrix.mtx [evector_file]
       [options]
"""

from __future__ import annotations

import sys

from lis_tpu_torch.cli.esolve import main as _main


def main(argv=None, device=None):
    return _main(argv, device=device)


if __name__ == "__main__":
    sys.exit(main())
