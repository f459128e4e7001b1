"""gesolver — the reference's installed `gesolver` binary (= getest5b.c):
the multi-pair variant of `gesolve`.  Port of ``lis_tpu/cli/gesolver.py``.

Usage: python -m lis_tpu_torch.cli.gesolver A.mtx B.mtx [evector_file]
       [options]
"""

from __future__ import annotations

import sys

from lis_tpu_torch.cli.gesolve import main as _main


def main(argv=None, device=None):
    return _main(argv, device=device)


if __name__ == "__main__":
    sys.exit(main())
