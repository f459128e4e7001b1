"""Status codes, matrix type ids and timing.

Port of ``lis_tpu/config.py``: the same numeric status codes and matrix
ids (the reference's include/lis.h:1052-1063, :252-284) so tooling that
matches on them works against either package.  There is no precision
switch: torch tensors carry their own dtype, and the solver driver keeps
the dtype of the right-hand side.

The default device is the card.  Every constructor that builds a matrix
from host arrays takes ``device=None``, meaning ``default_device()``, which
is ``cuda`` until ``set_default_device`` changes it.  Nothing asks
``torch.cuda.is_available()`` to choose a device and nothing falls back to
the CPU: on a machine without a card torch's own error surfaces, and a
caller who wants the CPU says ``device="cpu"``.
"""

from __future__ import annotations

import time

import torch

# Status codes (values match the reference's include/lis.h).
LIS_SUCCESS = 0
LIS_FAILS = -1
LIS_ILL_OPTION = 1
LIS_ERR_ILL_ARG = 1          # alias (lis.h:1057 — same value as ILL_OPTION)
LIS_BREAKDOWN = 2
LIS_OUT_OF_MEMORY = 3
LIS_MAXITER = 4
LIS_ERR_NOT_IMPLEMENTED = 5
LIS_ERR_FILE_IO = 6

# Matrix type ids (include/lis.h:252-284).
LIS_MATRIX_CSR = 1
LIS_MATRIX_CSC = 2
LIS_MATRIX_MSR = 3
LIS_MATRIX_DIA = 4
LIS_MATRIX_ELL = 5
LIS_MATRIX_JAD = 6
LIS_MATRIX_BSR = 7
LIS_MATRIX_BSC = 8
LIS_MATRIX_VBR = 9
LIS_MATRIX_COO = 10
LIS_MATRIX_DNS = 11
LIS_MATRIX_RCO = 255

MATRIX_TYPE_NAMES = {
    LIS_MATRIX_CSR: "csr", LIS_MATRIX_CSC: "csc", LIS_MATRIX_MSR: "msr",
    LIS_MATRIX_DIA: "dia", LIS_MATRIX_ELL: "ell", LIS_MATRIX_JAD: "jad",
    LIS_MATRIX_BSR: "bsr", LIS_MATRIX_BSC: "bsc", LIS_MATRIX_VBR: "vbr",
    LIS_MATRIX_COO: "coo", LIS_MATRIX_DNS: "dns", LIS_MATRIX_RCO: "rco",
}

_cmd_args: list[str] = []

_default_device = torch.device("cuda")


def default_device() -> torch.device:
    """The device a constructor builds on when it is given none."""
    return _default_device


def set_default_device(device) -> torch.device:
    """Make ``device`` the default; returns the previous default."""
    global _default_device
    prev, _default_device = _default_device, torch.device(device)
    return prev


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, the default for None."""
    return _default_device if device is None else torch.device(device)


def initialize(argv: list[str] | None = None) -> int:
    """Record ``argv`` so ``SolverOptions.from_string(include_cmdline=True)``
    can read ``-i``/``-p``/... flags from the command line, like the
    reference's lis_solver_set_optionC."""
    global _cmd_args
    if argv:
        _cmd_args = list(argv)
    return LIS_SUCCESS


def finalize() -> int:
    """Analogue of lis_finalize (lis_tpu config.py:81): there is no MPI
    to tear down, so nothing to do."""
    return LIS_SUCCESS


def get_cmd_args() -> list[str]:
    return _cmd_args


def wtime() -> float:
    """Wall-clock timer (analogue of lis_wtime, src/system/lis_time.c:63)."""
    return time.perf_counter()
