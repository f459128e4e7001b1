"""lis_tpu_torch — the PyTorch + CUDA port of lis_tpu.

A second package beside ``lis_tpu`` (the JAX reference, which stays as it
is).  It imports torch, numpy and scipy, never jax or lis_tpu.  Formats
and preconditioners are frozen dataclasses of tensors with ``.to(device)``;
solvers are plain functions on tensors.  A matrix built from host arrays
lives on the default device, the card (``device="cpu"`` or
``set_default_device`` asks for another), and ``solve`` runs where its
matrix lives.  Every Pallas kernel on a ported path is a hand-written
CUDA kernel for Hopper (``csrc/``), built with nvcc at first use.

Ported so far: the CG/CR + Jacobi solve over CSR and the locality-free
CST SpMV (``-storage cst``), at ``-f double`` and ``-f single``.
"""

from lis_tpu_torch.config import (
    LIS_SUCCESS,
    LIS_FAILS,
    LIS_ILL_OPTION,
    LIS_BREAKDOWN,
    LIS_OUT_OF_MEMORY,
    LIS_MAXITER,
    LIS_ERR_NOT_IMPLEMENTED,
    LIS_ERR_FILE_IO,
    wtime,
    default_device,
    set_default_device,
)
from lis_tpu_torch.runtime.options import SolverOptions
from lis_tpu_torch.matrix.csr import CSRMatrix
from lis_tpu_torch.matrix.cst import CSTMatrix
from lis_tpu_torch.matrix.convert import convert_matrix
from lis_tpu_torch.solvers.driver import solve, SolveResult

__version__ = "0.1.0"

__all__ = [
    "LIS_SUCCESS", "LIS_FAILS", "LIS_ILL_OPTION", "LIS_BREAKDOWN",
    "LIS_OUT_OF_MEMORY", "LIS_MAXITER", "LIS_ERR_NOT_IMPLEMENTED",
    "LIS_ERR_FILE_IO", "wtime", "default_device", "set_default_device",
    "SolverOptions", "CSRMatrix", "CSTMatrix", "convert_matrix",
    "solve", "SolveResult",
]
