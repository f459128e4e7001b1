"""lis_tpu_torch — the PyTorch + CUDA port of lis_tpu.

A second package beside ``lis_tpu`` (the JAX reference, which stays as it
is).  It imports torch, numpy and scipy, never jax or lis_tpu.  Formats
and preconditioners are frozen dataclasses of tensors with ``.to(device)``;
solvers are plain functions on tensors.  A matrix built from host arrays
lives on the default device, the card (``device="cpu"`` or
``set_default_device`` asks for another), and ``solve`` runs where its
matrix lives.  Every Pallas kernel on a ported path is a hand-written
CUDA kernel for Hopper (``csrc/``), built with nvcc at first use.

Ported so far: all of lis_tpu's single-device surface.  ``solve()``
with all 25 of lis_tpu's solvers (cg, cr, bicg, bicr, cgs, crs, bicgstab,
bicrstab, bicgstabl, gpbicg, gpbicr, bicgsafe, bicrsafe, tfqmr, orthomin,
gmres, fgmres, idrs, idr1, minres, cocg, cocr, jacobi, gs, sor); all
eleven preconditioners (none, jacobi, bjacobi, ssor, ilu, ilut, iluc, is,
sainv, saamg, hybrid), with additive Schwarz around them (``-adds
true``); all six precision modes, ``-f double``, ``single`` and the
double-double ``quad``, ``switch``, ``df`` and ``switch_df`` (lis_tpu's
17 ``_quad`` twins); ``-reorder rcm`` and ``-use_at``; every storage
format of lis_tpu: the scalar formats CSR, COO, CSC, MSR, ELL, JAD, DNS,
DIA and HDI, the block formats BSR, BSC and VBR (block ILU, block Jacobi,
``-scale 1 -storage bsr``), and BES, multi-BES, CSS and CST, routed by
``auto_storage`` as in lis_tpu (banded → DIA, general banded sparsity →
BES) unless ``-storage`` says otherwise; ``MatrixAssembler``
(lis_matrix_set_value / lis_matrix_assemble); MatrixMarket (ASCII and
binary), Harwell-Boeing, Lis native and PLAIN I/O; ``esolve()`` and
``gesolve()`` with all eight of lis_tpu's eigensolvers (pi, ii, rqi, cg,
cr, si, li, ai) and their generalized forms (gpi, ..., gai) for Ax = λx
and Ax = λBx; the lis.h compatibility layer (``lis_tpu_torch.compat``:
handles, ``lis_array_*``, the raw-layout ``lis_matrix_set_*``, PSD, user
preconditioners), the scipy bindings (``lis_tpu_torch.interop``), the
integer-handle flat API with its Fortran/C shim and drivers
(``interop/fapi.py``, ``_native/lisf_tpu.c``, built by
``_native/lisf.py``), checkpoint/resume and profiling
(``utils/checkpoint.py``, ``utils/profiling.py``); the ``lsolve``,
``hpcg``, ``esolve``, ``esolver``, ``gesolve``, ``gesolver`` and
``spmvtest`` command lines (``python -m lis_tpu_torch.cli.hpcg 96 96
96``); the distributed linear solve (``lis_tpu_torch.parallel``: one
process per rank over ``torch.distributed``, ``launch`` / ``RankPool``,
the sharded DIA, CSR (gather, neighbour and comm-table halos), CST, BES,
multi-BES and hybrid operators, ``dist_solve`` at every precision with
the block-local preconditioners, hybrid and SA-AMG, and ``dist_esolve``
with all eight eigensolvers and their generalized forms) and the scaling
harness (``cli/scaling.py``).  Every module of lis_tpu has its
counterpart here.
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
    initialize,
    finalize,
    default_device,
    set_default_device,
)
from lis_tpu_torch.runtime.options import SolverOptions, EsolverOptions
from lis_tpu_torch.matrix.base import SparseMatrix
from lis_tpu_torch.matrix.csr import CSRMatrix
from lis_tpu_torch.matrix.coo import COOMatrix
from lis_tpu_torch.matrix.csc import CSCMatrix
from lis_tpu_torch.matrix.msr import MSRMatrix
from lis_tpu_torch.matrix.ell import ELLMatrix
from lis_tpu_torch.matrix.jad import JADMatrix
from lis_tpu_torch.matrix.dns import DNSMatrix
from lis_tpu_torch.matrix.bsr import BSRMatrix
from lis_tpu_torch.matrix.bsc import BSCMatrix
from lis_tpu_torch.matrix.vbr import VBRMatrix
from lis_tpu_torch.matrix.bes import (BESMatrix, MultiBESMatrix,
                                      multi_bes_from_csr)
from lis_tpu_torch.matrix.cst import CSTMatrix
from lis_tpu_torch.matrix.dia import DIAMatrix
from lis_tpu_torch.matrix.hybrid import HybridMatrix
from lis_tpu_torch.matrix.css import CSSMatrix
from lis_tpu_torch.matrix.convert import convert_matrix
from lis_tpu_torch.matrix.assembly import (MatrixAssembler, LIS_INS_VALUE,
                                           LIS_ADD_VALUE)
from lis_tpu_torch.ops.spmv import matvec, matvech
from lis_tpu_torch.solvers.driver import (solve, SolveResult, auto_storage,
                                          transform_operator,
                                          SOLVER_REGISTRY)
from lis_tpu_torch.esolvers.driver import esolve, gesolve, EsolveResult
from lis_tpu_torch.io import (read_matrix_market, write_matrix_market,
                              read_vector_mm, lis_input, lis_input_vector,
                              lis_output, lis_output_vector,
                              read_harwell_boeing, write_harwell_boeing,
                              read_lis_file, write_lis_file)
from lis_tpu_torch.utils.trace import set_debug_trace, debug_trace_enabled

__version__ = "0.1.0"

__all__ = [
    "LIS_SUCCESS", "LIS_FAILS", "LIS_ILL_OPTION", "LIS_BREAKDOWN",
    "LIS_OUT_OF_MEMORY", "LIS_MAXITER", "LIS_ERR_NOT_IMPLEMENTED",
    "LIS_ERR_FILE_IO", "wtime", "initialize", "finalize", "default_device",
    "set_default_device", "SolverOptions", "EsolverOptions", "SparseMatrix",
    "CSRMatrix",
    "COOMatrix", "CSCMatrix", "MSRMatrix", "ELLMatrix", "JADMatrix",
    "DNSMatrix", "BSRMatrix", "BSCMatrix", "VBRMatrix", "BESMatrix",
    "MultiBESMatrix", "multi_bes_from_csr", "CSTMatrix", "DIAMatrix",
    "HybridMatrix", "CSSMatrix",
    "convert_matrix", "MatrixAssembler", "LIS_INS_VALUE", "LIS_ADD_VALUE",
    "matvec", "matvech",
    "solve", "SolveResult", "SOLVER_REGISTRY", "auto_storage",
    "transform_operator",
    "esolve", "gesolve", "EsolveResult",
    "read_matrix_market", "write_matrix_market", "read_vector_mm",
    "lis_input", "lis_input_vector", "lis_output", "lis_output_vector",
    "read_harwell_boeing", "write_harwell_boeing", "read_lis_file",
    "write_lis_file", "set_debug_trace", "debug_trace_enabled",
]
