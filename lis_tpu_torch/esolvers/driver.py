"""lis_esolve / lis_gesolve: the eigensolver driver.

Port of ``lis_tpu/esolvers/driver.py`` (reference src/esolver/
lis_esolver.c: lis_esolve :263 is lis_gesolve with B = NULL :285;
registry :63-66; defaults :143-183: -e cr, -emaxiter 1000, -etol 1e-12,
-ss 1, inner esolver II).  The standard problem Ax = λx and the
generalized Ax = λBx run where A lives, the card unless the caller built
it elsewhere.  The subspace methods (SI, LI, AI) return ``ss`` pairs; the
result's getters mirror lis_esolver_get_* (include/lis.h:1004-1011).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from lis_tpu_torch.esolvers import cgcr as _cgcr           # noqa: F401
from lis_tpu_torch.esolvers import power as _power         # noqa: F401
from lis_tpu_torch.esolvers import subspace as _subspace   # noqa: F401
from lis_tpu_torch.esolvers.base import ESOLVER_FNS
from lis_tpu_torch.matrix.convert import convert_matrix
from lis_tpu_torch.runtime.options import EsolverOptions
from lis_tpu_torch.solvers.driver import (_STORAGE_BY_ID, _as_vector,
                                          auto_storage)
from lis_tpu_torch.utils.trace import traced


@dataclass
class EsolveResult:
    evalue: float                 # principal eigenvalue (mode 0)
    evector: torch.Tensor         # principal eigenvector, on A's device
    iters: int
    resid: float
    status: int
    # every computed pair (ss >= 1 for the subspace solvers), on the host
    evalues: np.ndarray = field(default=None)
    evectors: np.ndarray = field(default=None)
    iters_all: np.ndarray = field(default=None)
    resids_all: np.ndarray = field(default=None)
    rhistory: np.ndarray = field(default=None)

    def get_evalues(self):
        return self.evalues

    def get_evectors(self):
        return self.evectors

    def get_residualnorms(self):
        return self.resids_all

    def get_iters(self):
        return self.iters_all


@traced
def gesolve(A, B, options=None, x0=None, **overrides) -> EsolveResult:
    """Solve the generalized eigenproblem Ax = λBx (lis_gesolve) on A's
    device; B None is the standard problem."""
    if isinstance(options, EsolverOptions):
        opts = options
        for k, val in overrides.items():
            setattr(opts, k, val)
    else:
        opts = EsolverOptions.from_string(options, **overrides)

    # a B makes every name generalized (-e ii with a B is gii); a g-name
    # runs the standard name's function, given B
    name = opts.esolver
    if B is not None and not name.startswith("g"):
        name = "g" + name
    base = name[1:] if name.startswith("g") else name
    if base not in ESOLVER_FNS:
        raise NotImplementedError(f"eigensolver {base!r} not implemented; "
                                  f"have {sorted(ESOLVER_FNS)}")

    # -estorage: convert the operator before iterating (lis_esolver.c's
    # storage step, as lis_solve_kernel's -storage); with none, the
    # default routing (banded -> DIA, ...) of solvers/driver.py
    if opts.estorage:
        kw = ({"bnr": opts.estorage_block}
              if opts.estorage in (7, 8) else {})
        fmt = _STORAGE_BY_ID[opts.estorage]
        A = convert_matrix(A, fmt, device=A.device, **kw)
        if B is not None:
            B = convert_matrix(B, fmt, device=B.device, **kw)
    else:
        A = auto_storage(A)
        if B is not None:
            B = auto_storage(B)

    n = A.nrows
    # -initx_ones true (the default) replaces any given x0 by ones; false
    # keeps the caller's x0 (the reference's LIS_EOPTIONS_INITGUESS_ONES)
    if x0 is None or opts.initx_ones:
        x0 = torch.ones(n, dtype=A.get_diagonal().dtype, device=A.device)
    else:
        x0 = _as_vector(x0, A.device)
    res = ESOLVER_FNS[base](A, B, x0, opts)
    # -m: report the mode-th pair of a subspace run (lis_esolver.c
    # LIS_EOPTIONS_MODE; etest5 prints the chosen mode)
    if opts.mode and res.evalues is not None and len(res.evalues) > opts.mode:
        res = dataclasses.replace(
            res, evalue=float(res.evalues[opts.mode]),
            evector=torch.from_numpy(res.evectors[opts.mode]).to(A.device),
            resid=float(res.resids_all[opts.mode]))
    return res


@traced
def esolve(A, options=None, x0=None, **overrides) -> EsolveResult:
    """The standard eigenproblem Ax = λx (lis_esolve = lis_gesolve(A,
    NULL))."""
    return gesolve(A, None, options, x0, **overrides)
