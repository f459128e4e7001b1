"""lis_solve-equivalent driver.

Port of ``lis_tpu/solvers/driver.py::solve`` (reference lis_solve /
lis_solve_kernel, src/solver/lis_solver.c:367,441-953): option parsing,
scaling (none/jacobi/symm_diag with the CG+Jacobi upgrade at :702-705),
``-storage`` conversion, preconditioner creation, registry dispatch,
residual history, true-residual recomputation (:910-924) and per-phase
timing.

The solve runs on the device that holds the matrix's tensors; ``b`` and
``x0`` are moved there.  A matrix built by the port's constructors lives
on the default device, the card, unless its caller asked for another.
What lis_tpu does and this package does not yet raises
``NotImplementedError`` naming the ROADMAP.md item that ports it.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import torch

from lis_tpu_torch import config as C
from lis_tpu_torch.core import vector as v
from lis_tpu_torch.matrix.base import SparseMatrix
from lis_tpu_torch.matrix.convert import convert_matrix
from lis_tpu_torch.precon.base import (PRECON_REGISTRY, NonePrecon,
                                       create_precon)
from lis_tpu_torch.precon import jacobi as _pjac          # noqa: F401
from lis_tpu_torch.runtime.options import SolverOptions, STORAGE_NAMES
from lis_tpu_torch.solvers.base import SOLVER_FNS, SolverSpec
from lis_tpu_torch.solvers import bicg as _bicg           # noqa: F401
from lis_tpu_torch.solvers import bicgstab as _bicgstab   # noqa: F401
from lis_tpu_torch.solvers import cg as _cg               # noqa: F401
from lis_tpu_torch.solvers import cocg as _cocg           # noqa: F401
from lis_tpu_torch.utils.trace import traced

_STORAGE_BY_ID = {i: n for n, i in STORAGE_NAMES.items()}


@dataclass
class SolveResult:
    x: torch.Tensor
    status: int
    iters: int
    resid: float              # final (recursive) relative residual
    true_resid: float         # ||b - Ax|| / ||b|| on the unscaled system
    rhistory: np.ndarray      # relative residuals, [0] = initial
    time: float               # total solve time (s)
    itime: float              # iteration time (s)
    ptime: float              # preconditioner-creation time (s)
    options: SolverOptions

    def __repr__(self):
        names = {C.LIS_SUCCESS: "SUCCESS", C.LIS_MAXITER: "MAXITER",
                 C.LIS_BREAKDOWN: "BREAKDOWN"}
        return (f"SolveResult({self.options.solver}+{self.options.precon}: "
                f"{names.get(self.status, self.status)}, iters={self.iters}, "
                f"resid={self.resid:.6e})")


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to lis_tpu_torch yet (ROADMAP.md {item})")


def _check_ported(opts: SolverOptions) -> None:
    if opts.solver not in SOLVER_FNS:
        raise _not_ported(f"solver {opts.solver!r}",
                          "queue 1 item 6 (remaining Krylov solvers)")
    if opts.precon not in ("none",) + tuple(PRECON_REGISTRY):
        raise _not_ported(f"preconditioner {opts.precon!r}",
                          "queue 1 items 5 and 9 (preconditioners)")
    if opts.precision not in ("double", "single"):
        raise _not_ported(f"-f {opts.precision}",
                          "queue 1 item 7 (precision modes)")
    if opts.reorder == "rcm":
        raise _not_ported("-reorder rcm", "queue 1 item 8")
    if opts.use_at:
        raise _not_ported("-use_at", "queue 1 item 8")
    if opts.adds:
        raise _not_ported("-adds (additive Schwarz)", "queue 1 item 9")
    if not opts.storage and opts.auto_storage:
        raise _not_ported(
            "auto_storage (DIA/HDI/BES/CST routing); pass -storage or "
            "-auto_storage false", "queue 1 item 2")


def _make_spec(opts: SolverOptions) -> SolverSpec:
    return SolverSpec(solver=opts.solver, tol=opts.tol, tol_w=opts.tol_w,
                      maxiter=opts.maxiter, conv_cond=opts.conv_cond,
                      live_print=bool(opts.print_ & 2))


def _effective_scale(opts) -> int:
    """The scale mode solve() runs (lis_solve_kernel :613-721): CG+Jacobi
    upgrades -scale 1 to symmetric scaling (lis_solver.c:702-705).  The
    I+S and block-Jacobi (-storage bsr) branches of lis_tpu come with
    their preconditioner and format."""
    if opts.scale == 1 and opts.solver == "cg" and opts.precon == "jacobi":
        return 2
    return opts.scale


def _scale_operator(A, scale):
    """Scale A per mode; returns (A', svec) where svec also multiplies b
    (and divides x0 for the symmetric mode)."""
    if scale not in (1, 2):
        return A, None
    d = A.get_diagonal()
    one = torch.ones_like(d)
    if scale == 1:
        nz = d != 0
        s = torch.where(nz, 1.0 / torch.where(nz, d, one), one)
        return A.scale_rows(s), s
    # d > 0 in numpy's (lexicographic) order, which jnp follows for
    # complex values; torch has no order on complex tensors
    pos = (d.real > 0) | ((d.real == 0) & (d.imag > 0)) if d.is_complex() \
        else d > 0
    nz = d != 0
    s = torch.where(pos, 1.0 / torch.sqrt(torch.where(pos, d, one)),
                    torch.where(nz, 1.0 / torch.sqrt(torch.abs(
                        torch.where(nz, d, one))), one))
    return A.scale_symm(s), s


def _convert_storage(A, opts):
    if opts.storage:
        return convert_matrix(A, _STORAGE_BY_ID[opts.storage],
                              device=A.device)
    return A


def _cast32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32) if t.dtype == torch.float64 else t


def _as_vector(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@traced
def solve(A: SparseMatrix, b, x0=None, options=None, M=None,
          **overrides) -> SolveResult:
    """Solve Ax = b (the lis_solve equivalent) on A's device.

    ``options`` may be a SolverOptions, an option string
    (e.g. ``"-i cg -p jacobi -storage cst -tol 1e-10"``), or None."""
    if isinstance(options, SolverOptions):
        opts = options
        for k, val in overrides.items():
            setattr(opts, k, val)
    else:
        opts = SolverOptions.from_string(options, **overrides)
    _check_ported(opts)

    t_total = C.wtime()
    device = A.device
    b = _as_vector(b, device)
    b0 = b
    A0 = A
    n = A.nrows
    if x0 is None or opts.initx_zeros:
        x0 = torch.zeros_like(b)
    else:
        x0 = _as_vector(x0, device)

    # ---- scaling (lis_solve_kernel :613-721) ------------------------------
    scale = _effective_scale(opts)
    dscale = None
    A, svec = _scale_operator(A, scale)
    if scale == 1:
        b = svec * b
    elif scale == 2:
        dscale = svec
        b = svec * b
        if not opts.initx_zeros:
            x0 = x0 / dscale

    # ---- storage conversion (-storage N) ----------------------------------
    A = _convert_storage(A, opts)

    # ---- preconditioner ---------------------------------------------------
    t_p = C.wtime()
    if M is not None:
        pass                       # caller-supplied preconditioner object
    elif opts.precon == "none":
        M = NonePrecon()
    else:
        M = create_precon(opts.precon, A, opts)
    _sync(device)
    ptime = C.wtime() - t_p

    # ---- execute -----------------------------------------------------------
    spec = _make_spec(opts)
    fn = SOLVER_FNS[opts.solver]
    t_i = C.wtime()
    if opts.precision == "single":
        # like lis_tpu's _cast32: real float64 tensors drop to float32,
        # complex ones stay as they are (TensorFields.to casts only real
        # floating-point leaves)
        f32 = torch.float32
        out = fn(A.to(dtype=f32), _cast32(b), _cast32(x0), M.to(dtype=f32),
                 spec)
        out = out._replace(x=out.x.to(b.dtype))
    else:
        out = fn(A, b, x0, M, spec)
    x = out.x
    _sync(device)
    itime = C.wtime() - t_i

    # ---- unscale + true residual (lis_solve_kernel :877-924) --------------
    if dscale is not None:
        x = x * dscale
    rtrue = b0 - A0.matvec(x)
    bn = float(v.nrm2(b0))
    true_resid = float(v.nrm2(rtrue)) / (1.0 if bn == 0 else bn)

    iters = int(out.iters)
    rh = out.rhistory[: iters + 1].cpu().numpy()
    result = SolveResult(x=x, status=int(out.status), iters=iters,
                         resid=float(out.resid), true_resid=true_resid,
                         rhistory=rh, time=C.wtime() - t_total,
                         itime=itime, ptime=ptime, options=opts)
    if opts.print_ & 2:
        _print_banner(result, n, live=True)
    return result


def _print_banner(res: SolveResult, n: int, file=None, live=False):
    """Rank-0 style report (reference banner, lis_solver.c:760-825)."""
    file = file or sys.stdout
    o = res.options
    print(f"linear solver         : {o.solver.upper()}", file=file)
    print(f"preconditioner        : {o.precon}", file=file)
    print(f"matrix size           : {n}", file=file)
    if not live:
        for it, r in enumerate(res.rhistory):
            print(f"iteration: {it:5d}  relative residual = {r:e}",
                  file=file)
    print(f"number of iterations  : {res.iters}", file=file)
    print(f"relative residual     : {res.resid:e}", file=file)
