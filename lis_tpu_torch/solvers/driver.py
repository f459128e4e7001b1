"""lis_solve-equivalent driver.

Port of ``lis_tpu/solvers/driver.py::solve`` (reference lis_solve /
lis_solve_kernel, src/solver/lis_solver.c:367,441-953): option parsing,
scaling (none/jacobi/symm_diag with the CG+Jacobi upgrade at :702-705
and the forced Jacobi scaling of -p is), ``-storage`` conversion,
preconditioner creation, registry dispatch,
residual history, true-residual recomputation (:910-924) and per-phase
timing.

The solve runs on the device that holds the matrix's tensors; ``b`` and
``x0`` are moved there.  A matrix built by the port's constructors lives
on the default device, the card, unless its caller asked for another.
With no ``-storage`` the operator is routed by ``auto_storage`` (banded →
DIA, quasi-banded → HDI, locality-free → CST or CSS), as in lis_tpu.  The
preconditioner (additive Schwarz around it with ``-adds true``) is built
on the scaled and routed operator, as lis_tpu builds it, and a solver's
prepare hook (GS, SOR) runs after it; ``ptime`` times both (lis_tpu
times the preconditioner alone).  Every preconditioner of lis_tpu runs
(none, jacobi, bjacobi, ssor, ilu, ilut, iluc, is, sainv, saamg,
hybrid), at every precision of lis_tpu: ``-f double`` and ``single``,
and the double-double modes ``quad``, ``switch``, ``df`` and
``switch_df`` through the 17 ``_quad`` twins.  ``-reorder rcm`` solves the
symmetrically permuted system (b and x0 permuted once on the device, x
once at exit) and ``-use_at`` gives the BiCG family an explicit Aᴴ.  What
lis_tpu does and this package does not yet (the BES and block formats)
raises ``NotImplementedError`` naming the ROADMAP.md item that ports it.
"""

from __future__ import annotations

import functools
import sys
from dataclasses import dataclass

import numpy as np
import torch

from lis_tpu_torch import config as C
from lis_tpu_torch.core import vector as v
from lis_tpu_torch.core.ddreal import DD, make_dd_operator
from lis_tpu_torch.matrix.base import SparseMatrix
from lis_tpu_torch.matrix.convert import convert_matrix, is_banded
from lis_tpu_torch.matrix.css import CSSMatrix
from lis_tpu_torch.matrix.cst import CSTMatrix
from lis_tpu_torch.matrix.hybrid import HybridMatrix
from lis_tpu_torch.matrix.reorder import permute_symmetric, rcm_permutation
from lis_tpu_torch.matrix.useat import with_explicit_transpose
from lis_tpu_torch.precon.base import NonePrecon, create_precon
from lis_tpu_torch.precon import hybrid as _phyb         # noqa: F401
from lis_tpu_torch.precon import ilu as _pilu            # noqa: F401
from lis_tpu_torch.precon import is_precon as _pis        # noqa: F401
from lis_tpu_torch.precon import jacobi as _pjac          # noqa: F401
from lis_tpu_torch.precon import saamg as _psaamg         # noqa: F401
from lis_tpu_torch.precon import sainv as _psainv         # noqa: F401
from lis_tpu_torch.precon import ssor as _pssor           # noqa: F401
from lis_tpu_torch.precon.ads import wrap_additive_schwarz
from lis_tpu_torch.runtime.options import SolverOptions, STORAGE_NAMES
from lis_tpu_torch.solvers.base import SOLVER_FNS, SOLVER_PREPARE, SolverSpec
from lis_tpu_torch.solvers import bicg as _bicg           # noqa: F401
from lis_tpu_torch.solvers import bicgsafe as _bicgsafe   # noqa: F401
from lis_tpu_torch.solvers import bicgstab as _bicgstab   # noqa: F401
from lis_tpu_torch.solvers import bicgstabl as _bicgstabl  # noqa: F401
from lis_tpu_torch.solvers import cg as _cg               # noqa: F401
from lis_tpu_torch.solvers import cgs as _cgs             # noqa: F401
from lis_tpu_torch.solvers import cocg as _cocg           # noqa: F401
from lis_tpu_torch.solvers import gmres as _gmres         # noqa: F401
from lis_tpu_torch.solvers import gpbicg as _gpbicg       # noqa: F401
from lis_tpu_torch.solvers import idrs as _idrs           # noqa: F401
from lis_tpu_torch.solvers import minres as _minres       # noqa: F401
from lis_tpu_torch.solvers import orthomin as _orthomin   # noqa: F401
from lis_tpu_torch.solvers import quad as _quad           # noqa: F401
from lis_tpu_torch.solvers import quad_ext as _quad_ext   # noqa: F401
from lis_tpu_torch.solvers import stationary as _stat     # noqa: F401
from lis_tpu_torch.solvers import tfqmr as _tfqmr         # noqa: F401
from lis_tpu_torch.utils.trace import traced

_STORAGE_BY_ID = {i: n for n, i in STORAGE_NAMES.items()}

# The router's throughput estimates, kept from lis_tpu for parity of the
# decision: they are lis_tpu's estimates of csr-equivalent GB/s at fill
# blowup 1 on a TPU (BES slabs, CST grid), and the margin by which CST must
# beat BES to pay for its host build.  Whether they hold on the H100 is
# for the port's bench to decide (ROADMAP.md).
_BES_RATE = 750.0
_CST_RATE = 150.0
_CST_MARGIN = 1.5


def auto_storage(A, need_at: bool = True):
    """Default storage routing, lis_tpu's decision order and thresholds:

    1. banded (at most 512 diagonals padding the nnz by at most 4x) → DIA,
       whose SpMV streams the diagonals with no gather;
    2. quasi-banded (dominant diagonals cover >= 75 % of the nnz) → HDI,
       DIA plus a CSR remainder;
    3. general sparsity → the CST lane-shuffle grid when its profile fits
       (fill blowup <= 6 and remainder <= 2 % of the nnz, doubling Kp up
       to 256 while the natural grid spills), with a transpose grid only
       for solvers that apply Aᴴ every iteration (``need_at``);
    4. else CSS when its profile fits (blowup <= 4, remainder <= 5 %);
    5. else A as it is.

    lis_tpu weighs CST against BES (dense sliding slabs) at step 3 by an
    estimated rate.  BES is not ported yet (ROADMAP.md queue 1 item 8), so
    its candidate is absent (rate 0): where lis_tpu picks BES this router
    picks CST, CSS or A itself.  The answers agree; the format does not.

    The result is cached on the matrix object (``_auto_dia``), so repeated
    solves of one matrix skip the host analysis and the conversion; a
    cached CST without a transpose grid is rebuilt with one the first
    time ``need_at`` asks.  Unless -auto_storage false or an explicit
    -storage is given, ``solve()`` routes every operator through here."""
    if A.format_name in ("dia", "hdi"):
        return A
    cached = getattr(A, "_auto_dia", None)
    if cached is not None and not (need_at and isinstance(cached, CSTMatrix)
                                   and cached.at is None):
        return cached if cached is not False else A
    device = A.device
    out = None
    if is_banded(A):
        out = convert_matrix(A, "dia", device=device)
    else:
        ptr, idx, val = A.to_csr_arrays()
        out = HybridMatrix.try_split(ptr, idx, val, A.shape, device=device)
        if out is None:
            bes_rate = 0.0      # with BES: _BES_RATE / its fill blowup
            cst_rate, cst_kp = 0.0, None
            # Kp escalation: if the natural grid spills (band-concentrated
            # columns overflow the fine bucket grid), doubling Kp coarsens
            # the buckets at a fill cost that the rate estimate charges for
            Kp = CSTMatrix._pick_kp(len(val) / max(A.shape[0], 1))
            while Kp <= 256:
                blowup, rem_frac = CSTMatrix.profile(ptr, idx, A.shape, Kp=Kp)
                if blowup > 6.0:
                    break
                if rem_frac <= 0.02:
                    cst_rate, cst_kp = _CST_RATE / max(blowup, 1.0), Kp
                    break
                Kp *= 2
            if cst_rate > _CST_MARGIN * bes_rate and cst_rate > 0.0:
                out = CSTMatrix.from_csr_arrays(ptr, idx, val, A.shape,
                                                Kp=cst_kp, transpose=need_at,
                                                device=device)
        if out is None:
            blowup, rem_frac = CSSMatrix.profile(idx, A.shape[1])
            if blowup <= 4.0 and rem_frac <= 0.05:
                out = CSSMatrix.from_csr_arrays(ptr, idx, val, A.shape,
                                                device=device)
        if out is None:
            out = False
    object.__setattr__(A, "_auto_dia", out)
    return out if out is not False else A


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
    ptime: float              # preconditioner and solver set-up time (s)
    options: SolverOptions

    def __repr__(self):
        names = {C.LIS_SUCCESS: "SUCCESS", C.LIS_MAXITER: "MAXITER",
                 C.LIS_BREAKDOWN: "BREAKDOWN"}
        return (f"SolveResult({self.options.solver}+{self.options.precon}: "
                f"{names.get(self.status, self.status)}, iters={self.iters}, "
                f"resid={self.resid:.6e})")


def _check_ported(opts: SolverOptions) -> None:
    if opts.solver not in SOLVER_FNS:
        raise NotImplementedError(f"solver {opts.solver!r} not implemented; "
                                  f"have {sorted(SOLVER_FNS)}")


def _make_spec(opts: SolverOptions) -> SolverSpec:
    return SolverSpec(solver=opts.solver, tol=opts.tol, tol_w=opts.tol_w,
                      maxiter=opts.maxiter, conv_cond=opts.conv_cond,
                      restart=opts.restart, ell=opts.ell, m=opts.m,
                      omega=opts.omega, irestart=opts.irestart,
                      live_print=bool(opts.print_ & 2))


def _effective_scale(opts) -> int:
    """The scale mode solve() runs (lis_solve_kernel :613-721): CG+Jacobi
    upgrades -scale 1 to symmetric scaling (lis_solver.c:702-705), and
    -p is forces Jacobi scaling (scale 0 → 1; its truncated-U inverse
    assumes a unit diagonal).  lis_tpu checks I+S before the block branch
    of -scale 1 -storage bsr (``_is_bscale``), so -p is always scales by
    the point diagonal; that branch comes with the BSR format (ROADMAP.md
    queue 1 item 8b)."""
    scale = opts.scale
    if scale == 1 and opts.solver == "cg" and opts.precon == "jacobi":
        scale = 2
    if opts.precon == "is" and scale == 0:
        scale = 1
    return scale


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
    if opts.auto_storage:
        # solvers applying A^H every iteration need the CST transpose
        # grid; everything else uses it at most once per solve and rides
        # the scatter fallback.  lis_tpu routes every double-double mode
        # as if Aᴴ were needed (its DD operators read no grid)
        need_at = (opts.solver in ("bicg", "bicr") or opts.use_at
                   or opts.precision not in ("double", "single"))
        return auto_storage(A, need_at=need_at)
    return A


def transform_operator(A, opts):
    """The operator solve() hands the Krylov loop: effective scaling, then
    storage conversion or routing.  Its ``format_name`` is the route."""
    A, _ = _scale_operator(A, _effective_scale(opts))
    return _convert_storage(A, opts)


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
    if x0 is None or opts.initx_zeros:
        x0 = torch.zeros_like(b)
    else:
        x0 = _as_vector(x0, device)

    # ---- bandwidth-reducing reordering (-reorder rcm, lis_tpu
    # driver.py:400-411): solve (P A Pᵀ)(P x) = P b; the permutation is
    # found on the host, b and x0 are permuted once here on the device and
    # x once at exit -------------------------------------------------------
    perm = None
    if opts.reorder == "rcm":
        p = rcm_permutation(A)
        A = permute_symmetric(A, p)
        perm = torch.from_numpy(p.astype(np.int64)).to(device)
        b, x0 = b.index_select(0, perm), x0.index_select(0, perm)
    b0 = b
    A0 = A
    n = A.nrows

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

    # ---- explicit Aᴴ for the BiCG family (-use_at) ------------------------
    if opts.use_at:
        A = with_explicit_transpose(A)

    # ---- preconditioner, on the scaled and routed operator, and the
    # solver's own set-up (the GS/SOR lower solve): both count in ptime ----
    spec = _make_spec(opts)
    fn = SOLVER_FNS[opts.solver]
    prepare = SOLVER_PREPARE.get(opts.solver)
    t_p = C.wtime()
    if M is not None:
        pass                       # caller-supplied preconditioner object
    elif opts.precon == "none":
        M = NonePrecon()
    else:
        M = create_precon(opts.precon, A, opts)
        if opts.adds:
            M = wrap_additive_schwarz(A, M, opts)
    aux = prepare(A, spec) if prepare else None
    # the DD operator (an ELL copy for any format but DIA) is set-up too
    dd = _dd_setup(A, b, x0, M, aux, opts) if opts.precision in DD_MODES \
        else None
    _sync(device)
    ptime = C.wtime() - t_p

    # ---- execute -----------------------------------------------------------
    t_i = C.wtime()
    extra_iters = 0
    if dd is not None:
        out, extra_iters = _solve_dd(dd, spec, opts, prepare)
    else:
        b32 = b
        if opts.precision == "single":
            # like lis_tpu's _cast32: real float64 tensors drop to float32,
            # complex ones stay as they are (TensorFields.to casts only
            # real floating-point leaves)
            f32 = torch.float32
            A, b32, x0, M = A.to(dtype=f32), _cast32(b), _cast32(x0), \
                M.to(dtype=f32)
            aux = None if aux is None else aux.to(dtype=f32)
        if prepare:
            fn = functools.partial(fn, aux=aux)
        out = fn(A, b32, x0, M, spec)
    out = out._replace(x=out.x.to(b.dtype))
    x = out.x
    _sync(device)
    itime = C.wtime() - t_i

    # ---- unscale + true residual (lis_solve_kernel :877-924) --------------
    if dscale is not None:
        x = x * dscale
    rtrue = b0 - A0.matvec(x)
    bn = float(v.nrm2(b0))
    true_resid = float(v.nrm2(rtrue)) / (1.0 if bn == 0 else bn)
    if perm is not None:
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(n, device=device)
        x = x.index_select(0, inv)

    iters = int(out.iters) + extra_iters
    rh = out.rhistory[: iters + 1].cpu().numpy()
    result = SolveResult(x=x, status=int(out.status), iters=iters,
                         resid=float(out.resid), true_resid=true_resid,
                         rhistory=rh, time=C.wtime() - t_total,
                         itime=itime, ptime=ptime, options=opts)
    if opts.print_ & 2:
        _print_banner(result, n, live=True)
    return result


DD_MODES = ("quad", "switch", "df", "switch_df")


def _dd_setup(A, b, x0, M, aux, opts):
    """The operands of the double-double modes (lis_tpu ``solve``,
    driver.py:486-527): f64 pairs for quad and switch; for df and
    switch_df the operator and the right-hand side as f32 pairs, x0 and M
    cast to f32 (and A and aux for switch_df's first phase).  Complex
    operands and solvers without a _quad twin are refused, with
    lis_tpu's messages.  Returns (A_dd, b_dd, A, b, x0, M, aux)."""
    if b.is_complex():
        # the reference's quad machinery is real-only (src/precision/)
        raise NotImplementedError(
            f"-f {opts.precision} does not support complex operands "
            "(the reference's quad precision is real-only)")
    if opts.solver + "_quad" not in SOLVER_FNS:
        raise NotImplementedError(
            f"no quad variant of {opts.solver!r}; have "
            f"{sorted(k for k in SOLVER_FNS if k.endswith('_quad'))}")
    if opts.precision in ("quad", "switch"):
        return make_dd_operator(A), b, A, b, x0, M, aux
    f32 = torch.float32
    b32 = _cast32(b)
    b_dd = DD(b32, (b - b32.to(b.dtype)).to(f32))
    A_dd = make_dd_operator(A, limb=f32)
    if opts.precision == "switch_df":
        A = A.to(dtype=f32)
        aux = None if aux is None else aux.to(dtype=f32)
    return A_dd, b_dd, A, b32, _cast32(x0), M.to(dtype=f32), aux


def _solve_dd(dd, spec, opts, prepare):
    """lis_tpu's DD dispatch (driver.py:528-542): switch and switch_df
    first run the solver itself (at f32 for switch_df) to -switch_tol /
    -switch_maxiter, then its _quad twin from that x; the iteration
    counts add.  Returns (output, the first phase's count)."""
    A_dd, b_dd, A, b, x0, M, aux = dd
    extra = 0
    if opts.precision in ("switch", "switch_df"):
        sw_maxiter = (opts.switch_maxiter if opts.switch_maxiter > 0
                      else opts.maxiter)
        # switch_df's first phase is f32: past about 1e-6 its recursive
        # residual no longer tracks the true one
        sw_tol = (opts.switch_tol if opts.precision == "switch"
                  else max(opts.switch_tol, 1.0e-6))
        fn = SOLVER_FNS[opts.solver]
        if prepare:
            fn = functools.partial(fn, aux=aux)
        out1 = fn(A, b, x0, M, spec._replace(tol=sw_tol, maxiter=sw_maxiter))
        x0 = out1.x
        extra = int(out1.iters)
    qname = opts.solver + "_quad"
    out = SOLVER_FNS[qname](A_dd, b_dd, x0, M, spec._replace(solver=qname))
    return out, extra


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
