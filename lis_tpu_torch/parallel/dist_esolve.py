"""The distributed eigensolvers (dist_esolve).

Port of ``lis_tpu/parallel/dist_esolve.py``.  The reference runs every
eigensolver under MPI through the same L2/L3 calls (lis_esolver.c:263-285;
an inner Krylov solve per outer iteration, lis_esolver_ii.c:216): the
parallelism lives in the matvecs and in the all-reduce of each dot and
norm.  lis_tpu runs its compiled eigensolver loops inside ``shard_map``
with ``axis_name`` in every reduction and in the inner solver's spec, and
the subspace families over GSPMD-sharded global vectors through its
``_GlobalView`` adapter.  Here each rank already holds its shard
(``distribute_*``) and runs the same eigensolver functions as the serial
``esolve`` with ``axis_name`` = the mesh:

- pi, ii, rqi, cg and cr (and gpi, gii, grqi, gcg, gcr) run their device
  loops (``esolvers/power.py``, ``esolvers/cgcr.py``), the inner solves
  raw registry calls over the mesh;
- si, li and ai (and gsi, gli, gai) run their host loops
  (``esolvers/subspace.py``) on the rank's view of its shard, every
  coefficient they read all-reduced first, so that every rank takes the
  same branches and solves the same small eigenproblem.

As in lis_tpu, the inner solves are raw, unpreconditioned and in double
precision whatever -p, -f or -ef ask (lis_tpu dist_esolve.py:106-108,
417-418); the reference honours them under MPI (ROADMAP.md queue 3).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lis_tpu_torch.core import vector as v
from lis_tpu_torch.esolvers.cgcr import _ecg_run, _ecr_run
from lis_tpu_torch.esolvers.power import (_egii_run, _egpi_run, _eii_run,
                                          _epi_run, _finite, _GenOp,
                                          _inner_spec, _loop_result,
                                          _raw_solve, _rqi_run, _Shifted,
                                          _shifted)
from lis_tpu_torch.matrix.base import host
from lis_tpu_torch.parallel.dist import distribute_vector
from lis_tpu_torch.parallel.mesh import Mesh
from lis_tpu_torch.precon.base import NonePrecon
from lis_tpu_torch.runtime.options import EsolverOptions
from lis_tpu_torch.solvers.base import SolverSpec
from lis_tpu_torch.utils.trace import traced

_SUBSPACE = ("si", "li", "ai")


class _RankView:
    """A rank's shard as the eigensolvers see it (the duties of lis_tpu's
    ``_GlobalView``, dist_esolve.py:76-97): ``nrows`` is the padded size
    gn_pad, as lis_tpu's, so LI and AI size their Krylov space alike;
    ``shift_diagonal`` gives A − σI as an operator; the products are the
    shard's, halos included."""

    def __init__(self, A):
        self.A = A
        self.gn, self.gn_pad = A.gn, A.gn_pad

    @property
    def nrows(self):
        return self.gn_pad

    ncols = nrows

    def matvec(self, x):
        return self.A.matvec(x)

    def matvech(self, x):
        return self.A.matvech(x)

    def get_diagonal(self):
        return self.A.get_diagonal()

    def shift_diagonal(self, sigma):
        return _Shifted(self, float(sigma))


def _setup_solve(As, x, opts, mesh):
    """p = As⁻¹x, the CG eigensolver's set-up (lis_esolver_cg.c:213), as
    lis_tpu runs it on the mesh (dist_esolve.py:166-188): raw CG to
    1e-10 within the inner maxiter, no preconditioner, non-finite
    entries zeroed."""
    spec = SolverSpec(solver="cg", tol=1e-10, maxiter=opts.inner.maxiter,
                      conv_cond=0, axis_name=mesh)
    return _finite(_raw_solve(As, x, spec))


# ---- the per-family entries (lis_tpu :111-282), run on every rank ---------

def _dist_epi(A, B, x0, opts, mesh):
    if B is None:
        return _epi_run(A, x0, opts.maxiter, opts.tol, axis_name=mesh)
    return _egpi_run(A, B, x0, opts.maxiter, opts.tol, _inner_spec(opts),
                     axis_name=mesh)


def _dist_eii(A, B, x0, opts, mesh):
    sigma = float(opts.rval)
    if B is None:
        return _eii_run(_shifted(A, sigma), A, x0, sigma, opts.maxiter,
                        opts.tol, _inner_spec(opts), axis_name=mesh)
    return _egii_run(A, B, x0, sigma, opts.maxiter, opts.tol,
                     _inner_spec(opts), axis_name=mesh)


def _dist_erqi(A, B, x0, opts, mesh):
    return _rqi_run(A, B, x0, opts.maxiter, opts.tol, _inner_spec(opts),
                    axis_name=mesh)


def _dist_ecg(A, B, x0, opts, mesh):
    As = _shifted(A, opts.rval)
    x = x0 / v.nrm2(x0, axis_name=mesh)
    p = _setup_solve(As, x, opts, mesh)
    return _ecg_run(As, B, NonePrecon(), x, p, opts.maxiter, opts.tol,
                    axis_name=mesh)


def _dist_ecr(A, B, x0, opts, mesh):
    As = _shifted(A, opts.rval)
    op = As if B is None else _GenOp(
        As, B, _inner_spec(opts)._replace(axis_name=mesh))
    x = x0 / v.nrm2(x0, axis_name=mesh)
    return _ecr_run(op, NonePrecon(), x, opts.maxiter, opts.tol,
                    axis_name=mesh)


_ENTRIES = {"pi": _dist_epi, "ii": _dist_eii, "rqi": _dist_erqi,
            "cg": _dist_ecg, "cr": _dist_ecr}
_SUPPORTED = tuple(_ENTRIES)


# ---- the driver ---------------------------------------------------------------

def _start(A, x0, opts, mesh):
    """The rank's rows of the start vector: ones, or the caller's x0 when
    -initx_ones false, zero-padded to gn_pad (lis_tpu :363-368)."""
    dtype = A.get_diagonal().dtype
    if x0 is None or opts.initx_ones:
        x0 = np.ones(A.gn)
    return distribute_vector(x0, mesh, A.gn_pad).to(dtype)


def _whole(res, A, mesh):
    """``res`` with its vectors whole on every rank, as ``dist_solve``
    returns x: ``evector`` of length gn on the mesh's device, ``evectors``
    (ss, gn) on the host; one all-gather."""
    loc = torch.from_numpy(np.ascontiguousarray(res.evectors)).to(
        mesh.device)
    ss, nl = loc.shape
    g = mesh.all_gather(loc).view(mesh.size, ss, nl).transpose(0, 1)
    g = g.reshape(ss, mesh.size * nl)[:, : A.gn]
    return dataclasses.replace(res, evector=g[0].contiguous(),
                               evectors=host(g))


def _dist_loop(A, B, mesh, base, opts, x0):
    """A device-loop family on the mesh, with lis_tpu's status rules
    (:336-347, :442-458): SUCCESS at resid <= tol, else BREAKDOWN where
    RQI's retries gave up, else MAXITER; cg and cr add the shift back."""
    out = _ENTRIES[base](A, B, _start(A, x0, opts, mesh), opts, mesh)
    iters, x, ev, resid, rh = out[:5]
    dead = out[5] if len(out) > 5 else None
    if base in ("cg", "cr"):
        ev = ev + opts.rval
    res = _loop_result(opts.tol, iters, x, ev, resid, rh, dead)
    return _whole(res, A, mesh)


def _dist_subspace(A, mesh, base, opts, x0, B=None):
    """SI, LI and AI (gsi, gli, gai with a B) on the mesh: the serial
    host loops on the rank's view, their reductions over the mesh."""
    from lis_tpu_torch.esolvers.base import ESOLVER_FNS
    view = _RankView(A)
    res = ESOLVER_FNS[base](view, None if B is None else _RankView(B),
                            _start(A, x0, opts, mesh), opts, axis_name=mesh)
    return _whole(res, A, mesh)


@traced
def dist_esolve(A, mesh: Mesh, options=None, x0=None, B=None, **overrides):
    """Distributed lis_esolve / lis_gesolve on this rank: Ax = λx, or
    Ax = λBx with ``B`` sharded as A is.  ``A`` (and ``B``) is this rank's
    shard (``distribute_*``), ``x0`` a global vector (length gn) or None.
    Every rank must call it with the same options.  Returns an
    EsolveResult whose evector is the whole vector (length gn) on every
    rank, on the shard's device, and whose evectors are (ss, gn) on the
    host, as ``dist_solve`` returns x."""
    if isinstance(options, EsolverOptions):
        opts = options
        for k, val in overrides.items():
            setattr(opts, k, val)
    else:
        opts = EsolverOptions.from_string(options, **overrides)

    # a g-name is its standard family (lis_tpu :396-399); a B makes any
    # family generalized, its B-solves nested in the loops (lis_esolver.c
    # :285 runs every G family under MPI)
    name = opts.esolver
    base = name[1:] if name.startswith("g") else name
    if base in _SUBSPACE:
        return _dist_subspace(A, mesh, base, opts, x0, B)
    if base not in _SUPPORTED:
        raise NotImplementedError(
            f"distributed eigensolver {name!r} (supported: "
            f"{', '.join(_SUPPORTED + _SUBSPACE)} and their g-forms)")
    return _dist_loop(A, B, mesh, base, opts, x0)
