"""cg_quad's fused step (``lis_tpu_torch/core/ddcg.py``) on the CPU.

The route: a Jacobi preconditioner in the limb type, or none, and no mesh
take the fused step; any other preconditioner and a distributed solve the
plain one, as the counters ``cg_quad.fused`` and ``cg_quad.plain`` record
under a profiler.  The answer: on CPU tensors the fused step runs its
kernels' plain versions and equals the plain step bit for bit in x, the
residual history, the count, the status and the residual, in f64 and f32
limbs, converged, at maxiter, under ``-conv_cond nrm1_b`` and on a
breakdown.  The file imports neither jax nor lis_tpu.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lis_tpu_torch
from lis_tpu_torch.core import ddreal as q
from lis_tpu_torch.precon.base import NonePrecon
from lis_tpu_torch.precon.jacobi import JacobiPrecon
from lis_tpu_torch.solvers import quad as Q
from lis_tpu_torch.solvers.base import SOLVER_FNS, SolverSpec
from lis_tpu_torch.utils import testmat as tmt
from lis_tpu_torch.utils import trace


def _routes(run):
    """The cg_quad route counters of ``run()`` under a CPU profiler."""
    trace.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        out = run()
    got = {k: v for k, v in trace.counters().items()
           if k.startswith("cg_quad.")}
    trace.reset_counters()
    return got, out


@pytest.mark.parametrize("opts, route", [
    ("-p jacobi -f quad", "fused"), ("-p none -f quad", "fused"),
    ("-p jacobi -f df", "fused"), ("-p none -f switch", "fused"),
    ("-p jacobi -f switch_df", "fused"), ("-p ssor -f quad", "plain"),
    ("-p ilu -f quad", "plain"), ("-p jacobi -f quad -conv_cond nrm2_b",
                                  "fused")])
def test_cg_quad_route(opts, route):
    A = tmt.poisson3d27(6, 5, 7, device="cpu")
    b = np.random.default_rng(3).standard_normal(A.nrows)
    got, res = _routes(lambda: lis_tpu_torch.solve(
        A, b, options=f"-i cg {opts} -tol 1e-14"))
    assert got == {f"cg_quad.{route}": 1}
    assert res.status == 0


class _OneRank:
    """A mesh of one rank: its collectives return what they are given."""

    def all_reduce(self, t, op="sum"):
        return t

    def all_gather(self, t):
        return t.reshape(-1).contiguous()


@pytest.mark.parametrize("mesh, route", [(None, "fused"),
                                         (_OneRank(), "plain")])
def test_cg_quad_route_under_a_mesh(mesh, route):
    A = tmt.poisson3d27_dia(5, 6, 7, device="cpu")
    D = q.make_dd_operator(A)
    b = torch.from_numpy(np.random.default_rng(4).standard_normal(A.nrows))
    M = JacobiPrecon(dinv=1.0 / A.get_diagonal())
    spec = SolverSpec(solver="cg_quad", tol=1e-20, maxiter=200,
                      axis_name=mesh)
    got, out = _routes(lambda: SOLVER_FNS["cg_quad"](
        D, b, torch.zeros_like(b), M, spec))
    assert got == {f"cg_quad.{route}": 1}
    assert int(out.status) == 0


def _problem(limb, zero):
    """A 27-point operator on an odd grid (693 rows), or the zero operator
    (p·q = 0 at the first step), as DD operands in ``limb``."""
    A = tmt.poisson3d27_dia(7, 9, 11, device="cpu")
    n = A.nrows
    if zero:
        A = lis_tpu_torch.DIAMatrix.from_diagonals(
            torch.zeros((1, n), dtype=torch.float64), (0,), (n, n), 0,
            device="cpu")
    b = torch.from_numpy(np.random.default_rng(n).standard_normal(n))
    if limb == torch.float32:
        b = q.DD(b.float(), (b - b.float().double()).float())
    return q.make_dd_operator(A, limb), b, n


# tolerances each limb type reaches: quad 1e-20, df (unit roundoff 2^-48)
# 1e-11; nrm1 relative to ||b||_1 through tol_w
CASES = {"converged": dict(maxiter=500),
         "maxiter": dict(tol=1e-30, maxiter=25),
         "nrm1": dict(maxiter=500, conv_cond=2, tol=0.0),
         "nrm2_b": dict(maxiter=500, conv_cond=1),
         "breakdown": dict(maxiter=500)}


def _spec(limb, case):
    kw = dict(CASES[case])
    tol = 1e-20 if limb == torch.float64 else 1e-11
    kw.setdefault("tol_w" if case == "nrm1" else "tol", tol)
    return SolverSpec(solver="cg_quad", **kw)


def _both(D, b, x0, dinv, spec):
    """The fused and the plain step from the same setup."""
    M = NonePrecon() if dinv is None else JacobiPrecon(dinv=dinv)
    r, bi, te, n0 = Q._init_dd(D, b, x0, spec)
    fused = Q.cg_quad_fused(D, x0, spec, r, bi, te, n0, dinv)
    r, bi, te, n0 = Q._init_dd(D, b, x0, spec)
    plain = Q.cg_quad_plain(D, b, x0, M, spec, r, bi, te, n0)
    return fused, plain


def _same(a, b):
    assert torch.equal(a.x, b.x)
    assert torch.equal(a.rhistory.nan_to_num(-1), b.rhistory.nan_to_num(-1))
    for k in ("iters", "status", "resid"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("precon", ["jacobi", "none"])
@pytest.mark.parametrize("limb", [torch.float64, torch.float32],
                         ids=["quad", "df"])
def test_fused_step_equals_the_plain_step(limb, precon, case):
    D, b, n = _problem(limb, case == "breakdown")
    x0 = torch.zeros(n, dtype=limb)
    dinv = None
    if precon == "jacobi":
        dinv = torch.from_numpy(
            np.random.default_rng(7).uniform(0.02, 0.05, n)).to(limb)
    spec = _spec(limb, case)
    fused, plain = _both(D, b, x0, dinv, spec)
    _same(fused, plain)
    status = {"maxiter": 4, "breakdown": 2}.get(case, 0)
    assert int(fused.status) == status
    if case == "breakdown":
        assert int(fused.iters) == 1 and not fused.x.any()


def test_fused_step_leaves_x0_alone_and_starts_from_it():
    """x is updated in place from a copy of x0."""
    D, b, n = _problem(torch.float64, False)
    x0 = torch.from_numpy(np.random.default_rng(2).standard_normal(n))
    keep = x0.clone()
    spec = SolverSpec(solver="cg_quad", tol=1e-20, maxiter=500)
    fused, plain = _both(D, b, x0, None, spec)
    assert torch.equal(x0, keep)
    _same(fused, plain)


def test_fused_steps_after_the_loop_change_nothing():
    """Every pass returns at once once live is 0, as a chunk of steps past
    the loop's end (check_every > 1) needs: the fused solve at
    check_every 8 equals the one at 1."""
    D, b, n = _problem(torch.float64, False)
    dinv = torch.full((n,), 1 / 26, dtype=torch.float64)
    x0 = torch.zeros(n, dtype=torch.float64)
    outs = []
    for k in (1, 8):
        spec = SolverSpec(solver="cg_quad", tol=1e-20, maxiter=500,
                          check_every=k)
        r, bi, te, n0 = Q._init_dd(D, b, x0, spec)
        outs.append(Q.cg_quad_fused(D, x0, spec, r, bi, te, n0, dinv))
    assert int(outs[0].iters) % 8 != 0
    _same(*outs)


@pytest.mark.parametrize("resident, plan", [(None, (128, 16)),
                                            (114, (64, 8)), (3, (0, 0))])
def test_scalars_plan_against_resident_blocks(resident, plan):
    """S2 and S3's grid is planned against the blocks the card holds at
    once; on CPU tensors, which query no card, the widest plan."""
    from lis_tpu_torch.core import ddcg
    n = (1 << 20) + 3
    r = q.DD(torch.ones(n, dtype=torch.float64),
             torch.zeros(n, dtype=torch.float64))
    rho = q.DD(torch.ones((), dtype=torch.float64),
               torch.zeros((), dtype=torch.float64))
    ws = ddcg.DDCGScalars(r, 10, 0.0, 1.0, 1.0, rho, nrm1=False,
                          running=0, breakdown=2, resident=resident)
    assert ws.plan == plan
