"""The entry ``solve``: one caller in a closed loop calls
``lis_tpu_torch.solve(A, b, options=...)`` (Lis's ``lis_solve``) from
x0 = 0 on one right-hand side after another.

Traffic keys it reads: ``hold_precon``: the caller builds the
preconditioner once in set-up (Lis's ``lis_precon_create``) and passes it
to every solve as ``M=`` (``lis_solve_kernel``), as AMG users keep a
hierarchy across solves; ``reference``: the reference method
({"solver": ..., "precon": ..., ...}, ``reference/solvers/`` and
``reference/precons/``) whose iteration count a solve is held to, or null.

Numbers for the comparison, with the program's state freed:

- ``not_success``: solves whose status is not SUCCESS;
- ``iters_max``: the most iterations any solve took;
- ``iters_mean``: the mean of every solve's iterations, steadier than
  the most where a fault moves the count by about one;
- ``x_err``: max over the sample of ‖x − x*‖₂ / ‖x*‖₂;
- ``resid``: max of ‖b − A·x‖₂ / ‖b‖₂, A·x by the plain operator;
- ``iters_gap``: max of |iterations − the reference method's|, where the
  traffic names one and the limits compare it.
"""

from __future__ import annotations

import torch

from benchmark import inputs, loader
from benchmark.reference import precond
from benchmark.reference.compare import option_value

SUCCESS = 0


def prepare(A, options: str, traffic: dict) -> dict:
    """What the caller holds across solves."""
    import lis_tpu_torch
    M = None
    if traffic.get("hold_precon"):
        from lis_tpu_torch.precon.ads import wrap_additive_schwarz
        from lis_tpu_torch.precon.base import create_precon
        from lis_tpu_torch.runtime.options import SolverOptions
        opts = SolverOptions.from_string(options)
        Ak = lis_tpu_torch.transform_operator(A, opts)
        M = create_precon(opts.precon, Ak, opts)
        if opts.adds:
            M = wrap_additive_schwarz(Ak, M, opts)
    return {"solve": lis_tpu_torch.solve, "A": A, "options": options,
            "M": M}


def call(ctx: dict, b) -> dict:
    """One solve: its answer ``x`` and what the metrics read."""
    res = ctx["solve"](ctx["A"], b, options=ctx["options"], M=ctx["M"])
    return dict(x=res.x, time=res.time, itime=res.itime, ptime=res.ptime,
                iters=res.iters, status=res.status)


def _rel(num, den) -> float:
    d = float(torch.linalg.vector_norm(den))
    return float(torch.linalg.vector_norm(num)) / (d if d else 1.0)


def _worse(a: float, b: float) -> float:
    """max(a, b), NaN if either is NaN (max() drops a NaN)."""
    return a + b if a != a or b != b else max(a, b)


def numbers(solves, sample, op, traffic, options, limits, seed, device):
    """``solves``: every solve's record; ``sample``: [(pool index, x,
    iterations)] of the answers drawn from the seed; ``op``: the plain
    operator."""
    out = {
        "not_success": sum(s["status"] != SUCCESS for s in solves),
        "iters_max": max((s["iters"] for s in solves), default=0),
        "iters_mean": (sum(s["iters"] for s in solves) / len(solves)
                       if solves else 0.0),
        "x_err": 0.0, "resid": 0.0, "iters_gap": 0,
    }
    spec = traffic.get("reference")
    if spec is not None and "iters_gap" in limits:
        method = loader.load("reference/solvers", spec["solver"])
        psolve = precond.make(spec, op)
        tol = option_value(options, "-tol", 1e-12)
        maxiter = int(option_value(options, "-maxiter", 1000))
    for index, x, iters in sample:
        xs = inputs.exact_solution(op.n, seed, index, device)
        b = op.matvec(xs)
        x = x.to(device=device, dtype=torch.float64)
        out["x_err"] = _worse(out["x_err"], _rel(x - xs, xs))
        out["resid"] = _worse(out["resid"], _rel(b - op.matvec(x), b))
        if spec is not None and "iters_gap" in limits:
            _, ref_iters, _ = method.solve(b, op, psolve, tol, maxiter)
            out["iters_gap"] = max(out["iters_gap"], abs(iters - ref_iters))
    return out
