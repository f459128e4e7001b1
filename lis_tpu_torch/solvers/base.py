"""Shared solver machinery.

Port of ``lis_tpu/solvers/base.py``: the initial residual and convergence
normalisation (lis_solver_get_initial_residual, src/solver/lis_solver.c:
957-1091), the per-iteration residual getters (nrm2_r / nrm2_b / nrm1_b),
residual history and the exit bookkeeping.

lis_tpu compiles each solve to one ``lax.while_loop``.  Here the loop is
a Python loop over device tensors (``krylov_loop``):

- every loop scalar (iteration counter, flag, residual) stays a 0-d
  tensor on the device, so a step never waits for the device;
- the host reads the loop condition every ``spec.check_every`` steps
  (one 0-d device-to-host read; always every step under ``-print out``,
  which prints from the host loop);
- when that interval is above 1, each step is merged under the
  while-loop condition as a mask: once ``nrm <= tol``, a breakdown flag
  is set or ``it > maxiter``, the state freezes, so the reported
  iteration count stays exact.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from lis_tpu_torch import config as C
from lis_tpu_torch.core import vector as v

RUNNING = -99  # internal status while the loop is live


class SolverSpec(NamedTuple):
    """Solver configuration (the subset of options the loop reads)."""
    solver: str = "bicg"
    tol: float = 1.0e-12
    tol_w: float = 1.0
    maxiter: int = 1000
    conv_cond: int = 0
    restart: int = 40         # -restart (GMRES/FGMRES/Orthomin)
    ell: int = 2              # -ell (BiCGSTAB(l))
    m: int = 3                # -m (read by no solver, as in lis_tpu)
    omega: float = 1.9        # -omega (SOR)
    irestart: int = 2         # -irestart (IDR(s) shadow dimension)
    # -print out/all: print each iteration's residual from the host loop
    # (reference lis_solver_cg.c:217-221 prints live)
    live_print: bool = False
    # steps between host reads of the loop condition.  1 measured fastest
    # on the H100 for CST and CSR at n = 2^16 and 2^20 (PERF.md):
    # a read costs less than the steps a longer interval runs past
    # convergence.  Chunks of k > 1 steps are for CUDA-graph replay.
    check_every: int = 1


class SolverOutput(NamedTuple):
    x: torch.Tensor
    status: torch.Tensor      # LIS_SUCCESS / LIS_MAXITER / LIS_BREAKDOWN
    iters: torch.Tensor
    resid: torch.Tensor       # final relative residual
    rhistory: torch.Tensor    # (maxiter+2,), nan where unwritten


SOLVER_FNS: dict[str, Any] = {}
SOLVER_PREPARE: dict[str, Any] = {}


def register_solver(name: str):
    def deco(fn):
        SOLVER_FNS[name] = fn
        return fn
    return deco


def register_prepare(name: str):
    """Host-side setup hook ``prepare(A, spec) -> aux`` that the driver
    runs before the loop (the analogue of the reference's lis_matrix_split
    setup): the level-scheduled plans or relaxed sweeps of GS and SOR.  The
    solver receives the result as ``aux``; under ``-f single`` it is cast
    with the operator."""
    def deco(fn):
        SOLVER_PREPARE[name] = fn
        return fn
    return deco


def loop_scalar(val, like):
    """A 0-d loop scalar (iteration counter, flag) on ``like``'s device."""
    return torch.tensor(val, device=like.device)


def _inv_or_one(ref):
    zero = ref == 0.0
    return torch.where(zero, torch.ones_like(ref),
                       1.0 / torch.where(zero, torch.ones_like(ref), ref))


def residual_norm(r, bnrm_inv, spec: SolverSpec):
    """Per-iteration convergence measure (lis_solver_get_residual[conv]):
    nrm2_r / nrm2_b return ||r||₂ normalised, nrm1_b the raw ||r||₁."""
    if spec.conv_cond == 2:
        return v.nrm1(r)
    return v.nrm2(r) * bnrm_inv


def init_residual(A, b, x0, spec: SolverSpec):
    """Initial residual + normalisation (lis_solver_get_initial_residual).

    Returns (r0, bnrm_inv, tol_eff, nrm0): bnrm_inv is 1/||r0|| (nrm2_r),
    1/||b||₂ (nrm2_b) or 1/||b||₁ (nrm1_b, with tol adjusted by tol_w);
    zero norms fall back to 1 like the reference."""
    r = b - A.matvec(x0)
    if spec.conv_cond == 0:
        ref = v.nrm2(r)
        nrm0 = ref
        tol_eff = spec.tol
    elif spec.conv_cond == 1:
        ref = v.nrm2(b)
        nrm0 = v.nrm2(r)
        tol_eff = spec.tol
    else:
        ref = v.nrm1(b)
        nrm0 = v.nrm1(r)
        tol_eff = ref * spec.tol_w + spec.tol
        return r, _inv_or_one(ref), tol_eff, nrm0    # raw ||r0||₁
    bnrm_inv = _inv_or_one(ref)
    return r, bnrm_inv, tol_eff, nrm0 * bnrm_inv


def new_rhistory(spec: SolverSpec, nrm0, dtype):
    rh = torch.full((spec.maxiter + 2,), float("nan"), dtype=dtype,
                    device=nrm0.device)
    rh[0] = nrm0
    return rh


def record(rh, it, nrm):
    """rh with rh[it] = nrm (it is a 0-d device tensor)."""
    return rh.index_put((it.view(1),), nrm.view(1).to(rh.dtype))


def krylov_loop(spec: SolverSpec, tol_eff, state: dict, step,
                live=None, it_done: bool = False) -> dict:
    """Run ``step`` while it <= maxiter, nrm > tol_eff and flag == RUNNING
    (the exit structure of every reference solver's for-loop).

    ``state`` holds at least ``it``, ``flag``, ``nrm`` and ``rh``;
    ``step(state) -> state`` performs one iteration, or with ``it_done``
    a cycle of several (BiCGSTAB(l)'s ell BiCG steps and its MR part).
    ``it`` names the next iteration (starting at 1, the step records
    rh[it] and then advances it) or, with ``it_done``, counts the
    iterations done (IDR(s) and BiCGSTAB(l): the step advances it and
    records rh[it]), so one more step fits under maxiter.  With more
    than one step between host reads, each new state is merged under the
    loop condition of the old one, so a state that has left the loop stays
    as it was.  ``live(state)`` replaces the loop condition for a step
    that keeps it on the device itself (the fused CG step, which also
    freezes its own state)."""
    frozen_by_step = live is not None
    if live is None:
        def live(s):
            return ((s["it"] <= spec.maxiter) & (s["nrm"] > tol_eff)
                    & (s["flag"] == RUNNING))

    every = 1 if spec.live_print else max(1, spec.check_every)
    for n in range(spec.maxiter + int(it_done)):
        on = live(state)
        if n % every == 0 and not bool(on):
            break
        before = int(state["it"]) if spec.live_print else 0
        new = step(state)
        # between two host reads a step may run past the loop condition;
        # with a read before every step it cannot, and needs no merge
        state = new if every == 1 or frozen_by_step else {
            k: torch.where(on, new[k], state[k]) for k in state}
        if spec.live_print:
            print_rhistory(state["rh"], before, int(state["it"]), it_done)
    return state


def print_rhistory(rh, before: int, after: int, it_done: bool) -> None:
    """Print the history entries that one step recorded (reference
    lis_print_rhistory, lis_solver_cg.c:217-221 prints live)."""
    shift = int(it_done)
    last = rh.shape[0] - 1
    for it in range(before + shift, after + shift):
        print(f"iteration: {it:5d}  relative residual = "
              f"{float(rh[min(it, last)]):e}", flush=True)


def loop_output(spec: SolverSpec, tol_eff, final: dict) -> SolverOutput:
    """Convert a finished krylov_loop state into SolverOutput: on
    convergence iters is the iteration that converged, maxiter exhaustion
    gives LIS_MAXITER, breakdown codes pass through, and an initial
    residual that already met tol reports iter=1 (lis_solver.c:1074)."""
    converged = final["nrm"] <= tol_eff
    broke = final["flag"] != RUNNING
    status = torch.where(broke, final["flag"],
                         torch.where(converged, C.LIS_SUCCESS,
                                     C.LIS_MAXITER))
    iters = torch.clamp(final["it"] - 1, 1, spec.maxiter)
    return SolverOutput(x=final["x"], status=status, iters=iters,
                        resid=final["nrm"], rhistory=final["rh"])
