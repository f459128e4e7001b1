"""Solver-state checkpoint/resume.

Port of ``lis_tpu/utils/checkpoint.py``.  The reference has no
iteration-level checkpointing (persistence is matrix/vector I/O plus the
residual-history dump via lis_solver_output_rhistory).  This module
supplies both: the rhistory dump in the reference's two-column format,
and a solver checkpoint — since every solver is a function of (A, b, x0),
saving x and resuming with ``initx_zeros False`` continues the Krylov
solve where it stopped (restarted-Krylov semantics).  x is saved from
its device as a host array and restored onto the matrix's device.
"""

from __future__ import annotations

import json

import numpy as np

from lis_tpu_torch.matrix.base import host


def save_checkpoint(path: str, result, options=None) -> None:
    """Persist a SolveResult as a resumable checkpoint (.npz)."""
    meta = {
        "iters": int(result.iters),
        "status": int(result.status),
        "resid": float(result.resid),
        "solver": result.options.solver,
        "precon": result.options.precon,
    }
    np.savez(path, x=host(result.x), rhistory=np.asarray(result.rhistory),
             meta=json.dumps(meta))


def load_checkpoint(path: str):
    """Returns (x, rhistory, meta dict); x and rhistory as host arrays."""
    with np.load(path, allow_pickle=False) as z:
        return z["x"], z["rhistory"], json.loads(str(z["meta"]))


def resume_solve(A, b, path: str, options=None, **overrides):
    """Continue a checkpointed solve on A's device: x0 from the
    checkpoint, iteration counting continues from the stored count."""
    from lis_tpu_torch.solvers.driver import solve
    x0, rh_prev, meta = load_checkpoint(path)
    overrides.setdefault("initx_zeros", False)
    res = solve(A, b, x0=x0, options=options, **overrides)
    res.iters += meta["iters"]
    res.rhistory = np.concatenate([rh_prev, res.rhistory[1:]])
    return res


def output_rhistory(path: str, result) -> None:
    """lis_solver_output_rhistory format: 'iter residual' per line."""
    with open(path, "w") as f:
        for i, r in enumerate(result.rhistory):
            f.write(f"{i} {r:e}\n")
