"""solve_overhead_ms: mean over the timed window of ``SolveResult.time``
less ``SolveResult.itime`` (spans of solvers/driver.py::solve): the host
part of a ``solve`` call around the iterations (scaling, preconditioner
creation, the double-double operator, the true residual, copies)."""


def read(run):
    if not run.solves or not all("time" in s and "itime" in s
                                 for s in run.solves):
        return None
    return 1e3 * sum(s["time"] - s["itime"] for s in run.solves) \
        / len(run.solves)
