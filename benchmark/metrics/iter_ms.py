"""iter_ms: the timed window's summed ``SolveResult.itime`` over its
summed iterations, in ms."""


def read(run):
    if not all("iters" in s and "itime" in s for s in run.solves):
        return None
    its = sum(s["iters"] for s in run.solves)
    return 1e3 * sum(s["itime"] for s in run.solves) / its if its else None
