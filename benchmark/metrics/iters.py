"""iters: mean ``SolveResult.iters`` over the timed window."""


def read(run):
    its = [s.get("iters") for s in run.solves]
    return sum(its) / len(its) if its and None not in its else None
