"""solve_s: the timed window's whole length over the solves completed in
it (host clock): time to a solution of the stated accuracy."""


def read(run):
    return run.window_s / len(run.solves)
