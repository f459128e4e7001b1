"""solve_p90_s: the 90th percentile of every solve's time in the timed
window (host clock around each ``solve`` call, which returns with the
device synchronised), by ``statistics.quantiles`` over all of them."""

import statistics


def read(run):
    walls = [s["wall"] for s in run.solves]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=10)[-1]
