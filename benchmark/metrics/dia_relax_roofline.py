"""dia_relax_roofline: kernel H's bound over its device time in the traced
window, in %, where every launch of H is part of an SSOR psolve inside
additive Schwarz on the cell's operator: the launches are counted in
psolves (``roofline.ssor_adds_psolve``), each psolve's bound summed."""

from benchmark import roofline
from benchmark.reference.compare import option_value


def read(run):
    t = run.trace
    opts = run.options.split()
    if (t is None or run.nnd is None or "ssor" not in opts
            or "-adds" not in opts):
        return None
    times = t.kernel_times("dia_relax")
    sweeps = int(option_value(run.options, "-ssor_sweeps", 2))
    adds = int(option_value(run.options, "-adds_iter", 1))
    bound, per = roofline.ssor_adds_psolve(run.n, run.nnd, sweeps, adds)
    if not times or len(times) % per:
        return None
    return 100.0 * bound * (len(times) // per) / (sum(times) * 1e-6)
