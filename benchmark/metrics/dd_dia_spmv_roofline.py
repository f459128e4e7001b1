"""dd_dia_spmv_roofline: kernel M's bound (``roofline.dd_dia_spmv`` on the
cell's operator, with float64 limbs, and the diagonals' low limbs where
the launched variant reads them) over its mean device time in the traced
window, in %."""

import re

from benchmark import roofline

_LO = re.compile(r"\bdia_kernel<\w+, \S+, (true|\(bool\)1)>")


def read(run):
    t = run.trace
    if t is None:
        return None
    names = [n for n, _ in t.kernels() if t.kernel_of(n)[0] == "dd_dia_spmv"]
    times = t.kernel_times("dd_dia_spmv")
    if not times or run.nnd is None:
        return None
    lo = all(_LO.search(n) for n in names)
    mean_s = sum(times) / len(times) * 1e-6
    return 100.0 * roofline.dd_dia_spmv(run.n, run.nnd, lo) / mean_s
