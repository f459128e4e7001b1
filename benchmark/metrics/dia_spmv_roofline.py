"""dia_spmv_roofline: kernel E's bound (``roofline.dia_spmv`` on the
cell's operator) over its mean device time in the traced window, in %.
Every launch of E in these cells is a product with the whole operator."""

from benchmark import roofline


def read(run):
    t = run.trace
    times = [] if t is None else t.kernel_times("dia_spmv")
    if not times or run.nnd is None:
        return None
    mean_s = sum(times) / len(times) * 1e-6
    return 100.0 * roofline.dia_spmv(run.n, run.nnd) / mean_s
