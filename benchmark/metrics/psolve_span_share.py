"""psolve_span_share: device time of every operation launched while a
``lis.psolve`` span was open (the port's kernels and torch's alike) over
all device time in the traced window, in %.  Launches and device
operations are paired in order; where they cannot be, nothing is read."""

from benchmark import spans


def read(run):
    got = spans.device_us_launched_in(run.trace, spans.PSOLVE)
    if got is None or got[1] <= 0:
        return None
    return 100.0 * got[0] / got[1]
