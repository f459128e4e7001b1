"""iter_idle_us: device-idle time of the traced window, laid on the host's
clock (``spans.host_idle_gaps``), inside the program's ``lis.krylov``
spans (a ``solve``'s iterations) over the iterations of the solves
traced, in us: where the Krylov loop, its preconditioner included,
leaves the device waiting on the host."""

from benchmark import spans


def read(run):
    split = spans.idle_split(run.trace)
    its = sum(s.get("iters", 0) for s in run.traced_solves)
    if split is None or not its:
        return None
    return split[0] / its
