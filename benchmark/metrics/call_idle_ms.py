"""call_idle_ms: device-idle time of the traced window inside the
program's ``lis.solve`` spans but outside their ``lis.krylov`` spans (a
``solve`` call's work around its iterations: options, scaling,
preconditioner set-up, the true residual, copies) over the ``lis.solve``
spans, in ms."""

from benchmark import spans


def read(run):
    split = spans.idle_split(run.trace)
    if split is None:
        return None
    return split[1] / split[3] * 1e-3
