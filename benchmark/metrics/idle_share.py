"""idle_share: the share of the traced window in which no operation ran
on the device, in %."""


def read(run):
    t = run.trace
    if t is None or t.window_us <= 0 or not t.device:
        return None
    return 100.0 * (t.window_us - t.busy_us()) / t.window_us
