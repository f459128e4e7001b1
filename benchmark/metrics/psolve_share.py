"""psolve_share: device time of the preconditioner's kernels (layer
"precon" of ``layers.json``) over all device time in the traced window, in
%.  Torch's own kernels inside a psolve (additive Schwarz's sum, SA-AMG's
vector operations) match no pattern and are left out, so this is a lower
bound until the program has spans of its own."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    pre = t.layer_us("precon")
    return 100.0 * pre / t.device_us() if pre > 0 else None
