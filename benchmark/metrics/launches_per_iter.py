"""launches_per_iter: kernels in the traced window (the port's and
torch's) over the iterations of the solves traced."""


def read(run):
    t = run.trace
    its = sum(s.get("iters", 0) for s in run.traced_solves)
    if t is None or not its or not t.kernels():
        return None
    return len(t.kernels()) / its
