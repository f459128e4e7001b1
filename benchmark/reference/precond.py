"""A reference preconditioner put together from a traffic mix's
``reference`` spec: ``precons/<spec["precon"]>.py`` makes the inner
psolve from the plain operator, and ``adds_iter`` > 0 wraps it in Lis's
additive Schwarz refinement (lis_precon_ads.c): x = M⁻¹r, then
adds_iter × x += M⁻¹(r − A·x)."""

from __future__ import annotations

from benchmark import loader


def make(spec: dict, op):
    """psolve(r) of the spec on the plain operator ``op``."""
    inner = loader.load("reference/precons", spec["precon"]).make(spec, op)
    adds = spec.get("adds_iter", 0)
    if not adds:
        return inner

    def psolve(r):
        x = inner(r)
        for _ in range(adds):
            x = x + inner(r - op.matvec(x))
        return x
    return psolve
