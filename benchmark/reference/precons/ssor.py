"""Lis's SSOR with each triangular solve replaced by Jacobi-relaxed
sweeps, as the port and lis_tpu define it on a banded operator
(lis_tpu_torch/precon/ssor.py, SSORRelaxPrecon): with wd = ω/diag,
y = r·wd, then ``sweeps`` × y = (r − L·y)·wd; f = y·(diag/ω), z = f·wd,
then ``sweeps`` × z = (f − U·z)·wd.  Spec keys ``omega`` (1.0) and
``sweeps`` (2)."""


def make(spec: dict, op):
    omega, sweeps = spec.get("omega", 1.0), spec.get("sweeps", 2)
    d = op.diagonal()
    wd, dtil = omega / d, d / omega

    def psolve(r):
        y = r * wd
        for _ in range(sweeps):
            y = (r - op.lower(y)) * wd
        f = y * dtil
        z = f * wd
        for _ in range(sweeps):
            z = (f - op.upper(z)) * wd
        return z
    return psolve
