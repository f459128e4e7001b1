"""Hybrid preconditioner — an inner iterative solver as M⁻¹.

Port of ``lis_tpu/precon/hybrid.py`` (reference lis_precon_create_hybrid
/ lis_psolve_hybrid, src/precon/lis_precon_hybrid.c:61,165): a psolve
runs ``-hybrid_i`` (default SOR) for ``-hybrid_maxiter`` (25) iterations
at ``-hybrid_tol`` (1e-3) on A z = r, from z = 0, preconditioned by
``-hybrid_p`` (default none).  psolveh runs the inner solver on Aᴴ (a CSR
built at creation), preconditioned by the adjoint of the inner
preconditioner; the BiCG family needs it.

lis_tpu nests the inner loop inside the outer solver's compiled loop.
Here the inner solve is the port's ``krylov_loop`` as it is, so every
inner iteration reads its loop condition on the host once, and a psolve
costs its inner iterations' launches and reads.
"""

from __future__ import annotations

import dataclasses

import torch

from lis_tpu_torch.matrix.base import TensorFields, static
from lis_tpu_torch.precon.base import (NonePrecon, create_precon,
                                       register_precon)
from lis_tpu_torch.solvers.base import SOLVER_FNS, SOLVER_PREPARE, SolverSpec
from lis_tpu_torch.utils.trace import psolve_span


@dataclasses.dataclass(frozen=True, eq=False)
class _AdjointPrecon(TensorFields):
    """Mᴴ as a preconditioner: the inner solve on Aᴴ is preconditioned by
    the adjoint of the inner preconditioner."""
    inner: object

    @psolve_span
    def psolve(self, r):
        return self.inner.psolveh(r)

    @psolve_span
    def psolveh(self, r):
        return self.inner.psolve(r)


@dataclasses.dataclass(frozen=True, eq=False)
class HybridPrecon(TensorFields):
    A: object                 # the operator
    At: object                # Aᴴ as a CSR
    aux: object               # the inner solver's prepare() result on A
    aux_t: object             # ... on Aᴴ
    M: object                 # the -hybrid_p preconditioner, or None
    spec: SolverSpec = static()

    def _inner(self, A, r, M, aux):
        kw = {} if self.spec.solver not in SOLVER_PREPARE else {"aux": aux}
        out = SOLVER_FNS[self.spec.solver](A, r, torch.zeros_like(r), M,
                                           self.spec, **kw)
        return out.x

    @psolve_span
    def psolve(self, r):
        M = self.M if self.M is not None else NonePrecon()
        return self._inner(self.A, r, M, self.aux)

    @psolve_span
    def psolveh(self, r):
        M = _AdjointPrecon(inner=self.M) if self.M is not None \
            else NonePrecon()
        return self._inner(self.At, r, M, self.aux_t)


@register_precon("hybrid")
def create_hybrid(A, opts):
    from lis_tpu_torch.matrix.convert import convert_matrix
    spec = SolverSpec(solver=getattr(opts, "hybrid_i", "sor"),
                      tol=getattr(opts, "hybrid_tol", 1e-3),
                      maxiter=getattr(opts, "hybrid_maxiter", 25),
                      restart=getattr(opts, "hybrid_restart", 40),
                      ell=getattr(opts, "hybrid_ell", 2),
                      omega=getattr(opts, "hybrid_omega", 1.5),
                      conv_cond=0)
    At = convert_matrix(A, "csr", device=A.device).transpose()
    prepare = SOLVER_PREPARE.get(spec.solver)
    aux = prepare(A, spec) if prepare else None
    aux_t = prepare(At, spec) if prepare else None
    # -hybrid_p: the inner solver's preconditioner (the reference passes
    # LIS_OPTIONS_PPRECON through, lis_precon_hybrid.c:89); no hybrid in
    # hybrid
    M = None
    pname = getattr(opts, "hybrid_p", "none")
    if pname not in ("none", "hybrid"):
        M = create_precon(pname, A, opts)
    return HybridPrecon(A=A, At=At, aux=aux, aux_t=aux_t, M=M, spec=spec)
