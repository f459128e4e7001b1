"""Additive Schwarz wrapper (-adds true -adds_iter N).

Port of ``lis_tpu/precon/ads.py`` (reference lis_precon_create_adds /
lis_psolve_adds, src/precon/lis_precon_ads.c:58,116): x = M⁻¹b, then
adds_iter times {r = b − Ax; x += M⁻¹r}, an iterative refinement of any
inner preconditioner (hpcg_kernel's default, test/test3b.c:172).

On a DIA operator the residual b − Ax is one launch of kernel H over all
of A's diagonals (rhs b, term x, no scale) instead of kernel E and a
subtraction; on any other format it is A's matvec and a subtraction.
"""

from __future__ import annotations

import dataclasses

from lis_tpu_torch.matrix.base import TensorFields, static
from lis_tpu_torch.matrix.dia import DIAMatrix, dia_relax, dia_relaxh
from lis_tpu_torch.utils.trace import psolve_span


@dataclasses.dataclass(frozen=True, eq=False)
class AdditiveSchwarzPrecon(TensorFields):
    A: object
    inner: object
    iters: int = static()

    def _residual(self, b, x, herm: bool):
        A = self.A
        if isinstance(A, DIAMatrix) and A.nrows == A.ncols:
            return (dia_relaxh if herm else dia_relax)(A, b, x)
        return b - (A.matvech(x) if herm else A.matvec(x))

    @psolve_span
    def psolve(self, b):
        x = self.inner.psolve(b)
        for _ in range(self.iters):
            x = x + self.inner.psolve(self._residual(b, x, False))
        return x

    @psolve_span
    def psolveh(self, b):
        x = self.inner.psolveh(b)
        for _ in range(self.iters):
            x = x + self.inner.psolveh(self._residual(b, x, True))
        return x


def wrap_additive_schwarz(A, inner, opts) -> AdditiveSchwarzPrecon:
    return AdditiveSchwarzPrecon(A=A, inner=inner,
                                 iters=int(getattr(opts, "adds_iter", 1)))
