"""Jacobi preconditioner.

Port of the point-Jacobi half of ``lis_tpu/precon/jacobi.py`` (reference
lis_precon_create_jacobi / lis_psolve_jacobi,
src/precon/lis_precon_jacobi.c:61,89): z = D⁻¹ r, one elementwise
multiply on the device.  Block Jacobi is not ported yet (ROADMAP.md
queue 1 item 9).
"""

from __future__ import annotations

import dataclasses

import torch

from lis_tpu_torch.matrix.base import TensorFields
from lis_tpu_torch.precon.base import register_precon


@dataclasses.dataclass(frozen=True, eq=False)
class JacobiPrecon(TensorFields):
    dinv: torch.Tensor

    def psolve(self, r):
        return self.dinv * r

    def psolveh(self, r):
        if self.dinv.is_complex():
            return self.dinv.conj() * r
        return self.dinv * r


@register_precon("jacobi")
def create_jacobi(A, opts):
    d = A.get_diagonal()
    nz = d != 0
    dinv = torch.where(nz, 1.0 / torch.where(nz, d, torch.ones_like(d)),
                       torch.ones_like(d))
    return JacobiPrecon(dinv=dinv)
