"""I+S approximate-inverse preconditioner.

Port of ``lis_tpu/precon/is_precon.py`` (reference lis_precon_is.c: for
Krylov outer solvers the apply is y = x − α·S_m x, where S_m keeps the
first m+1 entries of each row of the strictly upper part U, lis_psolve_is
:417-459; α = -is_alpha, m = -is_m).  One truncated product of torch
operations on the device: a gather and a row sum (psolve), a scatter-add
(psolveh); lis_tpu has no Pallas kernel here.  The driver forces Jacobi
scaling (-scale 1) for -p is, as the reference does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lis_tpu_torch.matrix.base import TensorFields, static
from lis_tpu_torch.matrix.split import split_matrix
from lis_tpu_torch.precon.base import NonePrecon, register_precon
from lis_tpu_torch.utils.trace import psolve_span


@dataclasses.dataclass(frozen=True, eq=False)
class ISPrecon(TensorFields):
    index: torch.Tensor       # (n, m) int32 truncated-U columns (0-padded)
    value: torch.Tensor       # (n, m) truncated-U values (0-padded)
    alpha: float = static()

    @psolve_span
    def psolve(self, r):
        n, m = self.index.shape
        g = r.index_select(0, self.index.reshape(-1)).view(n, m)
        return r - self.alpha * (self.value * g).sum(1)

    @psolve_span
    def psolveh(self, r):
        v = self.value.conj() if self.value.is_complex() else self.value
        prod = (v * r[:, None]).reshape(-1)
        t = torch.zeros_like(prod[: r.shape[0]]).index_add_(
            0, self.index.reshape(-1), prod)
        return r - self.alpha * t


@register_precon("is")
def create_is(A, opts):
    if getattr(opts, "is_level", 1) == 0:
        # -is_level 0 disables the apply (the reference routes psolve to
        # psolve_none, lis_precon_is.c:100-104); the driver still scales
        return NonePrecon()
    m = getattr(opts, "m", 3) + 1
    up, ui, uv = split_matrix(A).U.to_csr_arrays()
    up = np.asarray(up).astype(np.int64)
    n = A.nrows
    # keep the first min(m, row nnz) entries of each row
    idx = np.zeros((n, m), dtype=np.int32)
    val = np.zeros((n, m), dtype=uv.dtype)
    if len(uv):
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(up))
        slot = np.arange(len(uv), dtype=np.int64) - up[rows]
        keep = slot < m
        idx[rows[keep], slot[keep]] = ui[keep]
        val[rows[keep], slot[keep]] = uv[keep]
    dev = A.device
    return ISPrecon(index=torch.from_numpy(idx).to(dev),
                    value=torch.from_numpy(val).to(dev),
                    alpha=float(getattr(opts, "is_alpha", 1.0)))
