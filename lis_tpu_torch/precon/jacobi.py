"""Jacobi and block-Jacobi preconditioners.

Port of ``lis_tpu/precon/jacobi.py`` (reference lis_precon_create_jacobi
/ lis_psolve_jacobi, src/precon/lis_precon_jacobi.c:61,89, and the
inverted-block-diagonal version :221,255): z = D⁻¹ r, one elementwise
multiply on the device; block Jacobi inverts the dense diagonal blocks of
size -storage_block on the host and applies them as one batched product
on the device (lis_tpu: an ``einsum``, outside any Pallas kernel); a BSR
operator's own block size comes first, as in lis_tpu (jacobi.py:84-90).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lis_tpu_torch.matrix.base import TensorFields, static
from lis_tpu_torch.precon.base import register_precon
from lis_tpu_torch.utils.trace import psolve_span


@dataclasses.dataclass(frozen=True, eq=False)
class JacobiPrecon(TensorFields):
    dinv: torch.Tensor

    @psolve_span
    def psolve(self, r):
        return self.dinv * r

    @psolve_span
    def psolveh(self, r):
        if self.dinv.is_complex():
            return self.dinv.conj() * r
        return self.dinv * r


@dataclasses.dataclass(frozen=True, eq=False)
class BlockJacobiPrecon(TensorFields):
    """The inverted block diagonal (the reference's BSR jacobi and
    'bjacobi'): z = binv[k] · r[k·bs:(k+1)·bs] for every block k."""
    binv: torch.Tensor        # (nb, bs, bs) inverted diagonal blocks
    n: int = static()

    def _apply(self, b, r):
        nb, bs, _ = b.shape
        pad = nb * bs - r.shape[0]
        rp = torch.nn.functional.pad(r, (0, pad)) if pad else r
        dt = torch.promote_types(b.dtype, r.dtype)
        z = torch.einsum("kij,kj->ki", b.to(dt), rp.reshape(nb, bs).to(dt))
        return z.reshape(-1)[: r.shape[0]]

    @psolve_span
    def psolve(self, r):
        return self._apply(self.binv, r)

    @psolve_span
    def psolveh(self, r):
        b = self.binv.transpose(1, 2)
        return self._apply(b.conj() if b.is_complex() else b, r)


def inv_blocks(blocks, singular="pinv"):
    """Invert (nb, bs, bs) diagonal blocks without raising on a singular
    block (lis_tpu ``inv_blocks``), so a matrix that is nonsingular overall
    never fails block Jacobi on one bad diagonal block.  ``singular`` picks
    the fallback: "pinv" for preconditioning (only convergence is
    affected) or "eye" for scaling, where a pseudo-inverse would make the
    scaled system singular: identity leaves those rows unscaled."""
    try:
        return np.linalg.inv(blocks)
    except np.linalg.LinAlgError:
        out = np.empty_like(blocks)
        bs = blocks.shape[1]
        for k in range(blocks.shape[0]):
            try:
                out[k] = np.linalg.inv(blocks[k])
            except np.linalg.LinAlgError:
                out[k] = (np.linalg.pinv(blocks[k]) if singular == "pinv"
                          else np.eye(bs, dtype=blocks.dtype))
        return out


def _diag_blocks(A, bs: int) -> np.ndarray:
    """The dense (nb, bs, bs) diagonal blocks of A, from its host CSR
    arrays.  A row with no entry in its block (the padding past n too) gets
    1 on the diagonal, so that every block inverse is well posed."""
    ptr, index, value = A.to_csr_arrays()
    n = A.nrows
    nb = -(-n // bs)
    blocks = np.zeros((nb, bs, bs), dtype=np.asarray(value).dtype)
    rows = np.repeat(np.arange(n), np.diff(ptr))
    same_block = rows // bs == index // bs
    r, c, v = rows[same_block], index[same_block], value[same_block]
    np.add.at(blocks, (r // bs, r % bs, c % bs), v)
    empty = np.abs(blocks).sum(axis=2) == 0            # (nb, bs)
    bi, ri = np.nonzero(empty)
    blocks[bi, ri, ri] = 1.0
    return blocks


@register_precon("bjacobi")
def create_bjacobi(A, opts):
    """Block Jacobi with dense diagonal blocks of a BSR operator's block
    size, else of size -storage_block (default 2)."""
    bs = getattr(A, "bnr", None) or getattr(opts, "storage_block", 2) or 2
    binv = inv_blocks(_diag_blocks(A, bs))
    return BlockJacobiPrecon(binv=torch.from_numpy(binv).to(A.device),
                             n=A.nrows)


@register_precon("jacobi")
def create_jacobi(A, opts):
    d = A.get_diagonal()
    nz = d != 0
    dinv = torch.where(nz, 1.0 / torch.where(nz, d, torch.ones_like(d)),
                       torch.ones_like(d))
    return JacobiPrecon(dinv=dinv)
