"""BSR — block sparse row.

Port of ``lis_tpu/matrix/bsr.py`` (reference src/matrix/lis_matrix_bsr.c,
unrolled kernels src/matvec/lis_matvec_bsr.c:57+); the host build is
unchanged, so both packages produce equal arrays.  Two layouts:

- **windowed slabs** where the block structure is band-local: blocks live
  dense in up to ``max_windows`` (nr, Wb, bnr, bnc) slabs, each over a
  sliding block-column window [t + c0, t + c0 + Wb), the windows found by
  run-clustering the block-displacement histogram (``_select_windows``);
  the matvec reads x through a strided view of the padded x (no gather)
  and contracts each window with one einsum;
- **spill** for the blocks outside every window: the x blocks gathered
  with ``index_select``, batched block products, and a sorted segment sum
  with ``index_add_``.

Rows and columns are zero-padded up to a multiple of the block size at
construction and sliced back after a product.  lis_tpu has no Pallas
kernel here; the products are torch operations (a kernel for the block
formats is ROADMAP.md queue 1 item 14).
"""

from __future__ import annotations

import numpy as np
import torch

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import (SparseMatrix, as_tensor, conj, host,
                                       matrix_format, static)


def _select_windows(disp, nr, max_windows, w_max, gap_max=2,
                    min_frac=0.02, blowup_max=8.0):
    """Run-cluster the distinct block displacements into windows (lis_tpu
    bsr.py:37-77): (c0, Wb) windows in order of coverage, at most
    ``max_windows``; a run whose slab would hold more than ``blowup_max``
    slots per block it covers is left to the spill."""
    uniq, counts = np.unique(disp, return_counts=True)
    runs = []  # (count, lo, hi)
    lo = hi = int(uniq[0])
    cnt = int(counts[0])
    for u, c in zip(uniq[1:], counts[1:]):
        u = int(u)
        if u - hi <= gap_max and u - lo + 1 <= w_max:
            hi = u
            cnt += int(c)
        else:
            runs.append((cnt, lo, hi))
            lo = hi = u
            cnt = int(c)
    runs.append((cnt, lo, hi))
    runs.sort(reverse=True)
    total = len(disp)
    out = []
    for cnt, lo, hi in runs:
        if len(out) >= max_windows:
            break
        if cnt < min_frac * total and out:
            break
        Wb = hi - lo + 1
        if nr * Wb > blowup_max * cnt:
            continue
        out.append((lo, Wb))
    return out


def _padded(x, n: int):
    """x zero-padded to length n."""
    if x.shape[0] == n:
        return x
    return torch.cat([x, x.new_zeros(n - x.shape[0])])


@matrix_format("bsr")
class BSRMatrix(SparseMatrix):
    bptr: torch.Tensor        # (nr+1,) int32
    bindex: torch.Tensor      # (bnnz,) int32 block columns (spill)
    value: torch.Tensor       # (bnnz, bnr, bnc) spill blocks
    brow_ids: torch.Tensor    # (bnnz,) int32 (spill)
    slabs: tuple              # (nr, Wb_i, bnr, bnc) window slabs
    nrows: int = static()     # the unpadded row count
    ncols: int = static()
    nnz: int = static()
    bnr: int = static()
    bnc: int = static()
    nr: int = static()        # block rows
    nc: int = static()        # block columns
    c0s: tuple = static()     # each window's start offset (blocks)
    has_spill: bool = static()  # any blocks outside the windows

    def _rebuild_kwargs(self):
        return {"bnr": self.bnr, "bnc": self.bnc}

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape, bnr: int = 2,
                        bnc: int | None = None, w_max: int = 64,
                        max_windows: int = 8, device=None) -> "BSRMatrix":
        import scipy.sparse as sp
        bnc = bnc or bnr
        ptr, index, value = host(ptr), host(index), host(value)
        n, m = shape
        nr, nc = -(-n // bnr), -(-m // bnc)
        a = sp.csr_matrix((value, index, ptr), shape=shape)
        a.resize((nr * bnr, nc * bnc))
        b = sp.bsr_matrix(a, blocksize=(bnr, bnc))
        b.sort_indices()
        brow = np.repeat(np.arange(nr, dtype=np.int64), np.diff(b.indptr))
        bidx = b.indices.astype(np.int64)
        disp = bidx - brow
        slabs, c0s = [], []
        spill = np.ones(len(disp), dtype=bool)
        if len(disp) and nr * bnr == nc * bnc:
            for c0, Wb in _select_windows(disp, nr, max_windows, w_max):
                fits = spill & (disp >= c0) & (disp < c0 + Wb)
                slab = np.zeros((nr, Wb, bnr, bnc), dtype=b.data.dtype)
                slab[brow[fits], disp[fits] - c0] = b.data[fits]
                slabs.append(torch.from_numpy(slab))
                c0s.append(int(c0))
                spill &= ~fits
        bdat, bidx_k, brow_k = b.data[spill], bidx[spill], brow[spill]
        has_spill = len(bdat) > 0
        if not has_spill:   # shape-stable placeholders, skipped in matvec
            bdat = np.zeros((1, bnr, bnc), dtype=b.data.dtype)
            bidx_k = np.zeros(1, np.int64)
            brow_k = np.zeros(1, np.int64)
        out = cls(bptr=as_tensor(b.indptr, np.int32),
                  bindex=as_tensor(bidx_k, np.int32),
                  value=as_tensor(bdat), brow_ids=as_tensor(brow_k, np.int32),
                  slabs=tuple(slabs), nrows=int(n), ncols=int(m),
                  nnz=int(len(value)), bnr=int(bnr), bnc=int(bnc), nr=nr,
                  nc=nc, c0s=tuple(c0s), has_spill=bool(has_spill))
        return out.to(resolve_device(device))

    def to_csr_arrays(self):
        return self._cached_csr(self._csr_of)

    def _csr_of(self):
        import scipy.sparse as sp
        pshape = (self.nr * self.bnr, self.nc * self.bnc)
        acc = sp.csr_matrix(pshape, dtype=host(self.value).dtype)
        for slab, c0 in zip(self.slabs, self.c0s):
            s = host(slab)
            t, w, i, j = np.nonzero(s)
            grow = t * self.bnr + i
            gcol = (t + c0 + w) * self.bnc + j
            ok = (gcol >= 0) & (gcol < pshape[1])
            acc = (acc + sp.coo_matrix((s[t, w, i, j][ok],
                                        (grow[ok], gcol[ok])),
                                       shape=pshape).tocsr()).tocsr()
        if self.has_spill:
            v = host(self.value)
            bi, br = host(self.bindex), host(self.brow_ids)
            k, i, j = np.nonzero(v)
            acc = (acc + sp.coo_matrix(
                (v[k, i, j], (br[k] * self.bnr + i, bi[k] * self.bnc + j)),
                shape=pshape).tocsr()).tocsr()
        acc.resize(self.shape)
        a = acc.tocsr()
        a.eliminate_zeros()
        a.sort_indices()
        return a.indptr.astype(np.int32), a.indices.astype(np.int32), a.data

    def _bounds(self, c0, Wb):
        lo = max(-c0, 0)
        hi = max((self.nr - 1) + c0 + Wb - self.nc, 0) + 1
        return lo, hi

    def _xwindows(self, xp, c0, Wb):
        """(nr, Wb, bnc) sliding block windows of the padded x, a strided
        view: ``xw[t, w] = x block t + c0 + w`` (no gather)."""
        lo, hi = self._bounds(c0, Wb)
        bnc = self.bnc
        xpad = torch.cat([xp.new_zeros(lo * bnc), xp,
                          xp.new_zeros(hi * bnc)])
        return xpad.as_strided((self.nr, Wb, bnc), (bnc, bnc, 1),
                               (c0 + lo) * bnc)

    def matvec(self, x):
        xp = _padded(x, self.nc * self.bnc)
        y = None
        for slab, c0 in zip(self.slabs, self.c0s):
            dt = torch.promote_types(xp.dtype, slab.dtype)
            xw = self._xwindows(xp.to(dt), c0, slab.shape[1])
            t = torch.einsum("twij,twj->ti", slab.to(dt), xw)
            y = t if y is None else y + t
        if self.has_spill or y is None:
            xg = xp.view(self.nc, self.bnc).index_select(0, self.bindex)
            dt = torch.promote_types(xg.dtype, self.value.dtype)
            yb = torch.einsum("kij,kj->ki", self.value.to(dt), xg.to(dt))
            yg = torch.zeros(self.nr, self.bnr, dtype=dt, device=yb.device)
            yg.index_add_(0, self.brow_ids, yb)
            y = yg if y is None else y + yg
        return y.reshape(-1)[: self.nrows]

    def matvech(self, x):
        xb = _padded(x, self.nr * self.bnr).view(self.nr, self.bnr)
        bnc = self.bnc
        y = None
        for slab, c0 in zip(self.slabs, self.c0s):
            Wb = slab.shape[1]
            dt = torch.promote_types(xb.dtype, slab.dtype)
            z = torch.einsum("twij,ti->twj", conj(slab).to(dt), xb.to(dt))
            lo, hi = self._bounds(c0, Wb)
            base = (c0 + lo) * bnc
            yo = torch.zeros((lo + self.nc + hi) * bnc, dtype=dt,
                             device=z.device)
            span = self.nr * bnc
            for w in range(Wb):        # the overlap-add, window by window
                yo[base + w * bnc: base + w * bnc + span] += \
                    z[:, w].reshape(-1)
            t = yo[lo * bnc: (lo + self.nc) * bnc]
            y = t if y is None else y + t
        if self.has_spill or y is None:
            xg = xb.index_select(0, self.brow_ids)
            dt = torch.promote_types(xg.dtype, self.value.dtype)
            yb = torch.einsum("kij,ki->kj", conj(self.value).to(dt),
                              xg.to(dt))
            yg = torch.zeros(self.nc, bnc, dtype=dt, device=yb.device)
            yg = yg.index_add_(0, self.bindex, yb).reshape(-1)
            y = yg if y is None else y + yg
        return y[: self.ncols]
