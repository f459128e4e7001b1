"""CSS — chunk-sorted select-stream storage for locality-free sparsity
(uniformly random patterns, power-law graphs), the last fallback of
``auto_storage``.

Port of ``lis_tpu/matrix/css.py``; the host build is unchanged, so both
packages produce equal arrays:

- columns are partitioned into chunks of width W (``x.view(NC, W)``);
  entries are sorted by chunk at build time and padded to a dense (NC, E)
  layout (E = per-chunk entry cap);
- the matvec reads each entry's x value from its own chunk's x slice.
  lis_tpu does that with a one-hot select-reduce because the TPU has no
  gather; here it is a row-local ``torch.gather`` on the (NC, W) view
  (lis_tpu has no Pallas kernel in this format, and none is written);
- the products land in their rows with one scatter-add (``index_add_``);
- hot chunks (power-law hubs) would blow up E, so entries beyond the cap
  go to a plain-CSR remainder (bounded to a small fraction).

``matvech`` routes through a transpose CSS built at construction time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import SparseMatrix, matrix_format, static, host
from lis_tpu_torch.matrix.csr import CSRMatrix, csr_scaled

W_DEFAULT = 128


@matrix_format("css")
class CSSMatrix(SparseMatrix):
    val: torch.Tensor         # (NC, E) entry values, 0 padding
    lidx: torch.Tensor        # (NC, E) int32 col-within-chunk, W padding
    rowf: torch.Tensor        # (NC*E,) int32 destination row, nrows padding
    rem: object               # CSRMatrix remainder (hot-chunk overflow)
    at: object                # CSSMatrix of Aᵀ (no nested .at) or None
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()
    W: int = static()

    @classmethod
    def profile(cls, index, ncols, W: int = W_DEFAULT,
                e_quantile: float = 0.995):
        """Acceptance statistics without building the matrix: the
        (fill_blowup, rem_frac) a from_csr_arrays call with the same
        parameters would produce, from one O(nnz) bincount."""
        index = np.asarray(index)
        nnz = max(len(index), 1)
        nc = -(-ncols // W)
        counts = np.bincount(index // W, minlength=nc)
        E = max(int(np.quantile(counts, e_quantile)) if len(counts) else 1,
                1)
        spill = int(np.maximum(counts - E, 0).sum())
        return nc * E / nnz, spill / nnz

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape, W: int = W_DEFAULT,
                        e_quantile: float = 0.995, transpose: bool = True,
                        device=None):
        return cls._build_host(ptr, index, value, shape, W, e_quantile,
                               transpose).to(resolve_device(device))

    @classmethod
    def _build_host(cls, ptr, index, value, shape, W, e_quantile, transpose):
        """``from_csr_arrays`` with every tensor on the CPU."""
        import scipy.sparse as sp
        ptr = np.asarray(host(ptr)).astype(np.int64)
        index = np.asarray(host(index)).astype(np.int64)
        value = np.asarray(host(value))
        n, m = shape
        nc = -(-m // W)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
        chunk = index // W

        counts = np.bincount(chunk, minlength=nc)
        # entry cap: cover the bulk densely, spill hub chunks to CSR
        E = int(np.quantile(counts, e_quantile)) if len(counts) else 1
        E = max(E, 1)
        # keep the first E entries per chunk (row-sorted within chunk
        # because the CSR input is row-major), spill the rest
        order = np.argsort(chunk, kind="stable")
        pos_in_chunk = np.arange(len(order)) - np.concatenate(
            [[0], np.cumsum(counts)])[chunk[order]]
        keep = pos_in_chunk < E
        ko, so = order[keep], order[~keep]

        val = np.zeros((nc, E), dtype=value.dtype)
        lidx = np.full((nc, E), W, dtype=np.int32)
        rowf = np.full((nc, E), n, dtype=np.int32)
        ck = chunk[ko]
        pk = pos_in_chunk[keep]
        val[ck, pk] = value[ko]
        lidx[ck, pk] = (index[ko] - ck * W).astype(np.int32)
        rowf[ck, pk] = rows[ko].astype(np.int32)

        rem = None
        if len(so):
            rm = sp.coo_matrix((value[so], (rows[so], index[so])),
                               shape=shape).tocsr()
            rm.sort_indices()
            rem = CSRMatrix.from_csr_arrays(rm.indptr, rm.indices, rm.data,
                                            shape, device="cpu")

        at = None
        if transpose:
            a = sp.csr_matrix((value, index, ptr), shape=shape).T.tocsr()
            a.sort_indices()
            at = cls._build_host(a.indptr, a.indices, a.data, (m, n), W,
                                 e_quantile, False)
        return cls(val=torch.from_numpy(val), lidx=torch.from_numpy(lidx),
                   rowf=torch.from_numpy(rowf.reshape(-1)), rem=rem, at=at,
                   nrows=int(n), ncols=int(m), nnz=int(len(value)), W=int(W))

    @property
    def fill_blowup(self) -> float:
        return self.val.numel() / max(self.nnz, 1)

    def to_csr_arrays(self):
        import scipy.sparse as sp
        v = host(self.val).reshape(-1)
        li = host(self.lidx).reshape(-1)
        rf = host(self.rowf)
        nc, E = self.val.shape
        c = np.repeat(np.arange(nc), E)
        ok = li < self.W
        a = sp.coo_matrix((v[ok], (rf[ok], c[ok] * self.W + li[ok])),
                          shape=self.shape).tocsr()
        if self.rem is not None:
            rp, ri, rv = self.rem.to_csr_arrays()
            a = (a + sp.csr_matrix((rv, ri, rp), shape=self.shape)).tocsr()
        a.sort_indices()
        return (a.indptr.astype(np.int32), a.indices.astype(np.int32),
                a.data)

    def _gather(self, x):
        """sel[c, e] = x[c*W + lidx[c, e]], 0 at padding (lidx == W): a
        gather within each chunk's own W-wide slice of x."""
        nc = self.val.shape[0]
        xc = torch.nn.functional.pad(
            x, (0, nc * self.W - self.ncols)).view(nc, self.W)
        pad = self.lidx >= self.W
        sel = torch.gather(xc, 1, self.lidx.clamp(max=self.W - 1).long())
        return sel.masked_fill(pad, 0)

    def _select(self, x):
        """contrib[c, e] = val[c, e] * x[c*W + lidx[c, e]]."""
        return self.val * self._gather(x)

    def matvec(self, x):
        # promote to the result dtype (never demote x: a complex vector
        # against a real matrix must stay complex)
        dt = torch.promote_types(x.dtype, self.val.dtype)
        contrib = self._select(x.to(dt))
        y = torch.zeros(self.nrows + 1, dtype=contrib.dtype, device=x.device)
        y = y.index_add_(0, self.rowf, contrib.reshape(-1))[: self.nrows]
        if self.rem is not None:
            y = y + self.rem.matvec(x)
        return y

    def matvech(self, x):
        if self.at is not None:
            # ``at`` was built from the full Aᵀ (including entries this
            # grid spilled to rem), so it is the complete transpose apply
            if self.val.is_complex():
                return torch.conj_physical(
                    self.at.matvec(torch.conj_physical(x)))
            return self.at.matvec(x)
        # fallback: gather x at rows, scatter into columns
        v = self.val.conj() if self.val.is_complex() else self.val
        xr = torch.nn.functional.pad(x, (0, 1))
        prod = v.reshape(-1) * xr.index_select(0, self.rowf)
        nc, E = self.val.shape
        c = torch.arange(nc, dtype=torch.int64,
                         device=x.device).repeat_interleave(E)
        col = torch.clamp(c * self.W + self.lidx.reshape(-1), max=self.ncols)
        y = torch.zeros(self.ncols + 1, dtype=prod.dtype, device=x.device)
        y = y.index_add_(0, col, prod)[: self.ncols]
        if self.rem is not None:
            y = y + self.rem.matvech(x)
        return y

    def get_diagonal(self):
        nc, E = self.val.shape
        li = self.lidx.reshape(-1)
        c = torch.arange(nc, dtype=torch.int64,
                         device=li.device).repeat_interleave(E)
        col = c * self.W + li.clamp(max=self.W - 1)
        isdiag = (col == self.rowf) & (li < self.W)
        d = torch.zeros(self.nrows + 1, dtype=self.val.dtype,
                        device=li.device)
        d = d.index_add_(0, self.rowf, self.val.reshape(-1) * isdiag)
        d = d[: self.nrows]
        if self.rem is not None:
            d = d + self.rem.get_diagonal()
        return d

    # ---- scaling (setup-time, once per solve) ---------------------------
    def _row_factor(self, d):
        dr = torch.nn.functional.pad(d, (0, 1))      # rowf == nrows padding
        return dr.index_select(0, self.rowf).view(self.val.shape)

    def _col_factor(self, d):
        return self._gather(d)

    def _scaled(self, row_d=None, col_d=None):
        v = self.val
        if row_d is not None:
            v = v * self._row_factor(row_d).to(v.dtype)
        if col_d is not None:
            v = v * self._col_factor(col_d).to(v.dtype)
        rem = None if self.rem is None else csr_scaled(self.rem, row_d, col_d)
        return dataclasses.replace(self, val=v, rem=rem)

    def scale_rows(self, d):
        out = self._scaled(row_d=d)
        if self.at is not None:   # rows of A = columns of Aᵀ
            out = dataclasses.replace(out, at=self.at._scaled(col_d=d))
        return out

    def scale_symm(self, dsqrt_inv):
        out = self._scaled(row_d=dsqrt_inv, col_d=dsqrt_inv)
        if self.at is not None:
            out = dataclasses.replace(
                out, at=self.at._scaled(row_d=dsqrt_inv, col_d=dsqrt_inv))
        return out
