"""CST — chunk-sorted, transpose-routed SpMV for locality-free sparsity.

Port of ``lis_tpu/matrix/cst.py``.  The slot grid is the same: columns
are chunked by 128; entries are bucketed by (column chunk, row block)
with a per-bucket cap ``beta``; M = n_pad * Kp slots serve both the
chunk-major source layout and the ELL row-major destination layout, and
a build-time Benes plan (ops/shuffle.py) moves products from one to the
other.  Bucket overflow (> beta) and row overflow (> Kp) spill to a
plain-CSR remainder.  The host build is ported unchanged, so both
packages produce equal arrays and plans.

``matvec`` on a CUDA tensor runs three hand-written kernels and one plain
torch remainder:

1. ``cst_front`` (kernel A): select x by lane id, times val, written in
   the transposed (RBc, CB, beta) bucket order;
2. ``plan.apply_rowsum``: Benes passes and the ELL row sums (kernels B,
   C, D);
3. the CSR remainder (gather x value, row segment-sum in plain torch).

``matvech`` routes through the transpose grid ``at`` built with the
matrix; without one it falls back to one plain scatter-add.
"""

from __future__ import annotations

import numpy as np
import torch

from lis_tpu_torch.matrix.base import SparseMatrix, matrix_format, static, host
from lis_tpu_torch.ops import _cuda
from lis_tpu_torch.ops.shuffle import ShufflePlan, block_digits, plan_shuffle


def _next_pow2(x: int) -> int:
    return 1 << max(int(x - 1).bit_length(), 0)


def _cumcount(keys: np.ndarray) -> np.ndarray:
    """Position within its group for an array sorted by ``keys``."""
    n = len(keys)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    idx = np.arange(n, dtype=np.int64)
    first = np.r_[True, keys[1:] != keys[:-1]]
    return idx - np.maximum.accumulate(np.where(first, idx, 0))


def _spread(rank, group, size):
    """Per-group affine bijection rank -> slot on [0, size) (pow2):
    slot = (a_g * rank + c_g) mod size with a_g odd."""
    g = group.astype(np.uint64)
    h = (g * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(17)
    a = (h | np.uint64(1)) & np.uint64(size - 1)
    c = (g * np.uint64(0xC2B2AE3D27D4EB4F)) >> np.uint64(31)
    return ((a * rank.astype(np.uint64) + c)
            & np.uint64(size - 1)).astype(np.int64)


def _front_plain(xp, lidx, val, RBc, beta):
    CB = xp.numel() // 128
    sel = torch.gather(xp.view(CB, 128), 1, lidx.reshape(CB, -1).long())
    t = sel * val.reshape(CB, -1)
    return t.view(CB, RBc, beta).transpose(0, 1).reshape(-1)


def cst_front(xp: torch.Tensor, lidx: torch.Tensor, val: torch.Tensor,
              RBc: int, beta: int) -> torch.Tensor:
    """``t[r, c, j] = xp[128c + lidx[c, r*beta + j]] * val[c, r*beta + j]``
    flattened, with lidx/val viewed (CB, RBc*beta) and CB = len(xp)/128.

    Kernel A replaces lis_tpu ``CSTMatrix._fused_front``
    (matrix/cst.py:259).  Bound on the H100: bytes — per slot 8 B of val
    and 1 B of lidx read, 8 B of t written (f64).  One block per (chunk,
    4096-slot segment): the chunk's 128 x values and the lidx segment
    (16-byte loads) sit in shared memory, val and t stream coalesced, and
    the bucket transpose is only the output offset."""
    if not xp.is_cuda:
        if xp.device.type != "cpu":
            raise ValueError(f"no kernel or plain path for {xp.device}")
        return _front_plain(xp, lidx, val, RBc, beta)
    CB = xp.numel() // 128
    row_len = RBc * beta
    _cuda.check(xp, "xp", (torch.float32, torch.float64), CB * 128)
    _cuda.check(val, "val", xp.dtype, CB * row_len)
    _cuda.check(lidx, "lidx", torch.uint8, CB * row_len)
    if beta & (beta - 1) or row_len & (row_len - 1) or row_len < 16:
        raise ValueError(f"cst_front: bad grid RBc={RBc}, beta={beta}")
    out = torch.empty(CB * row_len, dtype=xp.dtype, device=xp.device)
    _cuda.launch("lis_cst_front", _cuda.DTYPE_CODE[xp.dtype],
                 xp.data_ptr(), lidx.data_ptr(), val.data_ptr(),
                 out.data_ptr(), CB, RBc, beta, row_len, _cuda.stream())
    cst_front.launches += 1
    return out


cst_front.launches = 0


@matrix_format("cst")
class CSTMatrix(SparseMatrix):
    val: torch.Tensor         # (M/128, 128) entry values in src order
    lidx: torch.Tensor        # (M/128, 128) uint8 col-within-chunk
    rowf: torch.Tensor        # (M,) int32 destination row (nrows padding)
    plan: ShufflePlan         # post-transpose slot -> ELL slot
    diag: torch.Tensor        # (nrows,) diagonal (build-time)
    rem: object               # CSRMatrix remainder or None
    at: object                # CSTMatrix of A^T (no nested .at) or None
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()
    n_pad: int = static()     # power of two >= max(nrows, ncols)
    Kp: int = static()        # ELL width (power of two)
    beta: int = static()      # per-(chunk, row-block) bucket cap
    RBc: int = static()       # row blocks

    # ------------------------------------------------------------------
    @classmethod
    def profile(cls, ptr, index, shape, load: float = 0.72,
                Kp: int | None = None):
        """(fill_blowup, rem_frac) estimate without building: one
        bincount over buckets + row lengths."""
        ptr = np.asarray(ptr, dtype=np.int64)
        index = np.asarray(index, dtype=np.int64)
        n, m = shape
        nnz = max(ptr[-1], 1)
        n_pad = _next_pow2(max(n, m, 128 * 128))
        Kp = Kp or cls._pick_kp(nnz / max(n, 1), load)
        M = n_pad * Kp
        L = min(M, 1 << 21) if M >= (1 << 21) else (1 << 14)
        RB = L // Kp
        CB = n_pad // 128
        beta = L // CB
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
        bucket = (index >> 7) * (M // L) + rows // RB
        bc = np.bincount(bucket, minlength=1)
        spill_b = np.maximum(bc - beta, 0).sum()
        rl = np.diff(ptr)
        spill_r = np.maximum(rl - Kp, 0).sum()
        return M / nnz, (spill_b + spill_r) / nnz

    @staticmethod
    def _pick_kp(mean_k: float, load: float = 0.72) -> int:
        Kp = _next_pow2(int(np.ceil(max(mean_k, 1.0))))
        while mean_k / Kp > load:
            Kp *= 2
        return min(max(Kp, 2), 256)

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape,
                        transpose: bool = True, load: float = 0.72,
                        Kp: int | None = None, n_pad: int | None = None):
        """Build on the CPU from host CSR arrays (``.to(device)`` moves
        it).  ``Kp``/``n_pad`` override the derived grid parameters;
        ``transpose`` also builds the grid of A^T for ``matvech``."""
        import scipy.sparse as sp
        from lis_tpu_torch.matrix.csr import CSRMatrix
        ptr = np.asarray(host(ptr)).astype(np.int64)
        index = np.asarray(host(index)).astype(np.int64)
        value = np.asarray(host(value))
        n, m = shape
        nnz = len(value)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))

        n_pad = n_pad or _next_pow2(max(n, m, 128 * 128))
        Kp = Kp or cls._pick_kp(nnz / max(n, 1), load)
        M = n_pad * Kp
        L = min(M, 1 << 21) if M >= (1 << 21) else (1 << 14)
        RB = L // Kp                  # rows per block
        RBc = M // L                  # number of row blocks
        CB = n_pad // 128             # column chunks
        beta = L // CB                # bucket cap

        cb = index >> 7
        rb = rows // RB
        bucket = cb * RBc + rb
        order = np.argsort(bucket, kind="stable")
        sl = np.empty(nnz, dtype=np.int64)
        sl[order] = _cumcount(bucket[order])
        keep = sl < beta
        # ELL slot within the row (entries are row-major in CSR order)
        kslot = np.full(nnz, Kp, dtype=np.int64)
        kk = _cumcount(rows[keep])
        keep2 = kk < Kp
        kslot[np.flatnonzero(keep)[keep2]] = kk[keep2]
        kept = keep.copy()
        kept[np.flatnonzero(keep)[~keep2]] = False
        # spread ranks pseudo-uniformly over the slot range: packed low
        # slots would cluster occupancy and starve the randomized Benes
        # routing of the slack it relies on
        sl = _spread(sl, bucket, beta)
        kslot = np.where(kslot < Kp, _spread(kslot, rows, Kp), Kp)

        r_, c_, v_ = rows[kept], index[kept], value[kept]
        cbk, rbk, slk = cb[kept], rb[kept], sl[kept]
        src = cbk * (RBc * beta) + rbk * beta + slk
        pos_t = rbk * (CB * beta) + cbk * beta + slk
        dst = r_ * Kp + kslot[kept]
        perm = np.full(M, -1, dtype=np.int64)
        perm[pos_t] = dst
        # exact_holes: every pass stays a true per-row permutation, so
        # hole slots (val = 0 at their sources) carry zeros to every
        # unreal destination and the row sums need no mask
        plan = plan_shuffle(perm, digits=block_digits(M, L),
                            validate=False, exact_holes=True)

        val = np.zeros(M, dtype=value.dtype)
        val[src] = v_
        li = np.zeros(M, dtype=np.uint8)
        li[src] = (c_ & 127).astype(np.uint8)
        rf = np.full(M, n, dtype=np.int32)
        rf[src] = r_.astype(np.int32)

        rem = None
        if (~kept).any():
            so = np.flatnonzero(~kept)
            rm = sp.coo_matrix((value[so], (rows[so], index[so])),
                               shape=shape).tocsr()
            rm.sort_indices()
            rem = CSRMatrix.from_csr_arrays(rm.indptr, rm.indices, rm.data,
                                            shape)

        d = np.zeros(n, dtype=value.dtype)
        dm = rows == index
        np.add.at(d, rows[dm], value[dm])

        at = None
        if transpose:
            a = sp.csr_matrix((value, index, ptr), shape=shape).T.tocsr()
            a.sort_indices()
            at = cls.from_csr_arrays(a.indptr, a.indices, a.data, (m, n),
                                     transpose=False, load=load)
        return cls(val=torch.from_numpy(val.reshape(-1, 128)),
                   lidx=torch.from_numpy(li.reshape(-1, 128)),
                   rowf=torch.from_numpy(rf), plan=plan,
                   diag=torch.from_numpy(d), rem=rem, at=at,
                   nrows=int(n), ncols=int(m), nnz=int(nnz),
                   n_pad=int(n_pad), Kp=int(Kp), beta=int(beta),
                   RBc=int(RBc))

    # ------------------------------------------------------------------
    def matvec(self, x):
        dt = torch.promote_types(x.dtype, self.val.dtype)
        xp = torch.nn.functional.pad(x.to(dt), (0, self.n_pad - x.shape[0]))
        t = cst_front(xp, self.lidx, self.val.to(dt), self.RBc, self.beta)
        # exact-holes plan: unreal slots carry zeros, so the row sums need
        # no destination mask (see from_csr_arrays)
        y = self.plan.apply_rowsum(t, self.Kp)[: self.nrows]
        if self.rem is not None:
            y = y + self.rem.matvec(x)
        return y

    def matvech(self, x):
        if self.at is not None:
            # ``at`` was built from the FULL A^T, spilled entries included
            if self.val.is_complex():
                return self.at.matvec(x.conj()).conj()
            return self.at.matvec(x)
        # no transpose grid: one plain scatter-add, A^H x = sum over
        # entries of conj(val) * x[row] into their columns.  (lis_tpu
        # also conjugates x here, which is wrong for complex data.)
        val = self.val.reshape(-1)
        if val.is_complex():
            val = val.conj()
        xr = torch.nn.functional.pad(x, (0, 1)).index_select(
            0, self.rowf.clamp(max=self.nrows))
        contrib = val * xr
        slot = torch.arange(self.n_pad * self.Kp, device=val.device)
        cols = (slot // (self.Kp * 128)) * 128 + self.lidx.reshape(-1).long()
        y = torch.zeros(self.n_pad, dtype=contrib.dtype, device=val.device)
        y = y.index_add_(0, cols, contrib)[: self.ncols]
        if self.rem is not None:
            y = y + self.rem.matvech(x)
        return y

    def get_diagonal(self):
        return self.diag

    def to_csr_arrays(self):
        import scipy.sparse as sp
        v = host(self.val).reshape(-1)
        li = host(self.lidx).reshape(-1).astype(np.int64)
        rf = host(self.rowf).astype(np.int64)
        slot = np.arange(self.n_pad * self.Kp, dtype=np.int64)
        chunk = slot // (self.Kp * 128)
        ok = rf < self.nrows
        a = sp.coo_matrix((v[ok], (rf[ok], chunk[ok] * 128 + li[ok])),
                          shape=self.shape).tocsr()
        if self.rem is not None:
            rp, ri, rv = self.rem.to_csr_arrays()
            a = (a + sp.csr_matrix((rv, ri, rp), shape=self.shape)).tocsr()
        a.sort_indices()
        return (a.indptr.astype(np.int32), a.indices.astype(np.int32),
                a.data)

    def scale_rows(self, d):
        raise NotImplementedError(
            "CST scaling needs the select kernel (#1), not ported yet "
            "(ROADMAP.md queue 1 item 3); scale the CSR operator before "
            "converting, as solve() does")

    scale_symm = scale_rows
