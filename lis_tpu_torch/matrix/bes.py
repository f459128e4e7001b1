"""BES — dense sliding-window slabs for general banded sparsity.

Port of ``lis_tpu/matrix/bes.py``; the host build is unchanged, so both
packages produce equal arrays (``W``, ``c0``, ``stride``, slab and CSR
remainder):

- rows in blocks of R = 128; block t owns the x-window
  [t·s + c0, t·s + c0 + W), which slides affinely with t (s, the column
  stride, is R for a square band and the slope ncols/nrows·R for a
  rectangular operator such as an AMG prolongator);
- the block's entries are stored dense in a (T, W, R) slab,
  ``slab[t, w, r] = A[t·R + r, t·s + c0 + w]``; W comes from a cost model
  over the displacement histogram (slab slots against gathers), capped by
  ``w_max`` and a byte budget;
- entries outside the window fall to a CSR remainder.

lis_tpu has no Pallas kernel here (XLA fuses its loops), so on a CUDA
tensor ``matvec`` is kernel Q (``bes_spmv``) and ``matvech`` kernel R
(``bes_spmvh``), hand-written in ``csrc/bes.cu``; on a CPU tensor each
takes its plain version below, in lis_tpu's order of summation over the
dense slab.  The kernels read the slab's nonzeros from its compact form
(``BESPack``, derived by ``bes_pack`` from the slab where the matrix
lands: ``BESMatrix.to`` derives it, scaling derives it again), not the
mostly-zero slab, which stays the format's array.  Unlike lis_tpu's
matvec (bes.py:185-186), which casts x to the slab's type and so drops a
complex x's imaginary part on a real slab, both promote x to the result
type.

``MultiBESMatrix`` (format name ``mbes``) sums a few BES slabs of one
stride at different intercepts: the few affine bands of a 3-D stencil or
of its prolongators.  ``multi_bes_from_csr`` builds it greedily and raises
``NothingCovers`` when there is no entry to cover.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import (SparseMatrix, TensorFields, conj,
                                       host, matrix_format, static)
from lis_tpu_torch.matrix.csr import CSRMatrix, csr_scaled
from lis_tpu_torch.matrix.dia import _kernel_operands
from lis_tpu_torch.ops import _cuda

R_DEFAULT = 128


class NothingCovers(ValueError):
    """``multi_bes_from_csr`` found no entry to cover (an empty matrix)."""


# ---- kernels Q and R and their plain versions --------------------------------

def _pad(x, lo: int, hi: int):
    """x with ``lo`` zeros before it and ``hi`` after."""
    z = x.new_zeros
    return torch.cat([z(lo), x, z(hi)])


def _span(T: int, s: int, W: int, c0: int, ncols: int):
    """(lo, hi, base) of lis_tpu's padded window copy (bes.py:172-176)."""
    lo = max(-c0, 0)
    hi = max((T - 1) * s + c0 + W - ncols, 0) + s
    return lo, hi, c0 + lo


def _windows(x, T: int, s: int, W: int, c0: int, ncols: int):
    """(T, W) sliding windows ``xw[t, j] = x[t·s + c0 + j]`` (0 outside
    [0, ncols)) from W/s shifted contiguous views of the padded x."""
    lo, hi, base = _span(T, s, W, c0, ncols)
    xpad = _pad(x, lo, hi)
    return torch.cat([xpad[base + c * s: base + c * s + T * s].view(T, s)
                      for c in range(W // s)], dim=1)


def _spmv_plain(slab, x, c0: int, s: int, nrows: int, ncols: int):
    """Q's plain version: ``y[t·R + r] = Σ_w slab[t, w, r]·x[t·s + c0 + w]``,
    the sum over the slab's axis 1 (lis_tpu's ``jnp.sum(axis=1)``)."""
    T, W, R = slab.shape
    dt = torch.promote_types(slab.dtype, x.dtype)
    xw = _windows(x.to(dt), T, s, W, c0, ncols)
    return (slab * xw[:, :, None]).sum(dim=1).reshape(-1)[:nrows]


def _spmvh_plain(slab, x, c0: int, s: int, nrows: int, ncols: int):
    """R's plain version: the windows ``win[t, w] = Σ_r conj(slab[t, w, r])
    ·x[t·R + r]``, then their overlap-add, W/s shifted adds in order."""
    T, W, R = slab.shape
    dt = torch.promote_types(slab.dtype, x.dtype)
    xr = _pad(x.to(dt), 0, T * R - nrows).view(T, R)
    win = (conj(slab) * xr[:, None, :]).sum(dim=2)
    lo, hi, base = _span(T, s, W, c0, ncols)
    y = torch.zeros(lo + ncols + hi, dtype=win.dtype, device=win.device)
    for c in range(W // s):
        y[base + c * s: base + c * s + T * s] += \
            win[:, c * s:(c + 1) * s].reshape(-1)
    return y[lo: lo + ncols]


# ---- the compact form ------------------------------------------------------

W_MAX_COMPACT = 32767       # 16-bit window offsets and list lengths
SLICE = 32                  # lists a slice: one warp's rows or columns


@dataclasses.dataclass(frozen=True, eq=False)
class BESPack(TensorFields):
    """The (T, W, R) slab's nonzeros as lists, in the layout kernels Q and
    R read (``csrc/bes.cu``): sliced ELL, the lists of a tile cut in
    slices of ``SLICE`` (a warp's), each slice a column-major block as
    wide as its longest list.  With g = t·⌈A/32⌉ + a // 32 the slice of
    list a of tile t, the list's k-th entry lies at ``ptr[g] + 32·k +
    a % 32``:

    - Q's lists (A = R): row r's nonzero slots in increasing w, value
      ``qval`` and window offset ``qoff`` (uint8 where W ≤ 256, else
      int16), the row's length ``qlen[t·R + r]``;
    - R's lists (A = W): window column w's nonzero rows in increasing r,
      value ``hval`` and row offset ``hoff`` (uint8 where R ≤ 256, else
      int16), the column's length ``hlen[t·W + w]``.

    Exact zeros are left out; a pad (past a list's length) holds 0 at
    offset 0 and is never read.  The arrays are checked once, when a pack
    is made (``bes_pack``, a move, a cast)."""
    qval: torch.Tensor
    qoff: torch.Tensor
    qlen: torch.Tensor        # (T·R,) int16
    qptr: torch.Tensor        # (T·⌈R/32⌉ + 1,) int64
    hval: torch.Tensor
    hoff: torch.Tensor
    hlen: torch.Tensor        # (T·W,) int16
    hptr: torch.Tensor        # (T·⌈W/32⌉ + 1,) int64
    T: int = static()
    W: int = static()
    R: int = static()

    def __post_init__(self):
        arrays = [getattr(self, f.name) for f in dataclasses.fields(self)
                  if not f.metadata.get("static")]
        if len({a.device for a in arrays}) != 1 or \
                not all(a.is_contiguous() for a in arrays):
            raise ValueError("BESPack: arrays must be contiguous, on one "
                             "device")
        want = {"qoff": _offset_dtype(self.W), "hoff": _offset_dtype(self.R),
                "qlen": torch.int16, "hlen": torch.int16,
                "qptr": torch.int64, "hptr": torch.int64,
                "hval": self.qval.dtype}
        for name, dt in want.items():
            if getattr(self, name).dtype != dt:
                raise ValueError(f"BESPack: {name} is "
                                 f"{getattr(self, name).dtype}, expected {dt}")
        T, W, R = self.T, self.W, self.R
        if (self.qlen.numel(), self.hlen.numel(), self.qptr.numel(),
                self.hptr.numel()) != (T * R, T * W, T * _slices(R) + 1,
                                       T * _slices(W) + 1) or \
                self.qval.numel() != self.qoff.numel() or \
                self.hval.numel() != self.hoff.numel():
            raise ValueError("BESPack: array sizes do not match "
                             f"(T, W, R) = {(T, W, R)}")

    def nbytes(self) -> int:
        return sum(getattr(self, f.name).nbytes
                   for f in dataclasses.fields(self)
                   if not f.metadata.get("static"))


def _offset_dtype(extent: int):
    return torch.uint8 if extent <= 256 else torch.int16


def _slices(extent: int) -> int:
    return -(-extent // SLICE)


def _lists(v, mask):
    """The lists of the (T, A, B) view ``v`` along its last axis, sliced
    (``BESPack``): (values, B offsets, lengths (T·A,), ptr)."""
    T, A, B = v.shape
    t, a, b = mask.nonzero(as_tuple=True)       # each list in increasing b
    key = t * A + a
    lens = torch.bincount(key, minlength=T * A)
    k = torch.arange(len(key), device=v.device) - (lens.cumsum(0) - lens)[key]
    ns = _slices(A)
    padded = lens.new_zeros(T, ns * SLICE)
    padded[:, :A] = lens.view(T, A)
    ptr = torch.zeros(T * ns + 1, dtype=torch.int64, device=v.device)
    ptr[1:] = torch.cumsum(padded.view(T * ns, SLICE).amax(dim=1) * SLICE, 0)
    pos = ptr[t * ns + a // SLICE] + k * SLICE + a % SLICE
    n = int(ptr[-1])
    val = v.new_zeros(n)
    val[pos] = v[t, a, b]
    off = torch.zeros(n, dtype=_offset_dtype(B), device=v.device)
    off[pos] = b.to(off.dtype)
    return val, off, lens.to(torch.int16), ptr


def bes_pack(slab: torch.Tensor) -> BESPack:
    """The compact form of a (T, W, R) slab, on the slab's device, by torch
    operations over the slab (no host pass)."""
    T, W, R = slab.shape
    if W > W_MAX_COMPACT:
        raise ValueError(f"bes_pack: W = {W} is above {W_MAX_COMPACT}, "
                         f"the widest window the kernels take")
    nz = slab != 0
    qval, qoff, qlen, qptr = _lists(slab.transpose(1, 2), nz.transpose(1, 2))
    hval, hoff, hlen, hptr = _lists(slab, nz)
    return BESPack(qval=qval, qoff=qoff, qlen=qlen, qptr=qptr, hval=hval,
                   hoff=hoff, hlen=hlen, hptr=hptr, T=T, W=W, R=R)


# ---- kernels Q and R over the compact form ------------------------------

def _launch(name, fn, val, off, lens, ptr, x, shape, c0, s, nrows, ncols,
            out_len, work_len):
    val, x = _kernel_operands(val, x)
    T, W, R = shape
    _cuda.check(x, "x", aligned=False)
    y = torch.empty(out_len, dtype=x.dtype, device=x.device)
    work = torch.empty(work_len, dtype=x.dtype, device=x.device)
    _cuda.launch(name, _cuda.DTYPE_CODE[val.dtype], _cuda.DTYPE_CODE[x.dtype],
                 0 if off.dtype == torch.uint8 else 1, val.data_ptr(),
                 off.data_ptr(), lens.data_ptr(), ptr.data_ptr(),
                 x.data_ptr(), y.data_ptr(), work.data_ptr(), T, W, R, s, c0,
                 nrows, ncols, _cuda.stream())
    fn.launches += 1
    return y


def _checked(name, slab, pack, x, want, s):
    if slab.dim() != 3:
        raise ValueError(f"{name}: slab must be (T, W, R)")
    if x.shape != (want,):
        raise ValueError(f"{name}: x has shape {tuple(x.shape)}, expected "
                         f"({want},)")
    if s < 1:
        raise ValueError(f"{name}: the stride must be positive")
    if x.is_cuda:
        if pack is None or (pack.T, pack.W, pack.R) != tuple(slab.shape) \
                or pack.qval.dtype != slab.dtype \
                or pack.qval.device != x.device:
            raise ValueError(f"{name}: the slab has no compact form on "
                             f"{x.device} that matches it (bes_pack)")
        return True
    if x.device.type != "cpu":
        raise ValueError(f"no kernel or plain path for {x.device}")
    return False


def bes_spmv(slab: torch.Tensor, pack, x: torch.Tensor, c0: int, s: int,
             nrows: int, ncols: int) -> torch.Tensor:
    """``y[t·R + r] = Σ_{w<W} slab[t, w, r] · x[t·s + c0 + w]`` for the
    (T, W, R) slab, x taken as 0 outside [0, ncols), rows past ``nrows``
    dropped; x is promoted to the result type.

    Kernel Q, over ``pack`` (the slab's ``BESPack``): x's window in shared
    memory, each row's nonzeros in increasing w.  lis_tpu leaves this to
    XLA (matrix/bes.py:184-191).  Bound on the H100: bytes — the nonzeros'
    values and offsets, x and y.  On a CPU tensor the plain version over
    the dense slab."""
    if not _checked("bes_spmv", slab, pack, x, ncols, s):
        return _spmv_plain(slab, x, c0, s, nrows, ncols)
    return _launch("lis_bes_spmv", bes_spmv, pack.qval, pack.qoff, pack.qlen,
                   pack.qptr, x, slab.shape, c0, s, nrows, ncols, nrows, 0)


bes_spmv.launches = 0


def bes_spmvh(slab: torch.Tensor, pack, x: torch.Tensor, c0: int, s: int,
              nrows: int, ncols: int) -> torch.Tensor:
    """``y[j] = Σ_{t,w : t·s + c0 + w = j} Σ_r conj(slab[t, w, r]) ·
    x[t·R + r]`` for j < ncols (x is 0 past ``nrows``).

    Kernel R, over ``pack``: two launches, the windows ``win[t, w]`` from
    each window column's nonzeros (the tile's rows of x in shared memory)
    and their deterministic overlap-add, counted as one.  lis_tpu leaves
    this to XLA (matrix/bes.py:193-212).  Bound on the H100: bytes, as for
    Q.  On a CPU tensor the plain version over the dense slab."""
    if not _checked("bes_spmvh", slab, pack, x, nrows, s):
        return _spmvh_plain(slab, x, c0, s, nrows, ncols)
    T, W, _ = slab.shape
    return _launch("lis_bes_spmvh", bes_spmvh, pack.hval, pack.hoff,
                   pack.hlen, pack.hptr, x, slab.shape, c0, s, nrows, ncols,
                   ncols, T * W)


bes_spmvh.launches = 0


# ---- the format --------------------------------------------------------------

def _window_choice(disp, T, R, stride, w_max):
    """lis_tpu's cost model (bes.py:84-120): every slab slot streams at the
    memory roofline while every out-of-window entry pays a gather, so W
    grows until the band of displacements it absorbs stops paying for the
    extra slab.  Returns (W, c0)."""
    if not len(disp):
        return 2 * stride, 0
    slab_ns_per_slot = 4 / 750e9 * 1e9
    gather_ns = 7.0
    dmin = int(disp.min())
    counts = np.bincount((disp - dmin) // stride)
    cum = np.concatenate([[0], np.cumsum(counts)])
    nb = len(counts)
    best_w, best_c0, best_cost = 2 * stride, dmin, None
    for wb in range(2, min(w_max, 1 << 14) // stride + 1):
        w_try = wb * stride
        cover = np.array([cum[-1]]) if wb >= nb else cum[wb:] - cum[:-wb]
        k = int(np.argmax(cover))
        covered = int(cover[k])
        cost = (T * w_try * R * slab_ns_per_slot
                + (len(disp) - covered) * gather_ns)
        if best_cost is None or cost < best_cost:
            best_w, best_c0, best_cost = w_try, dmin + k * stride, cost
        if covered == len(disp):
            break
    return best_w, best_c0


@matrix_format("bes")
class BESMatrix(SparseMatrix):
    # slab[t, w, r] = A[t·R + r, t·stride + c0 + w]
    slab: torch.Tensor        # (T, W, R)
    rem: object               # CSRMatrix remainder or None
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()
    R: int = static()
    W: int = static()
    c0: int = static()        # window start relative to t·stride
    stride: int = static()    # 0 means R (square band)
    pack: object = None       # BESPack of the slab: what Q and R read

    def to(self, device=None, dtype=None):
        """Every tensor moved (and cast); the compact form moves with the
        slab, or, where the matrix has none yet (a host build), is derived
        from the slab where it lands: on the card, no host pass."""
        out = super().to(device, dtype)
        if out.pack is None:
            # ``out`` is a new object that no one else holds yet
            object.__setattr__(out, "pack", bes_pack(out.slab))
        return out

    @property
    def s(self) -> int:
        return self.stride or self.R

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape, R: int = R_DEFAULT,
                        W: int | None = None, w_max: int = 4096,
                        max_bytes: int = 6 << 30, stride: int | None = None,
                        device=None) -> "BESMatrix":
        """Build from host CSR arrays on ``device`` (None: the default
        device).  W (a multiple of the stride) comes from the cost model,
        capped by ``w_max`` and the ``max_bytes`` slab budget; ``stride``
        defaults to R for a square shape and to round(R·ncols/nrows)
        otherwise."""
        return cls._build_host(ptr, index, value, shape, R, W, w_max,
                               max_bytes, stride).to(resolve_device(device))

    @classmethod
    def _build_host(cls, ptr, index, value, shape, R=R_DEFAULT, W=None,
                    w_max=4096, max_bytes=6 << 30, stride=None):
        """``from_csr_arrays`` with every tensor on the CPU."""
        import scipy.sparse as sp
        ptr = np.asarray(host(ptr)).astype(np.int64)
        index = np.asarray(host(index)).astype(np.int64)
        value = np.asarray(host(value))
        n, m = shape
        if stride is None:
            stride = R if n == m else max(1, round(R * m / max(n, 1)))
        T = -(-n // R)
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
        t_of = rows // R
        disp = index - t_of * stride
        if W is None or W % R:
            W, c0 = _window_choice(disp, T, R, stride, w_max)
        else:
            c0 = -((W - stride) // 2)
        while T * W * R * value.dtype.itemsize > max_bytes and W > 2 * stride:
            W -= stride
        lc = disp - c0
        fits = (lc >= 0) & (lc < W)
        slab = np.zeros((T, W, R), dtype=value.dtype)
        np.add.at(slab, (t_of[fits], lc[fits], rows[fits] - t_of[fits] * R),
                  value[fits])
        rem = None
        if not fits.all():
            sel = ~fits
            rmm = sp.coo_matrix((value[sel], (rows[sel], index[sel])),
                                shape=shape).tocsr()
            rmm.sort_indices()
            rem = CSRMatrix.from_csr_arrays(rmm.indptr, rmm.indices,
                                            rmm.data, shape, device="cpu")
        return cls(slab=torch.from_numpy(slab), rem=rem, nrows=int(n),
                   ncols=int(m), nnz=int(len(value)), R=int(R), W=int(W),
                   c0=int(c0), stride=int(stride))

    @property
    def fill_blowup(self) -> float:
        """Slab elements per true nonzero (the traffic multiplier against
        CSR)."""
        return self.slab.numel() / max(self.nnz, 1)

    def to_csr_arrays(self):
        return self._cached_csr(self._csr_of)

    def _csr_of(self):
        import scipy.sparse as sp
        s = host(self.slab)
        t, w, r = np.nonzero(s)
        grow = t * self.R + r
        gcol = t * self.s + self.c0 + w
        keep = (grow < self.nrows) & (gcol >= 0) & (gcol < self.ncols)
        a = sp.coo_matrix((s[t, w, r][keep], (grow[keep], gcol[keep])),
                          shape=self.shape).tocsr()
        if self.rem is not None:
            rp, ri, rv = self.rem.to_csr_arrays()
            a = (a + sp.csr_matrix((rv, ri, rp), shape=self.shape)).tocsr()
        a.sort_indices()
        return a.indptr.astype(np.int32), a.indices.astype(np.int32), a.data

    def matvec(self, x):
        y = bes_spmv(self.slab, self.pack, x, self.c0, self.s, self.nrows,
                     self.ncols)
        return y if self.rem is None else y + self.rem.matvec(x)

    def matvech(self, x):
        y = bes_spmvh(self.slab, self.pack, x, self.c0, self.s, self.nrows,
                      self.ncols)
        return y if self.rem is None else y + self.rem.matvech(x)

    def get_diagonal(self):
        """The diagonal on the device: w = r − c0 in every block (a square
        stride R); otherwise from the host CSR arrays."""
        if self.s != self.R:
            return super().get_diagonal()
        T, W, R = self.slab.shape
        r = torch.arange(R, device=self.slab.device)
        w = r - self.c0
        ok = (w >= 0) & (w < W)
        d = self.slab[:, w.clamp(0, W - 1), r]
        d = torch.where(ok, d, torch.zeros((), dtype=d.dtype,
                                           device=d.device))
        d = d.reshape(-1)[: self.nrows]
        return d if self.rem is None else d + self.rem.get_diagonal()

    def _row_factor(self, d):
        T, W, R = self.slab.shape
        return _pad(d, 0, T * R - self.nrows).view(T, 1, R)

    def _rescaled(self, slab, rem):
        """This matrix with a scaled slab, its compact form derived again
        (a factor of 0 drops entries)."""
        return dataclasses.replace(
            self, slab=slab, rem=rem,
            pack=None if self.pack is None else bes_pack(slab))

    def scale_rows(self, d):
        """Row scaling on the device: slab[t, :, r] *= d[t·R + r]."""
        slab = self.slab * self._row_factor(d).to(self.slab.dtype)
        rem = None if self.rem is None else csr_scaled(self.rem, row_d=d)
        return self._rescaled(slab, rem)

    def scale_symm(self, dsqrt_inv):
        """D^-1/2 A D^-1/2 on the device: the row factor d[t·R + r] times
        the column factor d[t·s + c0 + w] (the windows of d)."""
        d = dsqrt_inv
        T, W, R = self.slab.shape
        dw = _windows(d, T, self.s, W, self.c0, self.ncols)[:, :, None]
        slab = self.slab * (self._row_factor(d) * dw).to(self.slab.dtype)
        rem = None if self.rem is None else csr_scaled(self.rem, d, d)
        return self._rescaled(slab, rem)


@matrix_format("mbes")
class MultiBESMatrix(SparseMatrix):
    """A sum of BES slabs of one stride with different window intercepts,
    plus a CSR remainder: a 3-D stencil puts its columns in a few affine
    bands (one per plane neighbour), and a few narrow windows cover them
    at a low fill blowup where one wide window would be mostly padding."""
    parts: tuple              # BESMatrix parts, each with rem None
    rem: object               # CSRMatrix or None
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape, device=None, **kw):
        """The convert_matrix hook: ``multi_bes_from_csr`` (a BESMatrix
        where one window suffices)."""
        return multi_bes_from_csr(ptr, index, value, shape, device=device,
                                  **kw)

    @property
    def fill_blowup(self) -> float:
        return sum(p.slab.numel() for p in self.parts) / max(self.nnz, 1)

    def _sum(self, f):
        y = f(self.parts[0])
        for p in self.parts[1:]:
            y = y + f(p)
        return y if self.rem is None else y + f(self.rem)

    def matvec(self, x):
        return self._sum(lambda p: p.matvec(x))

    def matvech(self, x):
        return self._sum(lambda p: p.matvech(x))

    def get_diagonal(self):
        return self._sum(lambda p: p.get_diagonal())

    def to_csr_arrays(self):
        return self._cached_csr(self._csr_of)

    def _csr_of(self):
        import scipy.sparse as sp
        a = None
        for p in self.parts + ((self.rem,) if self.rem is not None else ()):
            pp, pi, pv = p.to_csr_arrays()
            m = sp.csr_matrix((pv, pi, pp), shape=self.shape)
            a = m if a is None else (a + m).tocsr()
        a.sort_indices()
        return a.indptr.astype(np.int32), a.indices.astype(np.int32), a.data

    def scale_rows(self, d):
        return dataclasses.replace(
            self, parts=tuple(p.scale_rows(d) for p in self.parts),
            rem=None if self.rem is None else csr_scaled(self.rem, row_d=d))

    def scale_symm(self, dsqrt_inv):
        d = dsqrt_inv
        return dataclasses.replace(
            self, parts=tuple(p.scale_symm(d) for p in self.parts),
            rem=None if self.rem is None else csr_scaled(self.rem, d, d))


def multi_bes_from_csr(ptr, index, value, shape, R: int = R_DEFAULT,
                       stride: int | None = None, max_windows: int = 4,
                       w_max: int = 4096, max_bytes: int = 4 << 30,
                       device=None, compact: bool = True):
    """Greedy multi-window BES build (lis_tpu bes.py:347-398): the
    single-window cost-model builder runs on the still-uncovered entries
    until they are few, the window count or the byte budget is spent.
    Returns a BESMatrix (one window sufficed) or a MultiBESMatrix on
    ``device`` (None: the default device), each slab with its compact
    form.  With ``compact=False`` it returns the host build as it is, on
    the CPU and with no compact form, for a caller that may refuse it: the
    ``.to(device)`` of what it keeps derives the form there.  Raises
    ``NothingCovers`` for a matrix with no entry."""
    import scipy.sparse as sp
    n, m = shape
    cur_p = np.asarray(host(ptr))
    cur_i = np.asarray(host(index))
    cur_v = np.asarray(host(value))
    total_nnz = len(cur_v)
    if total_nnz == 0:
        raise NothingCovers("multi_bes_from_csr: the matrix has no entry")
    parts = []
    budget = max_bytes
    for _ in range(max_windows):
        if len(cur_v) == 0:
            break
        B = BESMatrix._build_host(cur_p, cur_i, cur_v, shape, R=R,
                                  stride=stride, w_max=w_max,
                                  max_bytes=budget)
        covered = B.nnz - (B.rem.nnz if B.rem is not None else 0)
        if covered <= 0.05 * len(cur_v) and parts:
            break                       # diminishing returns
        budget -= B.slab.numel() * cur_v.dtype.itemsize
        rem = B.rem
        parts.append(dataclasses.replace(B, rem=None, nnz=covered))
        if rem is None:
            cur_v = cur_v[:0]
            break
        cur_p, cur_i, cur_v = rem.to_csr_arrays()
        if budget <= 0:
            break
    rem = None
    if len(cur_v):
        rm = sp.csr_matrix((cur_v, cur_i, cur_p), shape=shape)
        rm.sort_indices()
        rem = CSRMatrix.from_csr_arrays(rm.indptr, rm.indices, rm.data,
                                        shape, device="cpu")
    if len(parts) == 1:
        out = dataclasses.replace(parts[0], rem=rem, nnz=total_nnz)
    else:
        out = MultiBESMatrix(parts=tuple(parts), rem=rem, nrows=int(n),
                             ncols=int(m), nnz=int(total_nnz))
    return out.to(resolve_device(device)) if compact else out


def fitting_multi_bes(ptr, index, value, shape, max_blowup: float,
                      max_rem: float, **kw):
    """``multi_bes_from_csr`` on the host, with no compact form, or None
    where it covers too little: a fill blowup above ``max_blowup``, a
    remainder above ``max_rem`` of the nnz, or no entry at all
    (``NothingCovers``, the only failure this catches).  The router (256,
    0.1) and SA-AMG's prolongators (512, 0.2) take lis_tpu's acceptance
    this way, and move what they accept to its device."""
    try:
        bes = multi_bes_from_csr(ptr, index, value, shape, compact=False,
                                 **kw)
    except NothingCovers:
        return None
    rem_frac = bes.rem.nnz / max(bes.nnz, 1) if bes.rem is not None else 0.0
    if bes.fill_blowup <= max_blowup and rem_frac <= max_rem:
        return bes
    return None
