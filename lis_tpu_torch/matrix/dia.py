"""DIA (diagonal / CDS) format — the stream format for stencils.

Port of ``lis_tpu/matrix/dia.py`` (reference: src/matrix/lis_matrix_dia.c,
kernel src/matvec/lis_matvec_dia.c:50).  A banded or stencil matrix is a
handful of dense diagonals, and its SpMV needs no gather: each diagonal
contributes ``value[k] * shift(x, off_k)`` over contiguous memory.

The diagonals are one ``(nnd, n)`` tensor, ``value[k, i] = A[i, i+off_k]``
(lis_tpu keeps a tuple of ``(n,)`` leaves for XLA's sake).  The offsets
are a host tuple and, for the kernels, an int64 tensor beside the values.
Out-of-range positions hold zeros in ``value``.

lis_tpu has no Pallas kernel here: XLA fuses the shift-multiply-add chain
into one loop.  PyTorch does not, so on a CUDA tensor ``matvec`` is
kernel E (``dia_spmv``) and the square ``matvech`` is kernel F
(``dia_spmvh``), hand-written in ``csrc/dia.cu``; on a CPU tensor each
takes its plain version below, two torch calls per diagonal.  The relaxed
triangular sweeps of SSOR, ILU(0) and GS/SOR on a DIA operator are
kernels H and I (``dia_relax``, ``dia_relaxh``, ``csrc/dia_relax.cu``),
one sweep over a triangle's diagonals per launch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import SparseMatrix, matrix_format, static, host
from lis_tpu_torch.ops import _cuda

MAX_NND = 512     # the kernels keep the offsets in shared memory
_REAL_OF = {torch.complex64: torch.float32, torch.complex128: torch.float64}


def _rows_of(off: int, n: int, ncols: int) -> tuple[int, int]:
    """Rows i of an n-row matrix with 0 <= i + off < ncols, as [lo, hi)."""
    return max(0, -off), min(n, ncols - off)


def _spmv_plain(value, offsets, x, ncols):
    """y[i] = Σ_k value[k, i] · x[i + off_k] in plain torch, diagonal by
    diagonal in the order of ``offsets`` (the kernel sums in that order
    too)."""
    n = value.shape[1]
    y = torch.zeros(n, dtype=torch.promote_types(value.dtype, x.dtype),
                    device=x.device)
    for k, off in enumerate(offsets):
        lo, hi = _rows_of(off, n, ncols)
        if hi > lo:
            y[lo:hi] += value[k, lo:hi] * x[lo + off:hi + off]
    return y


def _spmvh_plain(value, offsets, x, ncols):
    """(Aᴴx)[j] = Σ_k conj(value[k, j − off_k]) · x[j − off_k]."""
    n = value.shape[1]
    v = value.conj() if value.is_complex() else value
    y = torch.zeros(ncols, dtype=torch.promote_types(value.dtype, x.dtype),
                    device=x.device)
    for k, off in enumerate(offsets):
        lo, hi = _rows_of(off, n, ncols)
        if hi > lo:
            y[lo + off:hi + off] += v[k, lo:hi] * x[lo:hi]
    return y


def _kernel_operands(value, x):
    """(value, x) as the kernels take them: x in the result type, value in
    that type or in its real type (real matrix × complex vector streams
    the real diagonals as they are); any other pair casts value."""
    dt = torch.promote_types(value.dtype, x.dtype)
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"dia kernels: dtype {dt} not supported")
    if x.dtype != dt:
        x = x.to(dt)
    if x.is_conj():
        x = x.resolve_conj()
    if not x.is_contiguous():
        x = x.contiguous()
    if value.dtype not in (dt, _REAL_OF.get(dt)):
        value = value.to(dt)
    return value, x


def _launch(name, fn, value, off, x, nrows, ncols, out_len):
    value, x = _kernel_operands(value, x)
    nnd = value.shape[0]
    if nnd > MAX_NND:
        raise ValueError(f"{name}: {nnd} diagonals, at most {MAX_NND}")
    # scalar loads: no operand needs more than its own alignment
    _cuda.check(value, "value", numel=nnd * nrows, aligned=False)
    _cuda.check(off, "off", torch.int64, nnd, aligned=False)
    _cuda.check(x, "x", aligned=False)
    y = torch.empty(out_len, dtype=x.dtype, device=x.device)
    _cuda.launch(name, _cuda.DTYPE_CODE[value.dtype],
                 _cuda.DTYPE_CODE[x.dtype], value.data_ptr(), off.data_ptr(),
                 x.data_ptr(), y.data_ptr(), nrows, ncols, nnd, _cuda.stream())
    fn.launches += 1
    return y


def dia_spmv(value: torch.Tensor, off: torch.Tensor, offsets, x: torch.Tensor,
             ncols: int) -> torch.Tensor:
    """``y[i] = Σ_k value[k, i] · x[i + off_k]`` for the (nnd, n) diagonals
    ``value``; terms with ``i + off_k`` outside [0, ncols) are dropped, so
    x is read as it is, with no padded copy.

    Kernel E.  lis_tpu leaves this loop to XLA (matrix/dia.py:119).  Bound
    on the H100: bytes — the diagonals are read once, (nnd·n + 2n)
    elements in all; the shifted reads of x come from the caches."""
    if x.shape[0] != ncols:
        raise ValueError(f"dia_spmv: x has {x.shape[0]} entries, A has "
                         f"{ncols} columns")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"no kernel or plain path for {x.device}")
        return _spmv_plain(value, offsets, x, ncols)
    return _launch("lis_dia_spmv", dia_spmv, value, off, x, value.shape[1],
                   ncols, value.shape[1])


dia_spmv.launches = 0


def dia_spmvh(value: torch.Tensor, off: torch.Tensor, offsets,
              x: torch.Tensor) -> torch.Tensor:
    """``(Aᴴx)[j] = Σ_k conj(value[k, j − off_k]) · x[j − off_k]`` for a
    square matrix: shifted streams of value and x, no scatter.

    Kernel F.  lis_tpu leaves this loop to XLA (matrix/dia.py:136-146).
    Bound on the H100: bytes, as for kernel E."""
    n = value.shape[1]
    if x.shape[0] != n:
        raise ValueError(f"dia_spmvh: x has {x.shape[0]} entries, A has "
                         f"{n} rows")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"no kernel or plain path for {x.device}")
        return _spmvh_plain(value, offsets, x, n)
    return _launch("lis_dia_spmvh", dia_spmvh, value, off, x, n, n, n)


dia_spmvh.launches = 0


def _relax_plain(value, offsets, rhs, y, s, w, rs, start, trans):
    """The sweep of kernels H and I in plain torch, in the kernels' order
    of operations: base = rhs·rs; the term vector t = base·w (start),
    y·s (y given) or none; out = (base − T·t)·w, T·t by the plain E or F."""
    base = rhs if rs is None else rhs * rs
    if start:
        t = base if w is None else base * w
    else:
        t = None if y is None else (y if s is None else y * s)
    out = base
    if t is not None:
        n = value.shape[1]
        out = base - (_spmvh_plain if trans else _spmv_plain)(
            value, offsets, t, n)
    return out if w is None else out * w


def _relax_operands(value, rhs, y, scales):
    """(value, rhs, y, scales) as kernels H and I take them: the vectors in
    the result type, the scales in value's type, value in the result type
    or its real type (cast only where a pair is not one of the kernels')."""
    dt = torch.promote_types(value.dtype, rhs.dtype)
    if y is not None:
        dt = torch.promote_types(dt, y.dtype)
    if dt not in _cuda.DTYPE_CODE:
        raise ValueError(f"dia sweeps: dtype {dt} not supported")
    vdt = value.dtype if value.dtype in (dt, _REAL_OF.get(dt)) else dt
    if value.dtype != vdt:
        value = value.to(vdt)

    def vec(t, want):
        if t is None:
            return None
        if t.is_complex() and not want.is_complex:
            raise ValueError("dia sweeps: a complex scale with real "
                             "diagonals")
        if t.dtype != want:
            t = t.to(want)
        if t.is_conj():
            t = t.resolve_conj()
        return t.contiguous()
    return (value, vec(rhs, dt), vec(y, dt),
            tuple(vec(t, vdt) for t in scales))


def _relax(fn, trans, T, rhs, y, s, w, rs, start):
    n = T.nrows
    if T.ncols != n:
        raise ValueError("dia sweeps: T must be square")
    if start and y is not None:
        raise ValueError("dia sweeps: start computes its own term vector; "
                         "give no y")
    for name, t in (("rhs", rhs), ("y", y), ("s", s), ("w", w), ("rs", rs)):
        if t is not None and t.shape != (n,):
            raise ValueError(f"dia sweeps: {name} has shape "
                             f"{tuple(t.shape)}, expected ({n},)")
    if not rhs.is_cuda:
        if rhs.device.type != "cpu":
            raise ValueError(f"no kernel or plain path for {rhs.device}")
        return _relax_plain(T.value, T.offsets, rhs, y, s, w, rs, start,
                            trans)
    value, rhs, y, (s, w, rs) = _relax_operands(T.value, rhs, y, (s, w, rs))
    nnd = value.shape[0]
    if nnd > MAX_NND:
        raise ValueError(f"dia sweeps: {nnd} diagonals, at most {MAX_NND}")
    _cuda.check(value, "value", numel=nnd * n, aligned=False)
    _cuda.check(T.off, "off", torch.int64, nnd, aligned=False)
    for name, t in (("rhs", rhs), ("y", y), ("s", s), ("w", w), ("rs", rs)):
        if t is not None:
            _cuda.check(t, name, aligned=False)
    out = torch.empty(n, dtype=rhs.dtype, device=rhs.device)
    ymode = 2 if start else (0 if y is None else 1)
    _cuda.launch("lis_dia_relax", _cuda.DTYPE_CODE[value.dtype],
                 _cuda.DTYPE_CODE[rhs.dtype], int(trans), ymode,
                 value.data_ptr(), T.off.data_ptr(), rhs.data_ptr(),
                 _ptr(rs), _ptr(y), _ptr(s), _ptr(w), out.data_ptr(), n, nnd,
                 _cuda.stream())
    fn.launches += 1
    return out


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def dia_relax(T: "DIAMatrix", rhs: torch.Tensor, y=None, s=None, w=None,
              rs=None, start: bool = False) -> torch.Tensor:
    """One relaxed triangular sweep over the diagonals of the square DIA
    ``T``: ``out = (rhs·rs − T·t)·w`` with the term vector ``t = s·y``
    (``y`` given), ``t = (rhs·rs)·w`` (``start``: the sweep from the start
    vector, with no launch for the start) or no term (``y`` None: the start
    itself).  ``s``, ``w`` and ``rs`` are optional, absent meaning 1.

    Kernel H.  lis_tpu leaves these sweeps to XLA (precon/ssor.py:60-72,
    precon/ilu.py:319-326, solvers/stationary.py:61-65).  Bound on the
    H100: bytes, T read once and each vector once."""
    return _relax(dia_relax, False, T, rhs, y, s, w, rs, start)


dia_relax.launches = 0


def dia_relaxh(T: "DIAMatrix", rhs: torch.Tensor, y=None, s=None, w=None,
               rs=None, start: bool = False) -> torch.Tensor:
    """The conjugate-transposed sweep: ``out = (rhs·rs − Tᴴ·t)·w``, with
    ``t`` as in ``dia_relax``.

    Kernel I.  lis_tpu leaves these sweeps to XLA (precon/ssor.py:75-84,
    precon/ilu.py:328-337).  Bound on the H100: bytes, as for H."""
    return _relax(dia_relaxh, True, T, rhs, y, s, w, rs, start)


dia_relaxh.launches = 0


@matrix_format("dia")
class DIAMatrix(SparseMatrix):
    value: torch.Tensor       # (nnd, n): value[k, i] = A[i, i + offsets[k]]
    off: torch.Tensor         # (nnd,) int64, the offsets on the device
    nrows: int = static()
    ncols: int = static()
    nnz: int = static()
    offsets: tuple = static()

    @classmethod
    def from_diagonals(cls, value, offsets, shape, nnz: int,
                       device=None) -> "DIAMatrix":
        """Build from the (nnd, n) diagonals (a tensor stays on its device
        unless ``device`` says otherwise; an array goes to ``device``, None
        meaning the default device)."""
        if not isinstance(value, torch.Tensor):
            value = torch.from_numpy(np.ascontiguousarray(value))
            device = resolve_device(device)
        elif device is None:
            device = value.device
        offsets = tuple(int(o) for o in offsets)
        value = value.to(device).contiguous()
        return cls(value=value,
                   off=torch.tensor(offsets, dtype=torch.int64,
                                    device=value.device),
                   nrows=int(shape[0]), ncols=int(shape[1]), nnz=int(nnz),
                   offsets=offsets)

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape,
                        device=None) -> "DIAMatrix":
        ptr, index, value = host(ptr), host(index), host(value)
        n = shape[0]
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
        offs = index.astype(np.int64) - rows
        uoffs = np.unique(offs)
        dval = np.zeros((len(uoffs), n), dtype=value.dtype)
        dval[np.searchsorted(uoffs, offs), rows] = value
        out = cls.from_diagonals(dval, uoffs, shape, len(value),
                                 device=device)
        # host CSR cache (see csr.py): a preconditioner or a conversion
        # that re-reads the operator needs no device-to-host copy
        object.__setattr__(out, "_host_csr",
                           (np.asarray(ptr, np.int32),
                            np.asarray(index, np.int32), value))
        return out

    @property
    def value_2d(self) -> np.ndarray:
        """Host (nnd, n) array of the diagonals."""
        return host(self.value)

    def to_csr_arrays(self):
        """Canonical host CSR of the nonzero entries, cached on the matrix.
        With sorted offsets, the row-major walk of the (n, nnd) transposed
        diagonals is already in (row, column) order and needs no sort."""
        cached = getattr(self, "_host_csr", None)
        if cached is not None:
            return cached
        val = self.value_2d
        n, m = self.shape
        offs = np.array(self.offsets, dtype=np.int64)
        cols = np.arange(n)[None, :] + offs[:, None]
        valid = (cols >= 0) & (cols < m) & (val != 0)
        rows = np.broadcast_to(np.arange(n)[None, :], cols.shape)
        if (np.diff(offs) > 0).all():
            r, c, v = rows.T[valid.T], cols.T[valid.T], val.T[valid.T]
        else:
            r, c, v = rows[valid], cols[valid], val[valid]
            order = np.lexsort((c, r))
            r, c, v = r[order], c[order], v[order]
        ptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(ptr, r + 1, 1)
        out = np.cumsum(ptr).astype(np.int32), c.astype(np.int32), v
        object.__setattr__(self, "_host_csr", out)
        return out

    def diagonals(self, ks, nnz: int | None = None) -> "DIAMatrix":
        """The square DIA of diagonals ``ks`` (indices into ``offsets``, in
        that order): a view of ``value`` when they are a contiguous range,
        as the strict triangles of sorted offsets are; else a copy.  ``nnz``
        None counts the nonzeros with one device-to-host read."""
        ks = list(ks)
        n = self.nrows
        if not ks:
            value = self.value.new_zeros((0, n))
            off = self.off.new_zeros((0,))
        elif ks == list(range(ks[0], ks[-1] + 1)):
            value, off = self.value[ks[0]:ks[-1] + 1], self.off[ks[0]:ks[-1] + 1]
        else:
            idx = torch.tensor(ks, dtype=torch.int64, device=self.off.device)
            value, off = self.value.index_select(0, idx), self.off[idx]
        if nnz is None:
            nnz = int(torch.count_nonzero(value)) if ks else 0
        return DIAMatrix(value=value, off=off, nrows=n, ncols=self.ncols,
                         nnz=int(nnz),
                         offsets=tuple(self.offsets[k] for k in ks))

    def get_diagonal(self):
        if 0 in self.offsets:
            return self.value[self.offsets.index(0)]
        return torch.zeros(self.nrows, dtype=self.value.dtype,
                           device=self.value.device)

    def scale_rows(self, d):
        """Row scaling on the device: A[i, i+off] *= d[i] is elementwise
        on each diagonal stream."""
        return dataclasses.replace(
            self, value=self.value * d.to(self.value.dtype))

    def scale_symm(self, dsqrt_inv):
        """D A D on the device: value[k, i] *= d[i]·d[i+off_k] (the column
        factor is the d stream shifted by the offset)."""
        d = dsqrt_inv
        out = torch.zeros_like(self.value)
        for k, off in enumerate(self.offsets):
            lo, hi = _rows_of(off, self.nrows, self.ncols)
            if hi > lo:
                out[k, lo:hi] = self.value[k, lo:hi] * (
                    d[lo:hi] * d[lo + off:hi + off]).to(out.dtype)
        return dataclasses.replace(self, value=out)

    def matvec(self, x):
        return dia_spmv(self.value, self.off, self.offsets, x, self.ncols)

    def matvech(self, x):
        if self.ncols == self.nrows:
            return dia_spmvh(self.value, self.off, self.offsets, x)
        # rectangular: a scatter into a y of another length.  Plain torch
        # on every device: lis_tpu has no kernel here either, and no
        # ported solver reaches it (they take square systems)
        return _spmvh_plain(self.value, self.offsets, x, self.ncols)
