"""Sparse-matrix base class, format registry and the tensor-dataclass move.

Port of ``lis_tpu/matrix/base.py``.  lis_tpu registers each format as a
JAX pytree; here a format is a frozen dataclass whose non-static fields
are torch tensors (or nested tensor dataclasses: a shuffle plan, a CSR
remainder, a transpose grid) and whose static fields are Python ints.
``.to(device, dtype)`` moves every tensor field.  A constructor from host
arrays builds on ``config.default_device()`` (the card) unless it is
given a ``device``; everything else stays where its operands are.

Each format implements ``matvec``/``matvech`` (reference: lis_matvec,
src/matvec/lis_matvec.c:55,191) plus ``to_csr_arrays``/``from_csr_arrays``
for the CSR-hub conversion scheme (lis_matrix_convert,
src/matrix/lis_matrix_ops.c:128).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_MATRIX_REGISTRY: dict[str, type] = {}


def _move(v, device, dtype):
    if isinstance(v, torch.Tensor):
        if dtype is not None and v.is_floating_point():
            v = v.to(dtype)
        return v if device is None else v.to(device)
    if isinstance(v, tuple):
        return tuple(_move(e, device, dtype) for e in v)
    if isinstance(v, TensorFields):
        return v.to(device, dtype)
    return v


class TensorFields:
    """Mixin for frozen dataclasses of tensors: ``to(device, dtype)``
    returns a copy with every tensor field moved (and, with ``dtype``,
    every floating-point tensor cast — the ``-f single`` path).  Fields
    marked ``static()`` are left alone."""

    def to(self, device=None, dtype=None):
        kw = {f.name: _move(getattr(self, f.name), device, dtype)
              for f in dataclasses.fields(self)
              if not f.metadata.get("static")}
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        """The device of the first tensor held (directly, in a tuple
        field, or in a nested tensor dataclass)."""
        def first(v):
            if isinstance(v, torch.Tensor):
                return v.device
            if isinstance(v, tuple):
                return next((d for d in map(first, v) if d is not None),
                            None)
            if isinstance(v, TensorFields):
                return next((d for f in dataclasses.fields(v)
                             if (d := first(getattr(v, f.name))) is not None),
                            None)
            return None

        dev = first(self)
        if dev is None:
            raise ValueError(f"{type(self).__name__} holds no tensor")
        return dev


def matrix_format(name: str):
    """Class decorator: make a format a frozen dataclass and register it."""
    def deco(cls):
        cls = dataclasses.dataclass(frozen=True, eq=False)(cls)
        cls.format_name = name
        _MATRIX_REGISTRY[name] = cls
        return cls
    return deco


def get_format(name: str) -> type:
    return _MATRIX_REGISTRY[name]


def static(**extra):
    return dataclasses.field(metadata={"static": True, **extra})


def host(x) -> np.ndarray:
    """Bring a tensor (on any device) or array to host numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def as_tensor(a, dtype=None) -> torch.Tensor:
    """A host array as a CPU tensor (copied only where numpy must, to make
    it contiguous, writable or of ``dtype``)."""
    return torch.from_numpy(np.require(host(a), dtype, ["C", "W"]))


def conj(v: torch.Tensor) -> torch.Tensor:
    """Complex conjugate; real tensors pass through."""
    return v.conj() if v.is_complex() else v


def scatter_add(n: int, index: torch.Tensor, prod: torch.Tensor):
    """A length-n vector of the sums of ``prod`` at ``index`` (``index_add_``:
    with atomics on a GPU, so the order of a sum's terms may vary)."""
    y = torch.zeros(n, dtype=prod.dtype, device=prod.device)
    return y.index_add_(0, index, prod)


def canonical_csr(ptr, index, value, shape):
    """Sort column indices within rows, sum duplicates; host-side."""
    import scipy.sparse as sp
    a = sp.csr_matrix((host(value), host(index), host(ptr)), shape=shape)
    a.sum_duplicates()
    a.sort_indices()
    return a.indptr.astype(np.int32), a.indices.astype(np.int32), a.data


class SparseMatrix(TensorFields):
    """Interface shared by every storage format."""

    format_name: str = "abstract"

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrows, self.ncols)

    def matvec(self, x):
        raise NotImplementedError

    def matvech(self, x):
        """y = Aᴴ x (conjugate transpose; plain transpose for real)."""
        raise NotImplementedError

    def to_csr_arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host-side (ptr, index, value) in canonical CSR (sorted columns)."""
        raise NotImplementedError

    @classmethod
    def from_csr_arrays(cls, ptr, index, value, shape, device=None, **kw):
        """Build from host CSR arrays on ``device`` (None: the default
        device, ``config.default_device()``)."""
        raise NotImplementedError

    def to(self, device=None, dtype=None):
        out = super().to(device, dtype)
        cached = getattr(self, "_host_csr", None)
        if cached is not None and dtype is None:
            # a format that caches its host CSR arrays (``_host_csr``)
            # keeps them across a device move, which leaves them unchanged
            object.__setattr__(out, "_host_csr", cached)
        return out

    def to_dense(self) -> np.ndarray:
        """The matrix as a host (nrows, ncols) array, duplicates summed."""
        ptr, index, value = self.to_csr_arrays()
        dense = np.zeros(self.shape, dtype=value.dtype)
        rows = np.repeat(np.arange(self.nrows, dtype=np.int64), np.diff(ptr))
        np.add.at(dense, (rows, np.asarray(index, dtype=np.int64)), value)
        return dense

    def get_diagonal(self):
        """Diagonal as a tensor on the matrix's device
        (lis_matrix_get_diagonal, src/matrix/lis_matrix_ops.c:728), summed
        on the host from the CSR arrays; formats that hold it override."""
        ptr, index, value = self.to_csr_arrays()
        d = np.zeros(self.nrows, dtype=value.dtype)
        rows = np.repeat(np.arange(self.nrows, dtype=np.int64), np.diff(ptr))
        isd = np.asarray(index, dtype=np.int64) == rows
        np.add.at(d, rows[isd], value[isd])
        return torch.from_numpy(d).to(self.device)

    def _cached_csr(self, build):
        """``build()``'s host CSR arrays, computed once and kept on the
        matrix (``_host_csr``, as ``CSRMatrix`` keeps those it was built
        from), so a conversion, a diagonal or a preconditioner that reads
        the operator again needs no device-to-host copy."""
        cached = getattr(self, "_host_csr", None)
        if cached is None:
            cached = build()
            object.__setattr__(self, "_host_csr", cached)
        return cached

    def _rebuild_kwargs(self) -> dict:
        """Structure parameters a same-format rebuild must keep (the block
        formats' block sizes, once ported).  Default: none."""
        return {}

    def _rebuilt(self, ptr, index, value):
        """Same-format rebuild of host CSR arrays on this matrix's device."""
        from lis_tpu_torch.matrix.convert import convert_matrix
        from lis_tpu_torch.matrix.csr import CSRMatrix
        out = CSRMatrix.from_csr_arrays(ptr, index, value, self.shape,
                                        device="cpu")
        return convert_matrix(out, self.format_name, device=self.device,
                              **self._rebuild_kwargs())

    def _rebuilt_scipy(self, a):
        """Same-format rebuild of a scipy CSR matrix, columns sorted."""
        a = a.tocsr()
        a.sort_indices()
        return self._rebuilt(a.indptr, a.indices, a.data)

    def _scipy(self):
        import scipy.sparse as sp
        ptr, index, value = self.to_csr_arrays()
        return sp.csr_matrix((value, index, ptr), shape=self.shape)

    def scale_rows(self, d):
        """Return a same-format matrix with rows scaled by vector d."""
        ptr, index, value = self.to_csr_arrays()
        dn = host(d)
        value = value * dn[np.repeat(np.arange(self.nrows), np.diff(ptr))]
        return self._rebuilt(ptr, index, value)

    def scale_symm(self, dsqrt_inv):
        """D^-1/2 A D^-1/2 (symmetric diagonal scaling, -scale 2)."""
        ptr, index, value = self.to_csr_arrays()
        dn = host(dsqrt_inv)
        rows = np.repeat(np.arange(self.nrows), np.diff(ptr))
        value = value * dn[rows] * dn[index]
        return self._rebuilt(ptr, index, value)

    def shift_diagonal(self, sigma):
        """A - sigma I (lis_matrix_shift_diagonal,
        src/matrix/lis_matrix_ops.c:781; Lis subtracts)."""
        import scipy.sparse as sp
        return self._rebuilt_scipy(
            self._scipy() - sigma * sp.eye(self.nrows, self.ncols,
                                           format="csr"))

    def axpy(self, alpha, other):
        """B + alpha A in this matrix's format, B = ``other``
        (lis_matrix_axpy, src/matrix/lis_matrix_ops.c:489)."""
        return self._rebuilt_scipy(other._scipy() + alpha * self._scipy())
