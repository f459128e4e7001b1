"""Sparse-matrix base class, format registry and the tensor-dataclass move.

Port of ``lis_tpu/matrix/base.py``.  lis_tpu registers each format as a
JAX pytree; here a format is a frozen dataclass whose non-static fields
are torch tensors (or nested tensor dataclasses: a shuffle plan, a CSR
remainder, a transpose grid) and whose static fields are Python ints.
``.to(device, dtype)`` moves every tensor field — there is no implicit
device choice anywhere in the package.

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
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                return v.device
        raise ValueError(f"{type(self).__name__} holds no tensor")


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
    def from_csr_arrays(cls, ptr, index, value, shape, **kw):
        raise NotImplementedError

    def get_diagonal(self):
        """Diagonal as a tensor on the matrix's device
        (lis_matrix_get_diagonal, src/matrix/lis_matrix_ops.c:728)."""
        raise NotImplementedError

    def _rebuilt(self, ptr, index, value):
        """Same-format rebuild of host CSR arrays on this matrix's device."""
        from lis_tpu_torch.matrix.convert import convert_matrix
        from lis_tpu_torch.matrix.csr import CSRMatrix
        out = CSRMatrix.from_csr_arrays(ptr, index, value, self.shape)
        return convert_matrix(out, self.format_name).to(self.device)

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
