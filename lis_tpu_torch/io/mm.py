"""Matrix Market I/O.

Port of ``lis_tpu/io/mm.py`` (reference: lis_input_mm,
src/system/lis_input_mm.c:62, CSR fast path :699, and lis_output_mm,
src/system/lis_output_mm.c:60).  Supports coordinate and array formats,
real/integer/complex/pattern fields, general/symmetric/skew-symmetric/
hermitian symmetries, and the Lis extension of b and x vectors appended
after the matrix entries.  Reading is host-side (numpy, or the native
parser for plain real coordinate files); the matrix and the vectors land
on ``device`` (None: the default device, the card).  The Lis binary
flavour (packed records) is not ported yet (ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

import numpy as np
import torch

from lis_tpu_torch import _native
from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import SparseMatrix, host
from lis_tpu_torch.matrix.convert import convert_matrix
from lis_tpu_torch.matrix.csr import CSRMatrix


def _parse_header(line: str):
    parts = line.strip().split()
    if len(parts) < 4 or parts[0] != "%%MatrixMarket":
        raise ValueError(f"not a MatrixMarket file: {line!r}")
    obj, fmt = parts[1].lower(), parts[2].lower()
    field = parts[3].lower() if len(parts) > 3 else "real"
    symm = parts[4].lower() if len(parts) > 4 else "general"
    return obj, fmt, field, symm


def _binary_not_ported():
    return NotImplementedError(
        "binary MatrixMarket (the Lis packed-record flavour) is not ported "
        "to lis_tpu_torch yet (ROADMAP.md queue 1 item 8)")


def _appended_vector(f, path, nrows, name):
    d = np.loadtxt(f, max_rows=nrows, ndmin=2)
    if d.shape[0] < nrows:
        raise ValueError(f"{path}: appended {name} vector holds {d.shape[0]} "
                         f"of {nrows} entries — truncated file")
    out = np.zeros(nrows)
    out[d[:, 0].astype(np.int64) - 1] = d[:, -1]
    return out


def read_matrix_market(path: str, matrix_type: str = "csr",
                       return_vectors: bool = False, device=None, **kw):
    """Read a MatrixMarket matrix file into the requested format, on
    ``device``.

    Handles the Lis extension (lis_input_mm.c): an extended size line
    ``nr nc nnz isb isx`` with appended b/x vectors.  With
    ``return_vectors`` the result is ``(matrix, b_or_None, x_or_None)``,
    the vectors as tensors on the same device.
    """
    with open(path, "rb") as f:
        header = f.readline().decode("ascii", "replace")
        obj, fmt, field, symm = _parse_header(header)
        if obj != "matrix":
            raise ValueError(f"expected matrix object, got {obj}")
        skip = 1
        line = f.readline().decode("ascii", "replace")
        while line.startswith("%"):
            line = f.readline().decode("ascii", "replace")
            skip += 1
        skip += 1                      # the size line itself
        sizes = line.split()
        if not sizes:
            raise ValueError(f"{path}: missing MatrixMarket size line")
        b = x = None
        if fmt == "coordinate":
            if len(sizes) < 3:
                raise ValueError(
                    f"{path}: coordinate size line needs 'nrows ncols "
                    f"nnz', got {line.strip()!r}")
            nrows, ncols, nnz = int(sizes[0]), int(sizes[1]), int(sizes[2])
            isb = int(sizes[3]) if len(sizes) > 3 else 0
            isx = int(sizes[4]) if len(sizes) > 4 else 0
            if len(sizes) > 5 and int(sizes[5]):
                raise _binary_not_ported()
            native = None
            if field in ("real", "integer", "pattern") \
                    and not (isb or isx or return_vectors):
                native = _native.mm_parse_coords(path, skip, nnz,
                                                 field == "pattern")
            if native is not None:
                rows, cols, vals = native
                rows = rows.astype(np.int64)
                cols = cols.astype(np.int64)
            else:
                data = np.loadtxt(f, max_rows=nnz, ndmin=2)
                if data.shape[0] < nnz:
                    raise ValueError(
                        f"{path}: declares {nnz} entries but holds "
                        f"{data.shape[0]} — truncated file")
                rows = data[:, 0].astype(np.int64) - 1
                cols = data[:, 1].astype(np.int64) - 1
                if field == "pattern":
                    vals = np.ones(nnz)
                elif field == "complex":
                    vals = data[:, 2] + 1j * data[:, 3]
                else:
                    vals = data[:, 2]
                if isb:
                    b = _appended_vector(f, path, nrows, "b")
                if isx:
                    x = _appended_vector(f, path, nrows, "x")
        elif fmt == "array":
            if len(sizes) < 2:
                raise ValueError(
                    f"{path}: array size line needs 'nrows ncols', got "
                    f"{line.strip()!r}")
            nrows, ncols = int(sizes[0]), int(sizes[1])
            flat = np.asarray(np.loadtxt(f, max_rows=nrows * ncols))
            if flat.size < nrows * ncols:
                raise ValueError(
                    f"{path}: array format declares {nrows * ncols} "
                    f"values but holds {flat.size} — truncated file")
            dense = flat.reshape(ncols, nrows).T  # column-major
            rows, cols = np.nonzero(dense)
            vals = dense[rows, cols]
        else:
            raise ValueError(f"unknown MM format {fmt}")

    if symm in ("symmetric", "skew-symmetric", "hermitian"):
        off = rows != cols
        sign = -1.0 if symm == "skew-symmetric" else 1.0
        mirror = np.conj(vals[off]) if symm == "hermitian" else sign * vals[off]
        rows, cols, vals = (np.concatenate([rows, cols[off]]),
                            np.concatenate([cols, rows[off]]),
                            np.concatenate([vals, mirror]))

    import scipy.sparse as sp
    a = sp.coo_matrix((vals, (rows, cols)), shape=(nrows, ncols)).tocsr()
    a.sum_duplicates()
    a.sort_indices()
    device = resolve_device(device)
    A = convert_matrix(
        CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape,
                                  device="cpu"),
        matrix_type, device=device, **kw)
    if return_vectors:
        return (A, None if b is None else torch.from_numpy(b).to(device),
                None if x is None else torch.from_numpy(x).to(device))
    return A


def read_vector_mm(path: str, device=None) -> torch.Tensor:
    """Read a MatrixMarket vector (array format or n×1 coordinate)."""
    with open(path) as f:
        obj, fmt, field, symm = _parse_header(f.readline())
        line = f.readline()
        while line.startswith("%"):
            line = f.readline()
        sizes = line.split()
        if fmt == "array":
            n = int(sizes[0])
            vals = np.atleast_1d(np.loadtxt(f, max_rows=n))
        else:
            n, _, nnz = int(sizes[0]), int(sizes[1]), int(sizes[2])
            data = np.loadtxt(f, max_rows=nnz, ndmin=2)
            vals = np.zeros(n)
            vals[data[:, 0].astype(np.int64) - 1] = data[:, -1]
    return torch.from_numpy(vals).to(resolve_device(device))


def write_matrix_market(path: str, matrix: SparseMatrix,
                        field: str | None = None, binary: bool = False,
                        b=None, x=None):
    """Write in coordinate/general form (like lis_output_mm), values with
    17 significant digits; b/x append Lis-extension vectors."""
    if binary:
        raise _binary_not_ported()
    ptr, index, value = matrix.to_csr_arrays()
    ptr = np.asarray(ptr)
    index = np.asarray(index)
    value = np.asarray(value)
    n, m = matrix.shape
    rows = np.repeat(np.arange(n), np.diff(ptr))
    cplx = np.iscomplexobj(value)
    field = field or ("complex" if cplx else "real")
    isb, isx = int(b is not None), int(x is not None)
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} general\n")
        if isb or isx:
            f.write(f"{n} {m} {len(value)} {isb} {isx}\n")
        else:
            f.write(f"{n} {m} {len(value)}\n")
        if cplx:
            np.savetxt(f, np.column_stack([rows + 1, index + 1, value.real,
                                           value.imag]),
                       fmt="%d %d %.16e %.16e")
        else:
            np.savetxt(f, np.column_stack([rows + 1, index + 1, value]),
                       fmt="%d %d %.16e")
        for vec in (b, x):
            if vec is not None:
                v = host(vec)
                np.savetxt(f, np.column_stack([np.arange(1, len(v) + 1), v]),
                           fmt="%d %.16e")


def write_vector_mm(path: str, vec):
    """Write a vector as a MatrixMarket array (lis_output_vector_mm)."""
    v = host(vec)
    with open(path, "w") as f:
        f.write("%%MatrixMarket vector array real general\n")
        f.write(f"{len(v)}\n")
        np.savetxt(f, v, fmt="%.16e")
