"""Unified file I/O with format auto-detection.

Port of ``lis_tpu/io/__init__.py`` (reference: lis_input,
src/system/lis_input.c:67, sniffs the first line — "%%MatrixMarket" → MM,
"#LIS" → Lis native, otherwise Harwell-Boeing or PLAIN; lis_output,
src/system/lis_output.c:63).  Matrices: MatrixMarket (ASCII and the Lis
binary flavour), Lis native and Harwell-Boeing; vectors: MatrixMarket,
Lis native (ASCII and binary) and PLAIN.  Every reader puts what it reads
on ``device`` (None: the default device, the card).
"""

from __future__ import annotations

from lis_tpu_torch.io.hb import read_harwell_boeing, write_harwell_boeing
from lis_tpu_torch.io.lisio import (read_lis_file, read_lis_vector,
                                    write_lis_file, write_lis_vector)
from lis_tpu_torch.io.mm import (read_matrix_market, read_vector_mm,
                                 write_matrix_market, write_vector_mm)
from lis_tpu_torch.io.plain import read_vector_plain, write_vector_plain

__all__ = ["read_matrix_market", "read_vector_mm", "write_matrix_market",
           "write_vector_mm", "read_harwell_boeing", "write_harwell_boeing",
           "read_lis_file", "read_lis_vector", "write_lis_file",
           "write_lis_vector", "read_vector_plain", "write_vector_plain",
           "lis_input", "lis_input_vector", "lis_output",
           "lis_output_vector"]


def _sniff(path: str) -> str:
    with open(path, "rb") as f:
        head = f.read(64)
    if head.startswith(b"%%MatrixMarket"):
        return "mm"
    if head.startswith(b"#LIS"):
        return "lis"
    return "unknown"


def lis_input(path: str, matrix_type: str = "csr", device=None, **kw):
    """Read a matrix (and optional b, x) onto ``device`` (None: the
    default device).  Returns (matrix, b_or_None, x_or_None), mirroring
    lis_input(A, b, x, filename) (src/system/lis_input.c:67)."""
    fmt = _sniff(path)
    if fmt == "mm":
        return read_matrix_market(path, matrix_type, return_vectors=True,
                                  device=device, **kw)
    if fmt == "lis":
        return read_lis_file(path, matrix_type, device=device, **kw)
    # Harwell-Boeing has no magic banner; it is the remaining matrix format
    return read_harwell_boeing(path, matrix_type, device=device, **kw), \
        None, None


def lis_input_vector(path: str, device=None):
    """Read a vector onto ``device``: MatrixMarket, Lis native (ASCII or
    B/L binary; the b of a Lis matrix file) or PLAIN (lis_input.c:176-248,
    the vec-banner dispatch of lis_input_vector_lis :470)."""
    fmt = _sniff(path)
    if fmt == "mm":
        return read_vector_mm(path, device=device)
    if fmt == "lis":
        with open(path, "rb") as f:
            head = f.read(10)
        if head[7:10] == b"vec":
            return read_lis_vector(path, device=device)
        return read_lis_file(path, device=device)[1]
    return read_vector_plain(path, device=device)


def lis_output(path: str, matrix, b=None, x=None, fmt: str = "mm"):
    """Write a matrix in the requested format (lis_output, lis_output.c:63):
    "mm" (ASCII MatrixMarket with the Lis b/x extension), "mmb" (binary
    MatrixMarket, LIS_FMT_MMB, in the host's byte order), "lis" (Lis
    native) or "hb" (Harwell-Boeing RUA/CUA; b and x are not written)."""
    if fmt == "mm":
        write_matrix_market(path, matrix, b=b, x=x)
    elif fmt == "mmb":
        write_matrix_market(path, matrix, binary=True, b=b, x=x)
    elif fmt == "lis":
        write_lis_file(path, matrix, b, x)
    elif fmt == "hb":
        write_harwell_boeing(path, matrix)
    else:
        raise ValueError(f"unsupported output format {fmt!r}")


def lis_output_vector(path: str, vec, fmt: str = "mm", nprocs: int = 1):
    """Write a vector: "mm", "plain", "lis" (the reference's ASCII
    ``#LIS A vec``), "lisb" / "lisl" (the big / little-endian binary
    flavours)."""
    if fmt == "mm":
        write_vector_mm(path, vec)
    elif fmt == "plain":
        write_vector_plain(path, vec)
    elif fmt in ("lis", "lisb", "lisl"):
        write_lis_vector(path, vec, mode={"lis": "A", "lisb": "B",
                                          "lisl": "L"}[fmt], nprocs=nprocs)
    else:
        raise ValueError(f"unsupported vector output format {fmt!r}")
