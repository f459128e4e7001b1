"""Unified file I/O with format auto-detection.

Port of ``lis_tpu/io/__init__.py`` (reference: lis_input,
src/system/lis_input.c:67, sniffs the first line — "%%MatrixMarket" → MM,
"#LIS" → Lis native, otherwise Harwell-Boeing or PLAIN; lis_output,
src/system/lis_output.c:63).  Only ASCII MatrixMarket is ported: the Lis
native, Harwell-Boeing, PLAIN and binary MatrixMarket formats raise
``NotImplementedError`` (ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

from lis_tpu_torch.io.mm import (read_matrix_market, read_vector_mm,
                                 write_matrix_market, write_vector_mm)

__all__ = ["read_matrix_market", "read_vector_mm", "write_matrix_market",
           "write_vector_mm", "lis_input", "lis_input_vector", "lis_output"]


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to lis_tpu_torch yet (ROADMAP.md queue 1 "
        f"item 8); have ASCII MatrixMarket")


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
        raise _not_ported("the Lis native matrix format")
    # Harwell-Boeing has no magic banner; it is the remaining matrix format
    raise _not_ported("the Harwell-Boeing matrix format")


def lis_input_vector(path: str, device=None):
    """Read a vector onto ``device``: a MatrixMarket array or coordinate
    file (lis_input.c:176-248)."""
    fmt = _sniff(path)
    if fmt == "mm":
        return read_vector_mm(path, device=device)
    if fmt == "lis":
        raise _not_ported("the Lis native vector format")
    raise _not_ported("the PLAIN vector format")


def lis_output(path: str, matrix, b=None, x=None, fmt: str = "mm"):
    """Write a matrix in the requested format (lis_output, lis_output.c:63);
    "mm" is ASCII MatrixMarket with the Lis b/x extension."""
    if fmt == "mm":
        write_matrix_market(path, matrix, b=b, x=x)
    elif fmt in ("mmb", "lis", "hb"):
        raise _not_ported(f"output format {fmt!r}")
    else:
        raise ValueError(f"unsupported output format {fmt!r}")
