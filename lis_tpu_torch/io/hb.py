"""Harwell-Boeing I/O.

Port of ``lis_tpu/io/hb.py`` (reference: lis_input_hb,
src/system/lis_input_hb.c:59).  HB files are fixed-column Fortran
formatted: a 4-5 line header of line counts and formats, then column
pointers, row indices and values.  The reader takes RUA and CUA (the
reference's complex build, lis_input_hb.c:234), expands the symmetric and
Hermitian RSA/CSA/CHA to full storage and reads pattern matrices as ones;
it builds the port's ``CSCMatrix`` on the host and converts it to the
requested format on ``device``.  The writer writes RUA or CUA with
(10I8) pointers and indices and (3E25.16) values.
"""

from __future__ import annotations

import re

import numpy as np

from lis_tpu_torch.matrix.convert import convert_matrix
from lis_tpu_torch.matrix.csc import CSCMatrix


def _parse_fortran_format(fmt: str):
    """Parse e.g. '(10I8)' / '(4E20.12)' -> (count per line, width)."""
    m = re.match(r"\(\s*(\d+)?\s*[IiEeDdFfGg]\s*(\d+)", fmt.replace(" ", ""))
    if not m:
        m = re.match(r"\((\d+)?[IiEeDdFfGg](\d+)", fmt.replace(" ", ""))
    if not m:
        raise ValueError(f"cannot parse Fortran format {fmt!r}")
    return int(m.group(1) or 1), int(m.group(2))


def _read_fixed(lines, nlines, count, width, conv):
    vals = []
    for _ in range(nlines):
        line = next(lines).rstrip("\n")
        for k in range(0, len(line), width):
            tok = line[k:k + width].strip()
            if tok:
                vals.append(conv(tok.replace("D", "E").replace("d", "e")))
    return np.asarray(vals[:count])


def read_harwell_boeing(path: str, matrix_type: str = "csr", device=None,
                        **kw):
    """Read a Harwell-Boeing file into ``matrix_type`` on ``device`` (None:
    the default device).  Symmetric (S) and Hermitian (H) variants are
    expanded to full storage."""
    with open(path) as f:
        lines = iter(f.readlines())
    next(lines)                                    # title line
    l2 = next(lines)
    totcrd, ptrcrd, indcrd, valcrd = (int(l2[i:i + 14])
                                      for i in range(0, 56, 14))
    rhscrd = int(l2[56:70]) if len(l2.rstrip()) > 56 else 0
    l3 = next(lines)
    mxtype = l3[0:3].upper()
    nrow, ncol, nnzero = int(l3[14:28]), int(l3[28:42]), int(l3[42:56])
    l4 = next(lines)
    ptrfmt, indfmt = l4[0:16].strip(), l4[16:32].strip()
    valfmt = l4[32:52].strip()
    if rhscrd > 0:
        next(lines)                                # RHS format line

    pc, pw = _parse_fortran_format(ptrfmt)
    ic, iw = _parse_fortran_format(indfmt)
    ptr = _read_fixed(lines, ptrcrd, ncol + 1, pw, int) - 1
    index = _read_fixed(lines, indcrd, nnzero, iw, int) - 1
    if mxtype[0] == "P" or valcrd == 0:
        value = np.ones(nnzero)
    elif mxtype[0] == "C":                         # complex: (re, im) pairs
        vc, vw = _parse_fortran_format(valfmt)
        raw = _read_fixed(lines, valcrd, 2 * nnzero, vw, float)
        value = raw[0::2] + 1j * raw[1::2]
    else:
        vc, vw = _parse_fortran_format(valfmt)
        value = _read_fixed(lines, valcrd, nnzero, vw, float)

    if mxtype[1] in ("S", "H"):                    # symmetric: mirror lower
        import scipy.sparse as sp
        a = sp.csc_matrix((value, index, ptr), shape=(nrow, ncol))
        at = a.conj().T if mxtype[1] == "H" else a.T
        full = (a + at - sp.diags(a.diagonal())).tocsc()
        full.sort_indices()
        ptr, index, value = full.indptr, full.indices, full.data
    csc = CSCMatrix.from_csc_arrays(ptr, index, value, (nrow, ncol),
                                    device="cpu")
    return convert_matrix(csc, matrix_type, device=device, **kw)


def write_harwell_boeing(path: str, matrix, title: str = "lis_tpu matrix",
                         key: str = "LISTPU"):
    """Write RUA (real unsymmetric assembled) or, for complex values, CUA
    Harwell-Boeing.  Fixed formats: (10I8) pointers and indices,
    (3E25.16) values."""
    import scipy.sparse as sp
    rp, ri, rv = matrix.to_csr_arrays()
    a = sp.csr_matrix((rv, ri, rp), shape=matrix.shape).tocsc()
    a.sort_indices()
    ptr = a.indptr.astype(np.int64) + 1            # 1-based
    index = a.indices.astype(np.int64) + 1
    nrow, ncol = matrix.shape
    nnz = a.indptr[-1]
    if np.iscomplexobj(a.data):                    # CUA: (re, im) pairs
        value = np.empty(2 * nnz, dtype=np.float64)
        value[0::2] = a.data.real
        value[1::2] = a.data.imag
        mxtype = "CUA"
    else:
        value = np.asarray(a.data, dtype=np.float64)
        mxtype = "RUA"

    def lines_of(vals, per_line, fmt):
        vals = vals.tolist()
        return [(fmt * len(vals[k:k + per_line])) % tuple(vals[k:k + per_line])
                for k in range(0, len(vals), per_line)]

    plines = lines_of(ptr, 10, "%8d")
    ilines = lines_of(index, 10, "%8d")
    vlines = lines_of(value, 3, "%25.16E")
    with open(path, "w") as f:
        f.write(f"{title:<72.72}{key:<8.8}\n")
        tot = len(plines) + len(ilines) + len(vlines)
        f.write(f"{tot:14d}{len(plines):14d}{len(ilines):14d}"
                f"{len(vlines):14d}{0:14d}\n")
        f.write(f"{mxtype:<14.14}{nrow:14d}{ncol:14d}{nnz:14d}{0:14d}\n")
        f.write(f"{'(10I8)':<16.16}{'(10I8)':<16.16}{'(3E25.16)':<20.20}"
                f"{'':<20.20}\n")
        for ln in plines + ilines + vlines:
            f.write(ln + "\n")
