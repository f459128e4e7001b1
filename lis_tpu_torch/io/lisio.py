"""Lis native file formats (reference: lis_input / lis_output,
src/system/lis_input.c:67, src/system/lis_output.c:63-449).

Port of ``lis_tpu/io/lisio.py``.  Matrix flavour: a ``#LIS ascii coo``
header, the size line ``n m nnz has_b has_x`` and 1-based triplets, then
b and x as ``i value`` lines (the reference compiles its LIS_FMT_LIS matrix
reader out, lis_input.c:109-117, so this layout is lis_tpu's own).

Vector flavour: the reference's ``#LIS A vec`` layout exactly
(lis_output_vector_lis_ascii, lis_output.c:56: "%28.20e " values three a
line under per-PE "# pe n" headers), and the binary ``B``/``L`` flavours
whose headers lis_input_vector_lis (lis_input.c:470-495) classifies, as
big/little-endian i64 counts and f64 values (c16 with the count negated
for complex data), byte-swapped on reading where the file's order is not
the host's.  Readers put what they read on ``device`` (None: the default
device, the card).
"""

from __future__ import annotations

import struct
import sys

import numpy as np
import torch

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import SparseMatrix, host
from lis_tpu_torch.matrix.convert import convert_matrix
from lis_tpu_torch.matrix.coo import COOMatrix


def write_lis_file(path: str, matrix: SparseMatrix, b=None, x=None):
    """Write the Lis native matrix triplet flavour (and b, x if given)."""
    ptr, index, value = matrix.to_csr_arrays()
    n, m = matrix.shape
    rows = np.repeat(np.arange(n), np.diff(ptr))
    with open(path, "w") as f:
        f.write("#LIS ascii coo\n")
        f.write(f"{n} {m} {len(value)} "
                f"{1 if b is not None else 0} {1 if x is not None else 0}\n")
        for r, c, v in zip(rows, index, value):
            f.write(f"{r+1} {c+1} {v:.16e}\n")
        for vec in (b, x):
            if vec is not None:
                for i, v in enumerate(host(vec)):
                    f.write(f"{i+1} {v:.16e}\n")


def read_lis_file(path: str, matrix_type: str = "csr", device=None, **kw):
    """Returns (matrix, b or None, x or None), all on ``device``."""
    device = resolve_device(device)
    with open(path) as f:
        header = f.readline()
        if not header.startswith("#LIS"):
            raise ValueError(f"not a LIS ascii file: {header!r}")
        n, m, nnz, has_b, has_x = (int(t) for t in f.readline().split()[:5])
        data = np.loadtxt(f, max_rows=nnz, ndmin=2)
        b = x = None
        if has_b:
            b = np.loadtxt(f, max_rows=n, ndmin=2)[:, 1]
        if has_x:
            x = np.loadtxt(f, max_rows=n, ndmin=2)[:, 1]
    coo = COOMatrix.from_arrays(data[:, 0].astype(np.int32) - 1,
                                data[:, 1].astype(np.int32) - 1, data[:, 2],
                                (n, m), device="cpu")

    def vec(v):
        return None if v is None else \
            torch.from_numpy(np.ascontiguousarray(v)).to(device)
    return convert_matrix(coo, matrix_type, device=device, **kw), vec(b), \
        vec(x)


# ---------------------------------------------------------------------------
# Vector flavour: "#LIS <mode> vec"
# ---------------------------------------------------------------------------

_VEC_MAGIC = {"A": b"#LIS A vec", "B": b"#LIS B vec", "L": b"#LIS L vec"}


def _sections(v: np.ndarray, nprocs: int):
    """Split v into nprocs contiguous block-row sections."""
    starts = [(len(v) * p) // nprocs for p in range(nprocs + 1)]
    return [(p, v[starts[p]:starts[p + 1]]) for p in range(nprocs)]


def write_lis_vector(path: str, vec, mode: str = "A", nprocs: int = 1):
    """Write a vector in the Lis native format.

    mode="A": byte-compatible with lis_output_vector_lis_ascii
    (lis_output.c:56): "#LIS A vec", the nprocs line, then per PE a
    "# pe n" header and "%28.20e " values three a line (complex: (re, im)
    pairs, lis_output.c:519).  mode="B"/"L": the binary flavours
    (big/little endian), the same layout with i64 counts and f64 values."""
    if mode not in _VEC_MAGIC:
        raise ValueError(f"lis vector mode must be A, B or L, got {mode!r}")
    v = host(vec)
    secs = _sections(v, nprocs)
    is_complex = np.iscomplexobj(v)
    if mode == "A":
        with open(path, "w") as f:
            f.write("#LIS A vec\n")
            f.write(f"{nprocs}\n")
            for pe, part in secs:
                f.write(f"# {pe} {len(part)}\n")
                for i, val in enumerate(part):
                    if is_complex:
                        f.write("%28.20e %28.20e " % (val.real, val.imag))
                    else:
                        f.write("%28.20e " % float(val))
                    if (i + 1) % 3 == 0:
                        f.write("\n")
                if len(part) % 3 != 0:
                    f.write("\n")
        return
    end = ">" if mode == "B" else "<"
    with open(path, "wb") as f:
        f.write(_VEC_MAGIC[mode] + b"\n")
        f.write(struct.pack(end + "q", nprocs))
        for pe, part in secs:
            f.write(struct.pack(end + "qq", pe,
                                -len(part) if is_complex else len(part)))
            f.write(np.asarray(part, dtype=end + ("c16" if is_complex
                                                  else "f8")).tobytes())


def _read_ascii_vector(path: str) -> np.ndarray:
    parts, declared = {}, {}
    with open(path) as f:
        f.readline()
        nprocs = int(f.readline().split()[0])
        pe, vals = None, []
        for line in f:
            if line.startswith("#"):
                if pe is not None:
                    parts[pe] = vals
                _, pe_s, n_s = line.split()
                pe, vals = int(pe_s), []
                declared[pe] = int(n_s)
            else:
                vals.extend(float(t) for t in line.split())
        if pe is not None:
            parts[pe] = vals
    if len(parts) != nprocs:
        raise ValueError(f"expected {nprocs} PE sections, got {len(parts)}")
    out = []
    for p in sorted(parts):
        a, n = np.asarray(parts[p]), declared[p]
        if len(a) == n:                             # real section
            out.append(a)
        elif len(a) == 2 * n:                       # (re, im) pairs
            out.append(a[0::2] + 1j * a[1::2])
        else:
            raise ValueError(
                f"LIS vector section pe={p} declares n={n} but holds "
                f"{len(a)} values — truncated or corrupt file")
    return np.concatenate(out)


def _read_binary_vector(path: str, end: str) -> np.ndarray:
    with open(path, "rb") as f:
        f.read(11)                                  # magic + newline
        (nprocs,) = struct.unpack(end + "q", f.read(8))
        chunks = {}
        for _ in range(nprocs):
            hdr = f.read(16)
            if len(hdr) < 16:
                raise ValueError("LIS binary vector file truncated "
                                 "(missing section header)")
            pe, n = struct.unpack(end + "qq", hdr)
            cplx = n < 0                            # negated count: c16
            n = -n if cplx else n
            esz = 16 if cplx else 8
            raw = f.read(esz * n)
            if len(raw) < esz * n:
                raise ValueError(
                    f"LIS binary vector section pe={pe} declares n={n} "
                    f"but holds {len(raw) // esz} values — truncated file")
            chunks[pe] = np.frombuffer(raw,
                                       dtype=end + ("c16" if cplx else "f8"))
    flat = np.concatenate([chunks[p] for p in sorted(chunks)])
    if (end == ">") != (sys.byteorder == "big"):
        flat = flat.astype("=c16" if np.iscomplexobj(flat) else "=f8")
    return flat


def read_lis_vector(path: str, device=None) -> torch.Tensor:
    """Read a Lis native vector file of any mode onto ``device``."""
    with open(path, "rb") as f:
        head = f.read(10)
    if not head.startswith(b"#LIS"):
        raise ValueError(f"not a LIS vector file: {head!r}")
    mode = chr(head[5])
    if mode == "A":
        flat = _read_ascii_vector(path)
    elif mode in ("B", "L"):
        flat = _read_binary_vector(path, ">" if mode == "B" else "<")
    else:
        raise ValueError(f"unknown LIS vector mode {mode!r}")
    return torch.from_numpy(np.array(flat)).to(resolve_device(device))
