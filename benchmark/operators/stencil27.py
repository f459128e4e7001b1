"""The operator ``stencil27``: HPCG's 27-point stencil on an nx × ny × nz
grid (x fastest), ``diag`` on the diagonal and ``offdiag`` on every
neighbour of the 3 × 3 × 3 box inside the grid.  Configuration keys:
``grid``, ``diag``, ``offdiag``, ``dtype``.

- ``program``: the operator as the port is handed it.  Its diagonals are
  made on the device by a frozen copy of
  ``lis_tpu_torch/utils/testmat.py::poisson3d27_dia`` in plain torch, so
  that a change to the program cannot change its input, and handed to
  ``DIAMatrix.from_diagonals`` (Lis's ``lis_matrix_set_dia``).
- ``reference``: the plain operator of ``reference/stencil.py``, whose
  products are formed on the grid from the stencil itself, not from the
  diagonals the program was handed.
"""

from __future__ import annotations

import torch

from benchmark.reference.stencil import Stencil27


def diagonals(grid, diag: float, off: float, dtype, device):
    """(value (nnd, n), offsets, nnz) of the operator.  Legs that land on
    one flat offset (grids of 2 or less along an axis) are summed."""
    nx, ny, nz = grid
    n = nx * ny * nz
    legs = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)]
    offs = sorted({dx + dy * nx + dz * nx * ny for dx, dy, dz in legs})
    row = {o: k for k, o in enumerate(offs)}
    i = torch.arange(n, dtype=torch.int64, device=device)
    x, y, z = i % nx, (i // nx) % ny, i // (nx * ny)
    value = torch.zeros((len(offs), n), dtype=dtype, device=device)
    for dx, dy, dz in legs:
        valid = ((0 <= x + dx) & (x + dx < nx) & (0 <= y + dy)
                 & (y + dy < ny) & (0 <= z + dz) & (z + dz < nz))
        c = diag if (dx, dy, dz) == (0, 0, 0) else off
        value[row[dx + dy * nx + dz * nx * ny]] += valid.to(dtype) * c
    nnz = int(torch.count_nonzero(value))
    return value, offs, nnz


def program(config: dict, device):
    """(the port's operator, {"n", "nnd", "nnz"})."""
    from lis_tpu_torch import DIAMatrix
    g = config["grid"]
    n = g[0] * g[1] * g[2]
    value, offsets, nnz = diagonals(g, config["diag"], config["offdiag"],
                                    getattr(torch, config["dtype"]), device)
    A = DIAMatrix.from_diagonals(value, offsets, (n, n), nnz, device=device)
    return A, {"n": n, "nnd": len(offsets), "nnz": nnz}


def reference(config: dict, device) -> Stencil27:
    return Stencil27(config["grid"], config["diag"], config["offdiag"])
