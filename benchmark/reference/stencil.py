"""Products of the 27-point operator A = diag·I + off·(N − I), N the sum
over the 3 × 3 × 3 neighbourhood inside the grid, computed on the grid
(x fastest) by separable window sums over a zero-padded copy.

``lower`` and ``upper`` are the strict triangles in the flat (x fastest)
order: the neighbours with a smaller flat index are the plane below, the
row below in the same plane and the point to the left.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _padded(v, grid):
    nx, ny, nz = grid
    return F.pad(v.view(nz, ny, nx), (1, 1, 1, 1, 1, 1))


def _sums(p):
    """(row sums along x, 3 × 3 plane sums) of the padded grid ``p``."""
    sx = p[:, :, :-2] + p[:, :, 1:-1] + p[:, :, 2:]
    plane = sx[:, :-2] + sx[:, 1:-1] + sx[:, 2:]
    return sx, plane


class Stencil27:
    """The plain operator the reference works with: ``n``, ``matvec``,
    the strict triangles ``lower`` and ``upper``, and ``diagonal``.  Its
    coefficients are whole numbers where ``diag`` and ``off`` are, so a
    product with a vector of small integers is exact in float64."""

    def __init__(self, grid, diag: float, off: float):
        self.grid, self.diag, self.off = tuple(grid), diag, off
        self.n = grid[0] * grid[1] * grid[2]

    def diagonal(self) -> float:
        return self.diag

    def matvec(self, v) -> torch.Tensor:
        p = _padded(v, self.grid)
        _, plane = _sums(p)
        box = plane[:-2] + plane[1:-1] + plane[2:]
        return ((self.diag - self.off) * p[1:-1, 1:-1, 1:-1]
                + self.off * box).reshape(-1)

    def lower(self, v) -> torch.Tensor:
        p = _padded(v, self.grid)
        sx, plane = _sums(p)
        s = plane[:-2] + sx[1:-1, :-2] + p[1:-1, 1:-1, :-2]
        return (self.off * s).reshape(-1)

    def upper(self, v) -> torch.Tensor:
        p = _padded(v, self.grid)
        sx, plane = _sums(p)
        s = plane[2:] + sx[1:-1, 2:] + p[1:-1, 1:-1, 2:]
        return (self.off * s).reshape(-1)
