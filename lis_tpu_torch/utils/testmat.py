"""Generated test problems, equivalents of the reference's test programs.

Port of ``lis_tpu/utils/testmat.py``; every generator takes ``device``
(None: the default device, the card).

- tridiag(n): the 1-D Laplacian of spmvtest1 (test/spmvtest1.c:139-150)
- poisson2d(m, n): 2-D 5-point Poisson of test2 (test/test2.c:112-127)
- poisson3d(l, m, n): 3-D 7-point Poisson of test3
- poisson3d27(l, m, n): 27-point HPCG-style operator of test3b
  (diag 26.0, off-diag -1.0; test/test3b.c:127)
- poisson3d27_dia(l, m, n): the same operator built directly in DIA form
- poisson3d_jump(l, m, n): 7-point Poisson with a coefficient jump
- gamma_matrix(n, gamma): the ill-conditioned bidiagonal quad-precision
  test matrix of test5 (rows [gamma, 1, 2]; test/test5.c:96-105)
- random_sparse(n): random diagonally dominant or SPD matrix
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.csr import CSRMatrix


def _to_matrix(a, device=None) -> CSRMatrix:
    a = a.tocsr()
    a.sum_duplicates()
    a.sort_indices()
    return CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape,
                                     device=device)


def tridiag(n: int, diag: float = 2.0, off: float = -1.0,
            device=None) -> CSRMatrix:
    return _to_matrix(sp.diags([off, diag, off], [-1, 0, 1], shape=(n, n)),
                      device)


def poisson2d(m: int, n: int, device=None) -> CSRMatrix:
    ix = sp.identity(m)
    iy = sp.identity(n)
    tx = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(m, m))
    ty = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    return _to_matrix(sp.kron(iy, tx) + sp.kron(ty, ix), device)


def poisson3d(l: int, m: int, n: int, device=None) -> CSRMatrix:
    def lap(k):
        return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    il, im, in_ = sp.identity(l), sp.identity(m), sp.identity(n)
    a = (sp.kron(sp.kron(in_, im), lap(l))
         + sp.kron(sp.kron(in_, lap(m)), il)
         + sp.kron(sp.kron(lap(n), im), il))
    return _to_matrix(a, device)


def poisson3d27(l: int, m: int, n: int, device=None) -> CSRMatrix:
    """27-point stencil, diag 26, off-diag -1 (HPCG-style, test/test3b.c:127)."""
    ids = np.arange(l * m * n).reshape(n, m, l)
    rows, cols, vals = [], [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                src = ids[max(0, -dz):n - max(0, dz),
                          max(0, -dy):m - max(0, dy),
                          max(0, -dx):l - max(0, dx)]
                dst = ids[max(0, dz):n - max(0, -dz),
                          max(0, dy):m - max(0, -dy),
                          max(0, dx):l - max(0, -dx)]
                val = 26.0 if (dx, dy, dz) == (0, 0, 0) else -1.0
                rows.append(src.ravel())
                cols.append(dst.ravel())
                vals.append(np.full(src.size, val))
    a = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(l * m * n, l * m * n))
    return _to_matrix(a, device)


def poisson3d_jump(l: int, m: int, n: int, jump: float = 1e4,
                   seed: int = 0, pattern: str = "cube",
                   device=None) -> CSRMatrix:
    """7-point variable-coefficient Poisson with a discontinuous
    coefficient field (face values by harmonic mean): the condition
    number scales with the jump ratio.  ``pattern`` is "cube" (a
    high-coefficient center cube) or "checker" (3-D 2^3-block
    checkerboard)."""
    N = l * m * n
    i = np.arange(N, dtype=np.int64)
    x, y, z = i % l, (i // l) % m, i // (l * m)
    if pattern == "checker":
        blk = max(2, min(l, m, n) // 8)
        hi = ((x // blk + y // blk + z // blk) % 2).astype(bool)
    else:
        hi = ((l // 4 <= x) & (x < 3 * l // 4)
              & (m // 4 <= y) & (y < 3 * m // 4)
              & (n // 4 <= z) & (z < 3 * n // 4))
    k = np.where(hi, jump, 1.0)

    rows, cols, vals = [], [], []
    diag = np.zeros(N)
    for d, lim, coord in ((1, l, x), (l, m, y), (l * m, n, z)):
        mask = coord < lim - 1          # face between i and i+d
        a = k[i[mask]]
        b = k[i[mask] + d]
        w = 2.0 * a * b / (a + b)       # harmonic mean
        rows += [i[mask], i[mask] + d]
        cols += [i[mask] + d, i[mask]]
        vals += [-w, -w]
        np.add.at(diag, i[mask], w)
        np.add.at(diag, i[mask] + d, w)
        # homogeneous Dirichlet boundary faces (keeps A nonsingular SPD)
        diag[coord == 0] += k[coord == 0]
        diag[coord == lim - 1] += k[coord == lim - 1]
    rows.append(i)
    cols.append(i)
    vals.append(diag)
    a = sp.coo_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(N, N))
    return _to_matrix(a, device)


def gamma_matrix(n: int, gamma: float = 2.0, device=None) -> CSRMatrix:
    """The test5 quad-precision demo matrix (test/test5.c:96-105):
    A[i,i-2] = γ, A[i,i] = 2, A[i,i+1] = 1 — ill-conditioned for γ ≈ 2."""
    a = sp.diags([np.full(n - 2, gamma), np.full(n, 2.0), np.ones(n - 1)],
                 [-2, 0, 1])
    return _to_matrix(a.tocsr(), device)


def random_sparse(n: int, density: float = 0.05, seed: int = 0,
                  spd: bool = False, device=None) -> CSRMatrix:
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=density, random_state=rng, format="csr")
    if spd:
        a = a @ a.T + n * sp.identity(n)
    else:
        a = a + n * sp.identity(n)     # diagonally dominant, nonsymmetric
    return _to_matrix(a.tocsr(), device)


def poisson3d27_dia(l, m, n, dtype=torch.float64, device=None):
    """27-point 3-D Poisson operator built directly in DIA form, on
    ``device``: O(27·N) memory and no host CSR, which at 192³ would take
    several GB.  Same operator as poisson3d27 (diag 26, off-diag -1;
    test/spmvtest3b.c)."""
    from lis_tpu_torch.matrix.dia import DIAMatrix
    device = resolve_device(device)
    N = l * m * n
    legs = [(dx, dy, dz) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)]
    # tiny grids (l <= 2 or m <= 2) make different stencil legs collide on
    # the same flat offset: their values are summed
    offs = sorted({dx + dy * l + dz * l * m for dx, dy, dz in legs})
    row = {o: k for k, o in enumerate(offs)}
    i = torch.arange(N, dtype=torch.int64, device=device)
    x, y, z = i % l, (i // l) % m, i // (l * m)
    value = torch.zeros((len(offs), N), dtype=dtype, device=device)
    for dx, dy, dz in legs:
        valid = ((0 <= x + dx) & (x + dx < l) & (0 <= y + dy) & (y + dy < m)
                 & (0 <= z + dz) & (z + dz < n))
        c = 26.0 if (dx, dy, dz) == (0, 0, 0) else -1.0
        value[row[dx + dy * l + dz * l * m]] += valid.to(dtype) * c
    return DIAMatrix.from_diagonals(value, offs, (N, N),
                                    nnz=int(torch.count_nonzero(value)))
