"""The least time the card could take for one launch of a kernel: bytes
moved once over the memory rate, or operations over the arithmetic rate,
whichever is longer.  A frozen copy of ``chip_smoke.py``'s ``bound_ms``
and of the byte and operation counts it gives kernels E, H, M, J and L, so
that a change to the program cannot move the yardstick.

Peaks: NVIDIA H100 SXM data sheet, at its full power limit of 700 W (a
card set lower reads lower shares; every result line records the card's
limit beside them): 3.35 TB/s of HBM and 33.5 TFLOP/s in float64 outside
the tensor cores.  Every count is of float64 data.  Every input byte is counted once and
every output byte once, whatever a kernel reads again from its caches.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = 33.5e12
F64 = 8


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS_PER_S)


def dia_spmv(n: int, nnd: int) -> float:
    """Kernel E, y = A·x over nnd diagonals of n rows: the diagonals, x
    and y once; two operations a stored entry."""
    return bound_s((nnd + 2) * n * F64, 2 * nnd * n)


def dia_relax(n: int, nnd: int, vectors: int) -> float:
    """Kernel H, one relaxed sweep out = (rhs·rs − T·t)·w over nnd
    diagonals: the diagonals once and ``vectors`` n-vectors (rhs, out and
    whichever of rs, y, s, w the launch takes)."""
    return bound_s((nnd + vectors) * n * F64, (2 * nnd + 2) * n)


def ssor_adds_psolve(n: int, nnd: int, sweeps: int,
                     adds_iter: int) -> tuple[float, int]:
    """(bound s, H launches) of one psolve of SSOR by relaxed sweeps inside
    additive Schwarz, on an operator of nnd diagonals whose strict
    triangles hold (nnd − 1) / 2 each.  An SSOR psolve: the forward series
    on L (its first sweep reads rhs and w, the others also y), then the
    backward one on U with rhs scaled by rs (one vector more each); each
    refinement adds the residual b − A·x (rhs, y, out) and another SSOR
    psolve."""
    tri = (nnd - 1) // 2
    ssor = [(tri, 3)] + [(tri, 4)] * (sweeps - 1) \
        + [(tri, 4)] + [(tri, 5)] * (sweeps - 1)
    launches = ssor * (1 + adds_iter) + [(nnd, 3)] * adds_iter
    return (sum(dia_relax(n, d, v) for d, v in launches), len(launches))


def dd_dia_spmv(n: int, nnd: int, lo: bool) -> float:
    """Kernel M, the double-double y = A·x: the diagonals' high limbs (and
    low limbs where the operator has them), x and y as two float64 limbs
    each; 39 limb operations a stored entry."""
    nbytes = nnd * n * F64 * (2 if lo else 1) + 4 * n * F64
    return bound_s(nbytes, nnd * n * 39)


def lattice_prolong(n: int, nc: int, nnz: int) -> float:
    """Kernel J, fine += P·coarse over P's CSR (int32 columns, float64
    values): P, its row pointer, the coarse vector, the fine one in and
    out."""
    return bound_s(nnz * 12 + 4 * (n + 1) + (nc + 2 * n) * 8, 2 * nnz + n)


def lattice_restrict(n: int, nc: int, nnz: int) -> float:
    """Kernel L, coarse = Pᵀ·fine over Pᵀ's CSR."""
    return bound_s(nnz * 12 + 4 * (nc + 1) + (n + nc) * 8, 2 * nnz)
