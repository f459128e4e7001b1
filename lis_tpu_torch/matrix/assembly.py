"""Incremental matrix assembly (the reference's RCO path).

Port of ``lis_tpu/matrix/assembly.py`` (reference: lis_matrix_set_value
appends into per-row dynamic arrays, src/matrix/lis_matrix.c:700, RCO
format src/matrix/lis_matrix_rco.c, and lis_matrix_assemble,
lis_matrix.c:607, converts to the target format).  The builder keeps COO
triplets on the host and assembles into any ported format on ``device``
(None: the default device, the card).  LIS_INS_VALUE overwrites the
entry of the same (i, j) and LIS_ADD_VALUE adds a new triplet, which the
conversion to CSR sums, with lis_tpu's semantics for repeated keys.
"""

from __future__ import annotations

import numpy as np

from lis_tpu_torch.matrix.base import SparseMatrix
from lis_tpu_torch.matrix.convert import convert_matrix
from lis_tpu_torch.matrix.coo import COOMatrix

LIS_INS_VALUE = 0
LIS_ADD_VALUE = 1


class MatrixAssembler:
    """Build a sparse matrix entry by entry, then ``assemble()``."""

    def __init__(self, shape: tuple[int, int], dtype=np.float64):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self._rows: list[int] = []
        self._cols: list[int] = []
        self._vals: list = []
        self._ins: dict[tuple[int, int], int] = {}

    def set_value(self, flag: int, i: int, j: int, value) -> "MatrixAssembler":
        """lis_matrix_set_value; flag = LIS_INS_VALUE | LIS_ADD_VALUE.  An
        insert overwrites the latest triplet of (i, j), an add appends."""
        if not (0 <= i < self.shape[0] and 0 <= j < self.shape[1]):
            raise IndexError(f"entry ({i},{j}) outside {self.shape}")
        key = (i, j)
        if flag == LIS_INS_VALUE and key in self._ins:
            self._vals[self._ins[key]] = value
            return self
        self._ins[key] = len(self._vals)
        self._rows.append(i)
        self._cols.append(j)
        self._vals.append(value)
        return self

    def set_values(self, flag: int, rows, cols, values) -> "MatrixAssembler":
        for i, j, v in zip(np.asarray(rows).ravel(), np.asarray(cols).ravel(),
                           np.asarray(values).ravel()):
            self.set_value(flag, int(i), int(j), v)
        return self

    def assemble(self, matrix_type: str = "csr", device=None,
                 **kw) -> SparseMatrix:
        """The matrix in ``matrix_type`` on ``device``."""
        coo = COOMatrix.from_arrays(
            np.asarray(self._rows, dtype=np.int32),
            np.asarray(self._cols, dtype=np.int32),
            np.asarray(self._vals, dtype=self.dtype), self.shape,
            device="cpu")
        return convert_matrix(coo, matrix_type, device=device, **kw)
