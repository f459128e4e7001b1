"""Block-row partitioning of a global dimension over ranks.

Port of ``lis_tpu/core/ranges.py``.  Semantics match the reference's 1-D
block partition with the remainder spread over the low ranks
(lis_ranges_create, src/system/lis_init.c:405, and the LIS_GET_ISIE
macro, include/lis.h:1067-1078): rank ``k`` of ``p`` owns rows
``[is_k, ie_k)`` where the first ``gn % p`` ranks get one extra row.

The distributed layer (``lis_tpu_torch.parallel``) pads every rank to the
same local size (``padded_local_n`` = ceil(gn / p) rows, the padding at
the end of the last rank), as lis_tpu does, so that every rank runs the
same loop on vectors of one length and the block-local preconditioners
factor the same blocks; these exact ranges describe the logical
ownership used by I/O and assembly.
"""

from __future__ import annotations

import numpy as np


def get_isie(k: int, nprocs: int, gn: int) -> tuple[int, int]:
    """Owned row range [is, ie) of rank k (LIS_GET_ISIE semantics)."""
    base, rem = divmod(gn, nprocs)
    is_ = k * base + min(k, rem)
    ie = is_ + base + (1 if k < rem else 0)
    return is_, ie


def ranges_create(nprocs: int, gn: int) -> np.ndarray:
    """Offsets array of length nprocs+1 (analogue of lis_ranges_create)."""
    ranges = np.zeros(nprocs + 1, dtype=np.int64)
    for k in range(nprocs):
        ranges[k + 1] = get_isie(k, nprocs, gn)[1]
    return ranges


def padded_local_n(nprocs: int, gn: int) -> int:
    """Uniform per-rank row count of the distributed layer (rows padded
    at the end)."""
    return -(-gn // nprocs)


def owner_of(row: int, nprocs: int, gn: int) -> int:
    """Which rank owns a global row under the exact (non-padded)
    partition."""
    base, rem = divmod(gn, nprocs)
    cut = rem * (base + 1)
    if row < cut:
        return row // (base + 1)
    return rem + (row - cut) // base if base > 0 else rem
