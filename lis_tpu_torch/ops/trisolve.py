"""Sparse triangular solves by level scheduling.

Port of ``lis_tpu/ops/trisolve.py`` (reference lis_matrix_solve_csr,
src/matrix/lis_matrix_csr.c:1525, x[i] = (b[i] − Σ T[i,j]x[j])·WD[i]).
The rows of a triangular matrix fall into levels: a row depends only on
rows of earlier levels.  ``make_plan`` computes them once on the host (the
native ``level_schedule``) and pads them into dense ``(nlev, max_rows)``
rows and ``(nlev, max_rows, max_nnz)`` columns and values, the arrays of
lis_tpu's plan exactly.  ``trisolve`` runs every level on the device: on a
CUDA tensor in one launch of kernel K (``csrc/trisolve.cu``, a persistent
grid with a grid-wide barrier between levels), on a CPU tensor as the
plain version, a loop over the levels of gather, row sum and scatter as
lis_tpu's scan body.

``relaxed_sweeps`` is the dependency-dropping alternative that the
reference itself takes across OpenMP threads (lis_matrix_csr.c:1577-1605):
fixed-point sweeps x ← (b − T·x)·dinv over a DIA triangle, one launch of
kernel H (or I, transposed) each.  SSOR, ILU(0) on DIA and the GS/SOR
lower solve run their sweeps through it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import TensorFields, static
from lis_tpu_torch.ops import _cuda


@dataclasses.dataclass(frozen=True, eq=False)
class TriSolvePlan(TensorFields):
    rows: torch.Tensor        # (nlev, max_rows) int32, padded with n
    cols: torch.Tensor        # (nlev, max_rows, max_nnz) int32, padded n
    vals: torch.Tensor        # (nlev, max_rows, max_nnz), padded 0
    dinv: torch.Tensor        # (n,) per-row multiplier (the reference's WD)
    n: int = static()

    @property
    def nlev(self) -> int:
        return self.rows.shape[0]


def _levels(ptr, index, lower: bool):
    from lis_tpu_torch import _native
    n = len(ptr) - 1
    sched = _native.level_schedule(ptr, index, lower)
    if sched is not None:
        nlev, lev = sched
        return nlev, lev.astype(np.int64)
    lev = np.zeros(n, dtype=np.int64)
    order = range(n) if lower else range(n - 1, -1, -1)
    for i in order:
        deps = index[ptr[i]:ptr[i + 1]]
        if len(deps):
            lev[i] = lev[deps].max() + 1
    return (int(lev.max()) + 1 if n else 1), lev


def make_plan(ptr, index, value, dinv, lower: bool = True,
              device=None) -> TriSolvePlan:
    """Level-scheduled plan of strictly triangular CSR arrays, on
    ``device`` (None: the default device, the card).

    ``dinv`` is the per-row multiplier applied after the subtraction: D⁻¹
    for GS, (D/ω)⁻¹ for SOR, U[ii]⁻¹ for ILU factors.  Within a level the
    rows ascend; a row's entries keep their CSR order.  ``vals`` and
    ``dinv`` share one dtype, the promotion of the two (the kernel takes
    one type for both)."""
    ptr = np.asarray(ptr)
    index = np.asarray(index)
    value = np.asarray(value)
    dinv = np.asarray(dinv)
    n = len(ptr) - 1
    nlev, lev = _levels(ptr, index, lower)

    counts = np.bincount(lev, minlength=nlev)
    max_rows = max(int(counts.max()) if n else 0, 1)
    row_nnz = np.diff(ptr).astype(np.int64)
    max_nnz = max(int(row_nnz.max()) if n else 0, 1)
    # a row's slot within its level: rows ascend within a level
    order = np.argsort(lev, kind="stable")
    start = np.concatenate(([0], np.cumsum(counts)[:-1]))
    slot = np.empty(n, dtype=np.int64)
    slot[order] = np.arange(n) - start[lev[order]]

    dt = np.result_type(value.dtype, dinv.dtype)
    rows = np.full((nlev, max_rows), n, dtype=np.int32)
    cols = np.full((nlev, max_rows, max_nnz), n, dtype=np.int32)
    vals = np.zeros((nlev, max_rows, max_nnz), dtype=dt)
    rows[lev, slot] = np.arange(n, dtype=np.int32)
    erow = np.repeat(np.arange(n, dtype=np.int64), row_nnz)
    epos = np.arange(len(erow), dtype=np.int64) - np.asarray(ptr)[erow]
    cols[lev[erow], slot[erow], epos] = index[:len(erow)]
    vals[lev[erow], slot[erow], epos] = value[:len(erow)]

    device = resolve_device(device)
    return TriSolvePlan(rows=torch.from_numpy(rows).to(device),
                        cols=torch.from_numpy(cols).to(device),
                        vals=torch.from_numpy(vals).to(device),
                        dinv=torch.from_numpy(dinv.astype(dt)).to(device),
                        n=n)


def _trisolve_plain(plan: TriSolvePlan, b):
    n = plan.n
    dt = torch.promote_types(b.dtype, plan.vals.dtype)
    b_ext = torch.cat([b.to(dt), torch.zeros(1, dtype=dt, device=b.device)])
    dinv_ext = torch.cat([plan.dinv, torch.zeros(1, dtype=plan.dinv.dtype,
                                                 device=b.device)])
    x = torch.zeros(n + 1, dtype=dt, device=b.device)
    for rows, cols, vals in zip(plan.rows.long(), plan.cols.long(),
                                plan.vals):
        gath = (vals * x[cols]).sum(-1)
        x[rows] = (b_ext[rows] - gath) * dinv_ext[rows]
    return x[:n]


def trisolve(plan: TriSolvePlan, b: torch.Tensor) -> torch.Tensor:
    """x such that (D̃ + T)x = b, D̃ = 1/dinv and T the planned triangle.

    Kernel K on a CUDA tensor (lis_tpu: a ``lax.scan`` over the levels,
    ops/trisolve.py:92-107); the plain version on a CPU tensor.  Bound on
    the H100: the plan's bytes once, but in practice the latency of
    ``nlev`` dependent levels, each ended by a grid-wide barrier."""
    if b.shape != (plan.n,):
        raise ValueError(f"trisolve: b has shape {tuple(b.shape)}, the plan "
                         f"{plan.n} rows")
    if not b.is_cuda:
        if b.device.type != "cpu":
            raise ValueError(f"no kernel or plain path for {b.device}")
        return _trisolve_plain(plan, b)
    from lis_tpu_torch.matrix.dia import _REAL_OF
    vt = plan.vals.dtype
    dt = torch.promote_types(b.dtype, vt)
    if dt not in _cuda.DTYPE_CODE or plan.dinv.dtype != vt \
            or vt not in (dt, _REAL_OF.get(dt)):
        raise ValueError(f"trisolve: plan {vt}/{plan.dinv.dtype} with b "
                         f"{b.dtype} is not a pair the kernel takes")
    if b.dtype != dt:
        b = b.to(dt)
    if b.is_conj():
        b = b.resolve_conj()
    b = b.contiguous()
    for name, t, want in (("rows", plan.rows, torch.int32),
                          ("cols", plan.cols, torch.int32),
                          ("vals", plan.vals, vt), ("dinv", plan.dinv, vt)):
        _cuda.check(t, name, want, aligned=False)
    nlev, max_rows = plan.rows.shape
    max_nnz = plan.cols.shape[2]
    dev = b.device
    # the grid-wide barrier's counter, one per launch so that solves on
    # other streams never share it (the entry point zeroes it on the
    # launch's stream)
    arr = torch.empty(1, dtype=torch.int32, device=dev)
    x = torch.empty(plan.n, dtype=dt, device=dev)
    _cuda.launch("lis_trisolve_levels", _cuda.DTYPE_CODE[vt],
                 _cuda.DTYPE_CODE[dt], plan.rows.data_ptr(),
                 plan.cols.data_ptr(), plan.vals.data_ptr(),
                 plan.dinv.data_ptr(), b.data_ptr(), x.data_ptr(), plan.n,
                 nlev, max_rows, max_nnz, arr.data_ptr(), _cuda.stream())
    trisolve.launches += 1
    return x


trisolve.launches = 0


def relaxed_sweeps(T, rhs: torch.Tensor, nsweeps: int, *, y=None, s=None,
                   w=None, rs=None, trans: bool = False) -> torch.Tensor:
    """``nsweeps`` Jacobi-relaxed sweeps over the DIA triangle ``T``,
    y ← (rhs·rs − T·(s⊙y))·w (Tᴴ with ``trans``), from the given ``y`` or
    else from the start y = (rhs·rs)·w.  The form of lis_tpu's
    ``relaxed_sweeps`` (ops/trisolve.py:110) that every sweep series of the
    port runs: SSOR, ILU(0) on DIA and the GS/SOR lower solve.  Each sweep
    is one launch of kernel H (I with ``trans``); the start takes none of
    its own.  ``s``, ``w`` and ``rs`` are optional, absent meaning 1."""
    from lis_tpu_torch.matrix.dia import dia_relax, dia_relaxh
    if nsweeps < 1:
        raise ValueError("relaxed_sweeps: nsweeps must be at least 1")
    if y is None and s is not None:
        raise ValueError("relaxed_sweeps: s scales a given y; the start "
                         "vector takes none")
    fn = dia_relaxh if trans else dia_relax
    kw = dict(s=s, w=w, rs=rs)
    y = fn(T, rhs, **kw, start=True) if y is None else fn(T, rhs, y, **kw)
    for _ in range(nsweeps - 1):
        y = fn(T, rhs, y, **kw)
    return y
