"""Sparse triangular solves by level scheduling.

Port of ``lis_tpu/ops/trisolve.py`` (reference lis_matrix_solve_csr,
src/matrix/lis_matrix_csr.c:1525, x[i] = (b[i] − Σ T[i,j]x[j])·WD[i]).
The rows of a triangular matrix fall into levels: a row depends only on
rows of earlier levels.  ``make_plan`` computes them once on the host (the
native ``level_schedule``) and lays the triangle out twice:

- lis_tpu's padded arrays exactly: dense ``(nlev, max_rows)`` rows and
  ``(nlev, max_rows, max_nnz)`` columns and values.  The plain version
  runs on them, a loop over the levels of gather, row sum and scatter as
  lis_tpu's scan body; it is the CPU path and the card's oracle.
- a sliced-ELL copy in level-major order for kernel K
  (``csrc/trisolve.cu``): the rows of each level in units of 32 (a unit
  never spans two levels, so it never holds a row with one of its
  dependencies), entry j of the unit's lane t at ``sbase[u] + 32·j + t``,
  each unit padded only to its own longest row (column n, value 0).

``trisolve`` solves on a CUDA tensor in one launch of K, in which each row
waits on per-row ready flags of its own columns (kept beside the value in
a mailbox per row); on a CPU tensor it runs the plain version.

``sweep_series`` is the dependency-dropping alternative that the
reference itself takes across OpenMP threads (lis_matrix_csr.c:1577-1605):
fixed-point sweeps x ← (b − T·x)·dinv over a DIA triangle, one launch of
kernel H (or I, transposed) each.  SSOR, ILU(0)/ILUT/ILUC on DIA, the
GS/SOR lower solve and SA-AMG's lattice smoother run their sweeps through
it.  ``relaxed_sweeps`` is lis_tpu's own form of the same series
(``relaxed_sweeps(L, U, dinv, b, nsweeps, lower)``, ops/trisolve.py:110).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import TensorFields, static
from lis_tpu_torch.ops import _cuda


UNIT = 32                     # rows of a sliced-ELL unit: one warp


@dataclasses.dataclass(frozen=True, eq=False)
class TriSolvePlan(TensorFields):
    rows: torch.Tensor        # (nlev, max_rows) int32, padded with n
    cols: torch.Tensor        # (nlev, max_rows, max_nnz) int32, padded n
    vals: torch.Tensor        # (nlev, max_rows, max_nnz), padded 0
    dinv: torch.Tensor        # (n,) per-row multiplier (the reference's WD)
    # the sliced-ELL copy, units of UNIT rows in level-major order
    srows: torch.Tensor       # (nunits·UNIT,) int32 row ids, padded n
    sbase: torch.Tensor       # (nunits + 1,) int32 offset of each unit
    scols: torch.Tensor       # (sbase[-1],) int32, padded n
    svals: torch.Tensor       # (sbase[-1],), padded 0
    sdinv: torch.Tensor       # (nunits·UNIT,) dinv in srows' order, pad 0
    n: int = static()

    @property
    def nlev(self) -> int:
        return self.rows.shape[0]

    @property
    def nunits(self) -> int:
        return self.sbase.shape[0] - 1


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
    rows ascend; a row's entries keep their CSR order, in both layouts.
    ``vals`` and ``dinv`` share one dtype, the promotion of the two (the
    kernel takes one type for both)."""
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

    # the sliced-ELL copy: level l holds units ustart[l] .. ustart[l+1]-1
    lunits = -(-counts // UNIT)
    ustart = np.concatenate(([0], np.cumsum(lunits)))
    nunits = int(ustart[-1])
    sslot = ustart[lev] * UNIT + slot          # a row's slot in the copy
    srows = np.full(nunits * UNIT, n, dtype=np.int32)
    srows[sslot] = np.arange(n, dtype=np.int32)
    sdinv = np.zeros(nunits * UNIT, dtype=dt)
    sdinv[sslot] = dinv
    snnz = np.zeros(nunits * UNIT, dtype=np.int64)
    snnz[sslot] = row_nnz
    width = snnz.reshape(nunits, UNIT).max(axis=1)
    sbase = np.concatenate(([0], np.cumsum(width * UNIT)))
    if sbase[-1] > np.iinfo(np.int32).max:
        raise ValueError(f"make_plan: {sbase[-1]} sliced entries do not "
                         f"fit int32 offsets")
    epos_s = sbase[sslot[erow] // UNIT] + epos * UNIT + sslot[erow] % UNIT
    scols = np.full(int(sbase[-1]), n, dtype=np.int32)
    svals = np.zeros(int(sbase[-1]), dtype=dt)
    scols[epos_s] = index[:len(erow)]
    svals[epos_s] = value[:len(erow)]

    device = resolve_device(device)

    def up(a):
        return torch.from_numpy(a).to(device)
    return TriSolvePlan(rows=up(rows), cols=up(cols), vals=up(vals),
                        dinv=up(dinv.astype(dt)), srows=up(srows),
                        sbase=up(sbase.astype(np.int32)), scols=up(scols),
                        svals=up(svals), sdinv=up(sdinv), n=n)


def _trisolve_plain(plan: TriSolvePlan, b, rs=None):
    n = plan.n
    if rs is not None:
        b = b * rs
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


def _warps(plan: TriSolvePlan) -> int:
    """Warps for one launch of K: eight for each unit of the plan's widest
    level, so that several levels are in flight ahead of the wavefront.
    More warps only poll, and their polls crowd the memory pipes that the
    critical path uses; fewer leave units of a wide level waiting for a
    warp to claim them."""
    return 8 * -(-plan.rows.shape[1] // UNIT)


def trisolve(plan: TriSolvePlan, b: torch.Tensor,
             rs: torch.Tensor | None = None) -> torch.Tensor:
    """x such that (D̃ + T)x = b·rs, D̃ = 1/dinv and T the planned triangle
    (``rs`` absent meaning 1).  b[i]·rs[i] is one rounded product, as
    lis_tpu's ``trisolve(bwd, y * dtil)`` forms it.

    Kernel K on a CUDA tensor (lis_tpu: a ``lax.scan`` over the levels,
    ops/trisolve.py:92-107); the plain version on a CPU tensor.  Bound on
    the H100: the triangle's bytes once, but in practice the latency of
    the dependency chain, one poll of a row's columns per level."""
    if b.shape != (plan.n,):
        raise ValueError(f"trisolve: b has shape {tuple(b.shape)}, the plan "
                         f"{plan.n} rows")
    if rs is not None and rs.shape != (plan.n,):
        raise ValueError(f"trisolve: rs has shape {tuple(rs.shape)}, the "
                         f"plan {plan.n} rows")
    if not b.is_cuda:
        if b.device.type != "cpu":
            raise ValueError(f"no kernel or plain path for {b.device}")
        return _trisolve_plain(plan, b, rs)
    from lis_tpu_torch.matrix.dia import _REAL_OF
    vt = plan.svals.dtype
    dt = torch.promote_types(b.dtype, vt)
    if dt not in _cuda.DTYPE_CODE or plan.sdinv.dtype != vt \
            or vt not in (dt, _REAL_OF.get(dt)):
        raise ValueError(f"trisolve: plan {vt}/{plan.sdinv.dtype} with b "
                         f"{b.dtype} is not a pair the kernel takes")
    if b.dtype != dt:
        b = b.to(dt)
    if b.is_conj():
        b = b.resolve_conj()
    b = b.contiguous()
    _cuda.check(b, "b", dt, aligned=False)
    if rs is not None:
        if rs.is_conj():
            rs = rs.resolve_conj()
        _cuda.check(rs, "rs", vt, aligned=False)
    for name, t, want in (("srows", plan.srows, torch.int32),
                          ("sbase", plan.sbase, torch.int32),
                          ("scols", plan.scols, torch.int32),
                          ("svals", plan.svals, vt),
                          ("sdinv", plan.sdinv, vt)):
        _cuda.check(t, name, want, aligned=False)
    dev = b.device
    # the rows' mailboxes (a 64-bit word of value piece and ready flag for
    # each 4 bytes of x) and, after them, the counter from which warps
    # claim units: one set per launch, so that solves on other streams
    # never share them (the entry point zeroes them on the launch's stream)
    x = torch.empty(plan.n, dtype=dt, device=dev)
    mailbox = torch.empty(plan.n * (x.element_size() // 4) + 1,
                          dtype=torch.int64, device=dev)
    _cuda.launch("lis_trisolve_levels", _cuda.DTYPE_CODE[vt],
                 _cuda.DTYPE_CODE[dt], plan.srows.data_ptr(),
                 plan.sbase.data_ptr(), plan.scols.data_ptr(),
                 plan.svals.data_ptr(), plan.sdinv.data_ptr(), b.data_ptr(),
                 None if rs is None else rs.data_ptr(), x.data_ptr(), plan.n,
                 plan.nunits, _warps(plan), mailbox.data_ptr(),
                 _cuda.stream())
    trisolve.launches += 1
    return x


trisolve.launches = 0


def sweep_series(T, rhs: torch.Tensor, nsweeps: int, *, y=None, s=None,
                 w=None, rs=None, trans: bool = False) -> torch.Tensor:
    """``nsweeps`` Jacobi-relaxed sweeps over the DIA triangle ``T``,
    y ← (rhs·rs − T·(s⊙y))·w (Tᴴ with ``trans``), from the given ``y`` or
    else from the start y = (rhs·rs)·w.  Every sweep series of the port
    runs through it: SSOR, ILU(0)/ILUT/ILUC on DIA, the GS/SOR lower solve
    and SA-AMG's lattice smoother.  Each sweep is one launch of kernel H
    (I with ``trans``); the start takes none of its own.  ``s``, ``w`` and
    ``rs`` are optional, absent meaning 1."""
    from lis_tpu_torch.matrix.dia import dia_relax, dia_relaxh
    if nsweeps < 1:
        raise ValueError("sweep_series: nsweeps must be at least 1")
    if y is None and s is not None:
        raise ValueError("sweep_series: s scales a given y; the start "
                         "vector takes none")
    fn = dia_relaxh if trans else dia_relax
    kw = dict(s=s, w=w, rs=rs)
    y = fn(T, rhs, **kw, start=True) if y is None else fn(T, rhs, y, **kw)
    for _ in range(nsweeps - 1):
        y = fn(T, rhs, y, **kw)
    return y


def relaxed_sweeps(L, U, dinv, b, nsweeps: int = 2, lower: bool = True):
    """lis_tpu's ``relaxed_sweeps`` (ops/trisolve.py:110) with its
    signature and result: the Jacobi-relaxed solve of (D + T)x = b with
    T = L (``lower``) or U, x = b·dinv, then ``nsweeps`` times
    x = (b − T·x)·dinv.  A DIA triangle runs the series on kernel H; any
    other format (an object with ``matvec``) runs lis_tpu's loop as it
    is."""
    T = L if lower else U
    if nsweeps < 1:
        return b * dinv
    if getattr(T, "format_name", None) == "dia":
        return sweep_series(T, b, nsweeps, w=dinv)
    x = b * dinv
    for _ in range(nsweeps):
        x = (b - T.matvec(x)) * dinv
    return x
