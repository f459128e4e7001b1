"""ILU preconditioners: ILU(k), ILUT and Crout ILU.

Port of ``lis_tpu/precon/ilu.py`` (reference lis_precon_iluk.c: symbolic
factorisation :263, numeric :638, psolve :880; lis_precon_ilut.c:67, the
dual-threshold ILUT; lis_precon_iluc.c:67, Crout ILU).  Options:
-ilu_fill k (ILU(k), default 0); -iluc_drop (0.05) and -iluc_rate (5.0)
for ILUT and ILUC.  The factorisation runs on the host at creation, in
the native library where it applies (``iluk_factor``, ``ilut_factor``,
``iluc_factor`` for a real CSR, ``ilu0_dia`` for ILU(0) of a real DIA)
and otherwise in the Python loops (complex data); the factors go to the
operator's device.

- ``ILUDiaPrecon``: ILU(0) of a real DIA operator.  ILU(0) keeps the
  pattern, so L and U are DIA with the operator's offsets; each triangular
  solve is ``-ssor_sweeps`` Jacobi-relaxed sweeps (the reference's OpenMP
  solve relaxes dependencies the same way, lis_matrix_csr.c:1577-1605), one
  launch of kernel H (I for psolveh) each.
  ILUT and ILUC of a real DIA operator take the same apply when their
  factors fit on few diagonals (``_maybe_dia_apply``, as in lis_tpu).
- ``ILUPrecon``: every other case (ILU(k) of CSR, HDI, CSS, CST; a complex
  DIA; fill > 0; ILUT and ILUC whose factors do not fit): exact
  level-scheduled solves (``ops/trisolve.py``, kernel K), with the
  conjugate-transposed factors for psolveh.
- ``BlockILUPrecon`` and ``VBlockILUPrecon``: block ILU(k) of a BSR or a
  VBR operator, M = (I + L)·D·(I + Û), Û = D⁻¹U, factored block by block
  in lis_tpu's Python loops on the host.  Each apply is two unit
  triangular solves of the block-expanded factors on level plans (two
  launches of K) around the block D⁻¹: one batched torch product over
  (nr, bnr, bnr) for BSR, diagonal streams (DIA, kernel E) or a padded
  batched product for the variable blocks of VBR.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from lis_tpu_torch.matrix.base import TensorFields, conj, static
from lis_tpu_torch.matrix.dia import DIAMatrix
from lis_tpu_torch.ops.trisolve import (TriSolvePlan, make_plan,
                                        sweep_series, trisolve)
from lis_tpu_torch.precon.base import register_precon
from lis_tpu_torch.utils.trace import psolve_span


@dataclasses.dataclass(frozen=True, eq=False)
class ILUPrecon(TensorFields):
    lower: TriSolvePlan       # unit L (dinv = 1)
    upper: TriSolvePlan       # U (dinv = 1/U_ii)
    lower_t: TriSolvePlan     # Uᴴ (for the Mᴴ solve)
    upper_t: TriSolvePlan     # Lᴴ (unit)

    @psolve_span
    def psolve(self, r):
        return trisolve(self.upper, trisolve(self.lower, r))

    @psolve_span
    def psolveh(self, r):
        return trisolve(self.upper_t, trisolve(self.lower_t, r))


def _factor_iluk(ptr, index, value, n, fill):
    """Level-of-fill ILU(k), IKJ variant (Saad Alg. 10.5; the reference's
    lis_symbolic_fact_csr + lis_numerical_fact_csr combined): one dict per
    factored row, column -> value."""
    rows_val = []
    rows_lev = []
    for i in range(n):
        work = {}
        lev = {}
        for p in range(ptr[i], ptr[i + 1]):
            work[int(index[p])] = value[p]
            lev[int(index[p])] = 0
        if i not in work:
            work[i] = 0.0
            lev[i] = 0
        for k in sorted(work):
            if k >= i:
                break
            lk = lev[k]
            if lk > fill:
                continue
            ukk = rows_val[k].get(k, 0.0)
            if ukk == 0.0:
                continue
            factor = work[k] / ukk
            work[k] = factor
            for j, vkj in rows_val[k].items():
                if j <= k:
                    continue
                new_lev = lk + rows_lev[k][j] + 1
                if j in work:
                    work[j] -= factor * vkj
                    lev[j] = min(lev[j], new_lev)
                elif new_lev <= fill:
                    work[j] = -factor * vkj
                    lev[j] = new_lev
        # drop entries above the fill level (original entries are level 0)
        keep = {j: v for j, v in work.items() if lev[j] <= fill}
        if keep.get(i, 0.0) == 0.0:
            keep[i] = 1.0
        rows_val.append(keep)
        rows_lev.append(lev)
    return rows_val


def _factor_ilut(ptr, index, value, n, drop, rate):
    """Dual-threshold ILUT with the reference's rules
    (lis_precon_ilut.c:61-63,129-131,230-320), the Python fallback of the
    native ``ilut_factor`` (complex data):
    - the drop tolerance is relative to the MEAN |a_ij| of the row;
    - the elimination factor is never dropped; only update terms with
      |l_ik·u_kj| < tol that would create NEW fill are skipped;
    - the final keep is the top lfil = (nnz/2n)·rate entries per side by
      magnitude (no tolerance filter), the diagonal always kept."""
    import heapq
    rows_val = []
    diag = np.zeros(n, dtype=value.dtype)
    nnz_tot = int(ptr[n]) if len(ptr) > n else len(value)
    lfil = max(int((nnz_tot / (2.0 * max(n, 1))) * rate), 1)
    for i in range(n):
        work = {}
        abssum = 0.0
        for p in range(ptr[i], ptr[i + 1]):
            c = int(index[p])
            work[c] = work.get(c, 0.0) + value[p]
            abssum += abs(value[p])
        k_cnt = max(ptr[i + 1] - ptr[i], 1)
        nrm = abssum / k_cnt or 1.0
        tol_i = drop * nrm

        heap = [c for c in work if c < i]
        heapq.heapify(heap)
        done = set()
        while heap:
            k = heapq.heappop(heap)
            if k in done or k not in work:
                continue
            done.add(k)
            dk = diag[k]
            if dk == 0.0:
                continue
            fact = work[k] / dk
            work[k] = fact
            for j, ukj in rows_val[k].items():
                if j <= k:
                    continue
                lxu = -fact * ukj
                if abs(lxu) < tol_i and j not in work:
                    continue
                work[j] = work.get(j, 0.0) + lxu
                if j < i and j not in done:
                    heapq.heappush(heap, j)

        dv = work.get(i, 0.0)
        if dv == 0.0:
            dv = nrm
        lower = sorted(((abs(v), j) for j, v in work.items() if j < i),
                       reverse=True)[:lfil]
        upper = sorted(((abs(v), j) for j, v in work.items() if j > i),
                       reverse=True)[:lfil]
        keep = {j: work[j] for _, j in lower}
        keep.update({j: work[j] for _, j in upper})
        keep[i] = dv
        diag[i] = dv
        rows_val.append(keep)
    return rows_val


def _factor_iluc(ptr, index, value, n, drop, rate):
    """Crout ILU (Li/Saad/Chow; reference lis_precon_iluc.c:67), the
    Python fallback of the native ``iluc_factor`` (complex data): step k
    computes row k of U and column k of L, each with the relative drop
    tolerance -iluc_drop and the fill bound -iluc_rate.  Updates read the
    already dropped entries of both factors, so the factors differ from
    ILUT's whenever dropping is active."""
    Urows = [dict() for _ in range(n)]     # row k of U (with the diagonal)
    Lcols = [dict() for _ in range(n)]     # column k of L (strict)
    Lrows = [dict() for _ in range(n)]     # the row view of L
    Ucols = [dict() for _ in range(n)]     # the column view of strict U
    Acols = [[] for _ in range(n)]         # strict-lower A by column
    rownrm = np.zeros(n)
    colnrm = np.zeros(n)
    nnz_col = np.zeros(n, dtype=np.int64)
    nnz_row = np.diff(ptr)
    for i in range(n):
        for p in range(ptr[i], ptr[i + 1]):
            vp = value[p]
            c = int(index[p])
            a2 = abs(vp) ** 2          # vp*vp for real, |vp|^2 complex
            rownrm[i] += a2
            colnrm[c] += a2
            nnz_col[c] += 1
            if c < i:
                Acols[c].append((i, vp))
    rownrm = np.sqrt(rownrm)
    colnrm = np.sqrt(colnrm)
    rownrm[rownrm == 0] = 1.0
    colnrm[colnrm == 0] = 1.0

    for k in range(n):
        z = {}
        for p in range(ptr[k], ptr[k + 1]):
            c = int(index[p])
            if c >= k:
                z[c] = z.get(c, 0.0) + value[p]
        for j, lkj in Lrows[k].items():
            for c, u in Urows[j].items():
                if c >= k:
                    z[c] = z.get(c, 0.0) - lkj * u
        w = {}
        for r, vp in Acols[k]:
            w[r] = w.get(r, 0.0) + vp
        for j, ujk in Ucols[k].items():
            for r, l in Lcols[j].items():
                if r > k:
                    w[r] = w.get(r, 0.0) - ujk * l
        dv = z.pop(k, 0.0)
        if dv == 0.0:
            dv = rownrm[k]
        tol_r = drop * rownrm[k]
        tol_c = drop * colnrm[k]
        keep_u = sorted(((c, v) for c, v in z.items() if abs(v) >= tol_r),
                        key=lambda t: -abs(t[1]))[
            :max(int(rate * nnz_row[k]), 2)]
        Urows[k] = {k: dv, **dict(keep_u)}
        for c, v in keep_u:
            Ucols[c][k] = v
        keep_l = sorted(((r, v) for r, v in w.items() if abs(v) >= tol_c),
                        key=lambda t: -abs(t[1]))[
            :max(int(rate * nnz_col[k]), 2)]
        Lcols[k] = {r: v / dv for r, v in keep_l}
        for r, v in keep_l:
            Lrows[r][k] = v / dv

    return [{**Lrows[i], **Urows[i]} for i in range(n)]


def _plans_from_rows(rows_val, n, shape, device):
    li, lv, lp = [], [], [0]
    ui, uv, up = [], [], [0]
    dtype = (np.complex128
             if any(isinstance(v, complex) or np.iscomplexobj(v)
                    for row in rows_val for v in row.values())
             else np.float64)
    udiag = np.zeros(n, dtype=dtype)
    for i in range(n):
        for j in sorted(rows_val[i]):
            v = rows_val[i][j]
            if j < i:
                li.append(j)
                lv.append(v)
            else:
                ui.append(j)
                uv.append(v)
                if j == i:
                    udiag[i] = v
        lp.append(len(li))
        up.append(len(ui))
    return _plans_from_lu(np.asarray(lp, dtype=np.int32),
                          np.asarray(li, dtype=np.int32),
                          np.asarray(lv, dtype=dtype),
                          np.asarray(up, dtype=np.int32),
                          np.asarray(ui, dtype=np.int32),
                          np.asarray(uv, dtype=dtype), udiag, n, shape,
                          device)


def _plans_from_combined_csr(ptr, index, value, n, shape, device):
    """Split a combined LU CSR (the factors of L below the diagonal, U with
    its diagonal) into the plan arrays: the native factorisation's
    output."""
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    lower = index < rows
    udiag = np.zeros(n, dtype=value.dtype)
    isd = index == rows
    np.add.at(udiag, rows[isd], value[isd])

    def side(mask):
        r, c, v = rows[mask], index[mask], value[mask]
        p = np.zeros(n + 1, dtype=np.int32)
        np.add.at(p, r + 1, 1)
        return np.cumsum(p).astype(np.int32), c.astype(np.int32), v

    lp, li, lv = side(lower)
    up, ui, uv = side(~lower)
    return _plans_from_lu(lp, li, lv, up, ui, uv, udiag, n, shape, device)


def _plans_from_lu(lp, li, lv, up, ui, uv, udiag, n, shape, device):
    with np.errstate(divide="ignore"):
        udinv = np.where(udiag != 0, 1.0 / np.where(udiag != 0, udiag, 1),
                         1.0)

    # the strictly upper part of U for the solve (its diagonal is dinv)
    urows = np.repeat(np.arange(n), np.diff(up))
    strict = ui != urows
    sui, suv = ui[strict], uv[strict]
    sup = np.zeros(n + 1, dtype=np.int32)
    np.add.at(sup, urows[strict] + 1, 1)
    sup = np.cumsum(sup).astype(np.int32)

    lower = make_plan(lp, li, lv, np.ones(n), lower=True, device=device)
    upper = make_plan(sup, sui, suv, udinv, lower=False, device=device)

    # Mᴴx = b: Uᴴ (lower, diagonal multiplier 1/conj(u_ii)), then Lᴴ (unit)
    Ut = sp.csr_matrix((suv, sui, sup), shape=shape).T.tocsr()
    Lt = sp.csr_matrix((lv, li, lp), shape=shape).T.tocsr()
    Ut.sort_indices()
    Lt.sort_indices()
    lower_t = make_plan(Ut.indptr, Ut.indices, np.conj(Ut.data), np.conj(udinv),
                        lower=True, device=device)
    upper_t = make_plan(Lt.indptr, Lt.indices, np.conj(Lt.data), np.ones(n),
                        lower=False, device=device)
    return ILUPrecon(lower=lower, upper=upper, lower_t=lower_t,
                     upper_t=upper_t)


@dataclasses.dataclass(frozen=True, eq=False)
class ILUDiaPrecon(TensorFields):
    """ILU factors on DIA (ILU(0), or ILUT/ILUC whose factors fit),
    applied by relaxed sweeps of the factors' diagonals (lis_tpu
    ``ILUDiaPrecon``, ilu.py:305-337), in lis_tpu's order of operations:

        psolve:  y = r, nsweeps × y = r − L·y; z = y·udinv, nsweeps ×
                 z = (y − U·z)·udinv
        psolveh: w = r·ū, nsweeps × w = (r − Uᴴw)·ū (ū = conj(udinv));
                 z = w, nsweeps × z = w − Lᴴz
    """
    L: DIAMatrix              # strict-lower factor (unit diagonal implied)
    U: DIAMatrix              # strict-upper factor
    udinv: torch.Tensor       # 1 / diag(U)
    nsweeps: int = static()

    @psolve_span
    def psolve(self, r):
        ns, ud = self.nsweeps, self.udinv
        if ns == 0:
            return r * ud
        y = sweep_series(self.L, r, ns)
        return sweep_series(self.U, y, ns, w=ud)

    @psolve_span
    def psolveh(self, r):
        ns = self.nsweeps
        ud = self.udinv.conj().resolve_conj() if self.udinv.is_complex() \
            else self.udinv
        if ns == 0:
            return r * ud
        w = sweep_series(self.U, r, ns, w=ud, trans=True)
        return sweep_series(self.L, w, ns, trans=True)


def _dia_from_csr(ptr, index, value, n, device):
    """Combined factor CSR arrays → (strict-lower DIA, strict-upper DIA,
    the diagonal as a host array)."""
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    offs_all = index.astype(np.int64) - rows
    diag = np.zeros(n, dtype=value.dtype)
    isd = offs_all == 0
    np.add.at(diag, rows[isd], value[isd])

    def side(mask):
        offs = np.unique(offs_all[mask])
        v = np.zeros((len(offs), n), dtype=value.dtype)
        if mask.any():
            pos = np.searchsorted(offs, offs_all[mask])
            np.add.at(v, (pos, rows[mask]), value[mask])
        return DIAMatrix.from_diagonals(v, offs, (n, n),
                                        nnz=int(np.count_nonzero(v)),
                                        device=device)
    return side(offs_all < 0), side(offs_all > 0), diag


def _udinv(d):
    with np.errstate(divide="ignore"):
        return np.where(d != 0, 1.0 / np.where(d != 0, d, 1), 1.0)


@register_precon("ilu")
def create_iluk(A, opts):
    fill = getattr(opts, "ilu_fill", 0)
    ns = int(getattr(opts, "ssor_sweeps", 2))
    dev = A.device
    fmt = getattr(A, "format_name", None)
    if fmt == "bsr":
        return _create_bilu(A, fill)
    if fmt == "vbr":
        vb = _create_vbilu(A, fill)
        if vb is not None:
            return vb
    if getattr(A, "format_name", None) == "dia" and fill == 0 \
            and not A.value.is_complex():
        from lis_tpu_torch import _native
        n = A.nrows
        # the native factor works on a float64 host copy of the diagonals
        lu = _native.ilu0_dia(np.asarray(A.offsets), A.value_2d)
        if lu is not None:
            # the factors go up in the operator's dtype
            in_dt = torch.empty(0, dtype=A.value.dtype).numpy().dtype
            lu = lu.astype(in_dt, copy=False)
            nnz_row = np.count_nonzero(lu, axis=1)
            F = DIAMatrix.from_diagonals(lu, A.offsets, A.shape,
                                         nnz=int(nnz_row.sum()), device=dev)
            offs = A.offsets

            def side(sel):
                ks = [k for k, o in enumerate(offs) if sel(o)]
                return F.diagonals(ks, nnz=int(sum(nnz_row[k] for k in ks)))
            d = lu[offs.index(0)]
            return ILUDiaPrecon(L=side(lambda o: o < 0),
                                U=side(lambda o: o > 0),
                                udinv=torch.from_numpy(_udinv(d)).to(dev),
                                nsweeps=ns)
        # no native library: the generic factorisation, applied on DIA
        ptr, index, value = A.to_csr_arrays()
        rows_val = _factor_iluk(ptr, index, value, n, 0)
        fi, fv, fp = [], [], [0]
        for i in range(n):
            for j in sorted(rows_val[i]):
                fi.append(j)
                fv.append(rows_val[i][j])
            fp.append(len(fi))
        L, U, d = _dia_from_csr(np.asarray(fp, np.int32),
                                np.asarray(fi, np.int32), np.asarray(fv), n,
                                dev)
        return ILUDiaPrecon(L=L, U=U, udinv=torch.from_numpy(_udinv(d)).to(dev),
                            nsweeps=ns)
    ptr, index, value = A.to_csr_arrays()
    if not np.iscomplexobj(value):
        from lis_tpu_torch import _native
        out = _native.iluk_factor(ptr, index, value, fill)
        if out is not None:
            return _plans_from_combined_csr(*out, A.nrows, A.shape, dev)
    rows = _factor_iluk(ptr, index, value, A.nrows, fill)
    return _plans_from_rows(rows, A.nrows, A.shape, dev)


def _maybe_dia_apply(fp, fi, fv, A, opts, max_nnd=512):
    """The relaxed-sweep apply for a factored LU in CSR when its factors
    fit on few diagonals (lis_tpu ``_maybe_dia_apply``, ilu.py:741-757):
    the factors of a banded operator keep roughly its profile, so the
    psolve runs as diagonal streams (kernels H and I) instead of level
    plans.  None when they do not fit."""
    n = A.nrows
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(fp))
    offs = np.unique(fi.astype(np.int64) - rows)
    if len(offs) > max_nnd or len(offs) * n > 4 * max(len(fv), 1):
        return None
    L, U, d = _dia_from_csr(fp, fi, fv, n, A.device)
    return ILUDiaPrecon(L=L, U=U, udinv=torch.from_numpy(_udinv(d)).to(
        A.device), nsweeps=int(getattr(opts, "ssor_sweeps", 2)))


def _create_threshold(A, opts, native, factor_py):
    """ILUT or ILUC: the native factor for real data (on DIA through
    ``_maybe_dia_apply`` where the factors fit), else the Python factor;
    level plans otherwise."""
    from lis_tpu_torch import _native
    ptr, index, value = A.to_csr_arrays()
    drop = getattr(opts, "iluc_drop", 0.05)
    rate = getattr(opts, "iluc_rate", 5.0)
    if not np.iscomplexobj(value):
        out = getattr(_native, native)(ptr, index, value, drop, rate)
        if out is not None:
            if getattr(A, "format_name", None) == "dia":
                fast = _maybe_dia_apply(*out, A, opts)
                if fast is not None:
                    return fast
            return _plans_from_combined_csr(*out, A.nrows, A.shape,
                                            A.device)
    rows = factor_py(ptr, index, value, A.nrows, drop, rate)
    return _plans_from_rows(rows, A.nrows, A.shape, A.device)


@register_precon("ilut")
def create_ilut(A, opts):
    """Dual-threshold ILUT (reference lis_precon_ilut.c:67)."""
    return _create_threshold(A, opts, "ilut_factor", _factor_ilut)


@register_precon("iluc")
def create_iluc(A, opts):
    """Crout ILU (reference lis_precon_iluc.c:67): row-of-U/column-of-L
    factorisation with -iluc_drop / -iluc_rate, distinct from ILUT."""
    return _create_threshold(A, opts, "iluc_factor", _factor_iluc)


# ---- block ILU of BSR and VBR operators ---------------------------------------

def _promoted_einsum(eq, b, z):
    dt = torch.promote_types(b.dtype, z.dtype)
    return torch.einsum(eq, b.to(dt), z.to(dt))


@dataclasses.dataclass(frozen=True, eq=False)
class BlockILUPrecon(TensorFields):
    """Block ILU(k) of a BSR operator (lis_tpu ``BlockILUPrecon``,
    ilu.py:438-469; reference lis_precon_iluk.c:1289 symbolic, :1670
    numeric, :1990 psolve): M = (I + L)·D·(I + Û) with block factors,
    Û = D⁻¹U.  An apply is a level-scheduled unit solve of the expanded
    L, one batched (nr, bnr, bnr) product with D⁻¹, and a unit solve of
    the expanded Û."""
    lower: TriSolvePlan       # expanded L (unit diagonal)
    upper: TriSolvePlan       # expanded Û = D⁻¹U (unit diagonal)
    lower_t: TriSolvePlan     # Ûᴴ (unit lower)
    upper_t: TriSolvePlan     # Lᴴ (unit upper)
    dinv: torch.Tensor        # (nr, bnr, bnr) inverted diagonal blocks
    n: int = static()         # the unpadded size
    bnr: int = static()

    def _apply(self, r, lo, d, up):
        N = d.shape[0] * self.bnr
        rp = r if r.shape[0] == N else torch.cat([r, r.new_zeros(N - r.shape[0])])
        z = trisolve(lo, rp)
        w = _promoted_einsum("tij,tj->ti", d, z.view(-1, self.bnr))
        return trisolve(up, w.reshape(-1))[: self.n]

    @psolve_span
    def psolve(self, r):
        return self._apply(r, self.lower, self.dinv, self.upper)

    @psolve_span
    def psolveh(self, r):
        dh = self.dinv.transpose(1, 2)
        return self._apply(r, self.lower_t, dh.conj() if dh.is_complex()
                           else dh, self.upper_t)


def _bilu_symbolic(bptr, bindex, nr, fill):
    """Level-of-fill pattern at block granularity (lis_tpu
    ``_bilu_symbolic``; the reference's lis_symbolic_fact_bsr,
    lis_precon_iluk.c:1289): one ascending pivot pass per row, a fill
    entry kept where lev(j) + lev(U_jk) + 1 <= fill."""
    import heapq
    upat = []
    rows = []
    for i in range(nr):
        lev = {int(j): 0 for j in bindex[bptr[i]:bptr[i + 1]]}
        lev.setdefault(i, 0)
        heap = [c for c in lev if c < i]
        heapq.heapify(heap)
        seen = set()
        while heap:
            j = heapq.heappop(heap)
            if j in seen:
                continue
            seen.add(j)
            lj = lev[j]
            for k, lu in upat[j].items():
                lv = lj + lu + 1
                if lv <= fill:
                    if k not in lev:
                        if k < i:
                            heapq.heappush(heap, k)
                        lev[k] = lv
                    elif lv < lev[k]:
                        lev[k] = lv
        rows.append(sorted(lev))
        upat.append({k: v for k, v in lev.items() if k > i})
    return rows


def _block_ikj(patt, stored, sizes, dtype):
    """Block IKJ elimination on the symbolic pattern (lis_tpu
    ``_factor_bilu`` and the loop of ``_create_vbilu``; the reference's
    lis_numerical_fact_bsr / _vbr): L_ij <- A_ij·D_j⁻¹, row updates
    −L_ij·U_jk kept on the pattern, D_i inverted after its row (pinv where
    singular; a missing diagonal block is the identity).  Returns
    (L rows, U rows, the D⁻¹ blocks)."""
    Dinv, Lrows, Urows = [], [], []
    for i in range(len(patt)):
        row = {c: np.zeros((sizes[i], sizes[c]), dtype=dtype)
               for c in patt[i]}
        row.update(stored[i])
        for j in (c for c in patt[i] if c < i):
            Lij = row[j] @ Dinv[j]
            row[j] = Lij
            for k, Ujk in Urows[j].items():
                tgt = row.get(k)
                if tgt is not None:
                    tgt -= Lij @ Ujk
        d = row.get(i)
        if d is None:
            d = np.eye(sizes[i], dtype=dtype)
        try:
            Dinv.append(np.linalg.inv(d))
        except np.linalg.LinAlgError:
            Dinv.append(np.linalg.pinv(d))
        Urows.append({k: v for k, v in row.items() if k > i})
        Lrows.append({k: v for k, v in row.items() if k < i})
    return Lrows, Urows, Dinv


def _blocks_to_strict_csr(rows, nr, bnr, dtype):
    indptr, indices, data = [0], [], []
    for row in rows:
        for c in sorted(row):
            indices.append(c)
            data.append(row[c])
        indptr.append(len(indices))
    if not indices:
        return sp.csr_matrix((nr * bnr, nr * bnr), dtype=dtype)
    m = sp.bsr_matrix((np.asarray(data, dtype=dtype),
                       np.asarray(indices, np.int32),
                       np.asarray(indptr, np.int32)),
                      shape=(nr * bnr, nr * bnr)).tocsr()
    m.eliminate_zeros()
    m.sort_indices()
    return m


def _create_bilu(A, fill):
    """Block ILU(fill) of a BSR operator (lis_tpu ``_create_bilu``,
    ilu.py:556-578): padded rows get a unit diagonal so every D block is
    regular."""
    p, i, v = A.to_csr_arrays()
    N = A.nr * A.bnr
    a = sp.csr_matrix((v, i, p), shape=A.shape)
    a.resize((N, N))
    if N > A.nrows:
        pad_d = np.arange(A.nrows, N)
        a = (a + sp.coo_matrix((np.ones(len(pad_d)), (pad_d, pad_d)),
                               shape=(N, N))).tocsr()
    b = sp.bsr_matrix(a, blocksize=(A.bnr, A.bnr))
    b.sort_indices()
    dtype = b.data.dtype if np.iscomplexobj(b.data) else np.float64
    patt = _bilu_symbolic(b.indptr, b.indices, A.nr, fill)
    stored = [{int(b.indices[q]): b.data[q].astype(dtype)
               for q in range(b.indptr[t], b.indptr[t + 1])}
              for t in range(A.nr)]
    Lrows, Urows, Dinv = _block_ikj(patt, stored, [A.bnr] * A.nr, dtype)
    Dinv = np.asarray(Dinv, dtype=dtype).reshape(A.nr, A.bnr, A.bnr)
    Ut_rows = [{k: Dinv[t] @ blk for k, blk in Urows[t].items()}
               for t in range(A.nr)]
    L = _blocks_to_strict_csr(Lrows, A.nr, A.bnr, dtype)
    U = _blocks_to_strict_csr(Ut_rows, A.nr, A.bnr, dtype)
    lo, up, lo_t, up_t = _unit_factor_plans(L, U, A.device)
    return BlockILUPrecon(lower=lo, upper=up, lower_t=lo_t, upper_t=up_t,
                          dinv=torch.from_numpy(Dinv).to(A.device),
                          n=A.nrows, bnr=A.bnr)


def _unit_factor_plans(L, U, device):
    """Level plans of the unit factors (I + L), (I + Û) and of their
    conjugate transposes, from strictly triangular CSR parts."""
    n = L.shape[0]
    ones = np.ones(n, dtype=L.dtype)
    LH = L.conj().T.tocsr()
    UH = U.conj().T.tocsr()
    LH.sort_indices()
    UH.sort_indices()
    return (make_plan(L.indptr, L.indices, L.data, ones, lower=True,
                      device=device),
            make_plan(U.indptr, U.indices, U.data, ones, lower=False,
                      device=device),
            make_plan(UH.indptr, UH.indices, UH.data, ones, lower=True,
                      device=device),
            make_plan(LH.indptr, LH.indices, LH.data, ones, lower=False,
                      device=device))


@dataclasses.dataclass(frozen=True, eq=False)
class VBlockILUPrecon(TensorFields):
    """Variable-block ILU(k) of a VBR operator (lis_tpu ``VBlockILUPrecon``,
    ilu.py:598-644; reference lis_precon_iluk.c:2220-2905): blocks sized
    by the VBR partition.  D⁻¹ (variable block sizes) applies as the
    diagonals of its scalar expansion (``dL``, ``dU``, ``dd``) where the
    largest block is at most 64, else as a product of the blocks padded
    to the largest (``pbinv``, ``pidx``).  The reference leaves the
    transposed apply unimplemented; lis_tpu and the port have it."""
    lower: TriSolvePlan
    upper: TriSolvePlan
    lower_t: TriSolvePlan
    upper_t: TriSolvePlan
    dL: object                # strict-lower DIA of the expanded D⁻¹
    dU: object                # strict-upper DIA
    dd: object                # its diagonal
    pbinv: object             # (nbl, mb, mb) padded D⁻¹ blocks, or None
    pidx: object              # (nbl, mb) row of each slot, n for padding

    def _pad_apply(self, binv, x):
        xp = torch.cat([x, x.new_zeros(1)])
        z = _promoted_einsum("kij,kj->ki", binv, xp[self.pidx])
        out = torch.zeros(x.shape[0] + 1, dtype=z.dtype, device=z.device)
        return out.index_add_(0, self.pidx.reshape(-1), z.reshape(-1))[:-1]

    def _dinv(self, x):
        if self.pbinv is not None:
            return self._pad_apply(self.pbinv, x)
        return self.dL.matvec(x) + self.dU.matvec(x) + self.dd * x

    def _dinvh(self, x):
        if self.pbinv is not None:
            return self._pad_apply(conj(self.pbinv).transpose(1, 2), x)
        return self.dL.matvech(x) + self.dU.matvech(x) + conj(self.dd) * x

    @psolve_span
    def psolve(self, r):
        return trisolve(self.upper, self._dinv(trisolve(self.lower, r)))

    @psolve_span
    def psolveh(self, r):
        return trisolve(self.upper_t, self._dinvh(trisolve(self.lower_t, r)))


def _create_vbilu(A, fill):
    """Block ILU(fill) of a VBR operator (lis_tpu ``_create_vbilu``,
    ilu.py:647-735); None where the row and column partitions differ or
    every block is 1x1 (the scalar ILU is the same and cheaper)."""
    part = tuple(A.row_part)
    if part != tuple(A.col_part) or A.shape[0] != A.shape[1]:
        return None
    sizes = np.diff(np.asarray(part))
    if not len(sizes) or sizes.max() <= 1:
        return None
    nr = len(part) - 1
    p, i, v = A.to_csr_arrays()
    a = sp.csr_matrix((v, i, p), shape=A.shape)
    bptr, bindex = np.asarray(A.bptr), np.asarray(A.bindex)
    dtype = np.complex128 if np.iscomplexobj(v) else np.float64
    stored = [{} for _ in range(nr)]
    for bi in range(nr):
        r0, r1 = part[bi], part[bi + 1]
        for q in range(bptr[bi], bptr[bi + 1]):
            bj = int(bindex[q])
            stored[bi][bj] = a[r0:r1, part[bj]:part[bj + 1]] \
                .toarray().astype(dtype)
    patt = _bilu_symbolic(bptr, bindex, nr, fill)
    Lrows, Urows, Dinv = _block_ikj(patt, stored, sizes, dtype)
    n = A.shape[0]

    def expand(rows_of_blocks):
        rr, cc, vv = [], [], []
        for bi, row in enumerate(rows_of_blocks):
            for bj, blk in row.items():
                ri, ci = np.nonzero(blk)
                rr.append(ri + part[bi])
                cc.append(ci + part[bj])
                vv.append(blk[ri, ci])
        if not rr:
            return sp.csr_matrix((n, n), dtype=dtype)
        m = sp.coo_matrix((np.concatenate(vv),
                           (np.concatenate(rr), np.concatenate(cc))),
                          shape=(n, n)).tocsr()
        m.sort_indices()
        return m

    Ut_rows = [{k: Dinv[t] @ blk for k, blk in Urows[t].items()}
               for t in range(nr)]
    dev = A.device
    lo, up, lo_t, up_t = _unit_factor_plans(expand(Lrows), expand(Ut_rows),
                                            dev)
    mb = int(sizes.max())
    if mb <= 64:
        # small blocks: the 2·mb − 1 diagonals of D⁻¹'s scalar expansion
        Dx = expand([{bi: Dinv[bi]} for bi in range(nr)])
        dLo, dUp, dd = _dia_from_csr(Dx.indptr, Dx.indices, Dx.data, n, dev)
        return VBlockILUPrecon(lower=lo, upper=up, lower_t=lo_t,
                               upper_t=up_t, dL=dLo, dU=dUp,
                               dd=torch.from_numpy(dd).to(dev), pbinv=None,
                               pidx=None)
    # a large block would cost 2·mb − 1 length-n diagonals: pad the blocks
    # to mb and apply one batched product instead (memory nr·mb² <= n·mb)
    pidx = np.full((nr, mb), n, np.int64)
    pbinv = np.zeros((nr, mb, mb), dtype=dtype)
    for k in range(nr):
        pidx[k, :sizes[k]] = np.arange(part[k], part[k + 1])
        pbinv[k, :sizes[k], :sizes[k]] = Dinv[k]
    return VBlockILUPrecon(lower=lo, upper=up, lower_t=lo_t, upper_t=up_t,
                           dL=None, dU=None, dd=None,
                           pbinv=torch.from_numpy(pbinv).to(dev),
                           pidx=torch.from_numpy(pidx).to(dev))
