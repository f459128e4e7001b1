"""Double-double ("quad") arithmetic: error-free transforms on tensor pairs.

Port of ``lis_tpu/core/ddreal.py`` (reference src/precision/: the scalar
is a (hi, lo) double pair, include/lis.h:295-311, with TWO_SUM, SPLIT,
TWO_PROD and QUAD_ADD/MUL/DIV/SQRT, include/lis_precision.h:94-296; the
vector kernels of src/precision/lis_precision_vec.c and the quad SpMV of
lis_precision_matvec.c:55).

A DD value is a ``DD(hi, lo)`` pair of tensors on one device: f64 limbs
(``-f quad``) or f32 limbs ("double-float", ``-f df``; unit roundoff
2^-48).  Every transform is a chain of separately rounded IEEE operations,
and that is what makes it exact: PyTorch runs each operation as its own
kernel, so nothing contracts a product and a sum into a fused multiply-add
(lis_tpu needs an optimisation barrier and XLA's fusion pass turned off
for the same guarantee).

On the card the vector work takes four hand-written kernels
(``csrc/dd.cu``); each wrapper below launches its kernel for a CUDA tensor
and takes the plain version beside it for a CPU tensor:

- M ``dd_dia_spmv``: the DIA matvec and matvech (``DDDiaOperator``);
- N ``dd_ell_spmv``: the ELL gather pair (``DDOperator``);
- O ``dd_reduce``: ``dot``, ``nrm2``, ``nrm1`` and ``_dd_sum``, lis_tpu's
  pairwise halving tree over the power-of-two padding, bit for bit;
- P ``dd_update``: ``axpy``, ``xpay`` and ``scal`` with a DD scalar alpha
  read on the device, and the elementwise ``add``, ``sub``, ``mul``,
  ``div`` and ``sqrt``; on 0-d pairs these are the solvers' DD scalar
  algebra, which so stays on the device in one launch an operation.

``neg``, ``where``, ``is_zero`` and ``to_float`` are torch operations, and
a solver loop reads the host only for its condition.  ``dot``, ``nrm2``,
``nrm1`` and ``_dd_sum`` take lis_tpu's ``axis_name``: with a mesh, the
local kernel-O result is all-gathered and summed by lis_tpu's tree
(``_mesh_sum``).  A DIA operator stays DIA; a BES or multi-BES operator under
f32 limbs keeps its slabs (``DDBesOperator``, ``DDF64Operator``: one f64
accumulation through kernels Q and R, then the split into limbs, as in
lis_tpu); every other operator, and BES under f64 limbs, takes the ELL
pair.  lis_tpu gives BES its f64 accumulation under f64 limbs too, where
it is a plain f64 matvec (the low limb of its result is 0); the port does
not copy that.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lis_tpu_torch.ops import _cuda

_SPLITTER = 134217729.0          # 2^27 + 1: Dekker split of f64
_SPLITTER_F32 = 4097.0           # 2^12 + 1: Dekker split of f32 limbs
DD_DTYPES = (torch.float32, torch.float64)


class DD(NamedTuple):
    """Double-double number or array: value = hi + lo, |lo| <= ulp(hi)/2."""
    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def dtype(self):
        return self.hi.dtype

    @property
    def shape(self):
        return self.hi.shape

    @property
    def device(self):
        return self.hi.device


def dd(hi) -> DD:
    """Lift a tensor to a DD pair with a zero low limb.  f32 stays f32
    (double-float pairs); everything else is cast to f64 pairs.  A DD
    input passes through."""
    if isinstance(hi, DD):
        return hi
    hi = torch.as_tensor(hi)
    if hi.dtype != torch.float32:
        hi = hi.to(torch.float64)
    return DD(hi, torch.zeros_like(hi))


def to_float(x: DD) -> torch.Tensor:
    """Collapse to one float tensor; f32 pairs are rebuilt in f64, so the
    pair's 2^-48 survives."""
    if x.hi.dtype == torch.float32:
        return x.hi.double() + x.lo.double()
    return x.hi + x.lo


# ---- error-free transforms (the plain arithmetic of every kernel) ---------

def two_sum(a, b):
    """Knuth TWO_SUM (lis_precision.h:94)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def quick_two_sum(a, b):
    """The fast TWO_SUM for |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    """Dekker SPLIT (lis_precision.h:116)."""
    spl = _SPLITTER_F32 if a.dtype == torch.float32 else _SPLITTER
    t = spl * a
    ahi = t - (t - a)
    alo = a - ahi
    return ahi, alo


def two_prod(a, b):
    """TWO_PROD by the split (lis_precision.h:128, the variant without a
    fused multiply-add)."""
    p = a * b
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    t1 = ahi * bhi
    t2 = ahi * blo
    t3 = alo * bhi
    t4 = alo * blo
    e = ((t1 - p) + t2 + t3) + t4
    return p, e


# ---- DD elementwise operations (QUAD_ADD / QUAD_MUL / ...) -----------------

def _add(x: DD, y: DD) -> DD:
    """Accurate QUAD_ADD (lis_precision.h:186-193): two TWO_SUMs with a
    double renormalisation."""
    sh, eh = two_sum(x.hi, y.hi)
    sl, el = two_sum(x.lo, y.lo)
    eh = eh + sl
    sh, eh = quick_two_sum(sh, eh)
    eh = eh + el
    sh, eh = quick_two_sum(sh, eh)
    return DD(sh, eh)


def neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


def _mul(x: DD, y: DD) -> DD:
    """QUAD_MUL, elementwise with broadcasting (a 0-d pair times an
    array is lis_tpu's ``mul(_bcast(a, x), x)``)."""
    p, e = two_prod(x.hi, y.hi)
    e = e + x.hi * y.lo + x.lo * y.hi
    p, e = quick_two_sum(p, e)
    return DD(p, e)


def mul_d(x: DD, a) -> DD:
    """DD times a float."""
    p, e = two_prod(x.hi, a)
    e = e + x.lo * a
    p, e = quick_two_sum(p, e)
    return DD(p, e)


def _div(x: DD, y: DD) -> DD:
    """QUAD_DIV: the quotient with two Newton corrections."""
    q1 = x.hi / y.hi
    r = _sub(x, mul_d(y, q1))
    q2 = r.hi / y.hi
    r = _sub(r, mul_d(y, q2))
    q3 = r.hi / y.hi
    s, e = quick_two_sum(q1, q2)
    s, e = two_sum(s, q3 + e)
    return DD(s, e)


def _sqrt_rn(t: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root.  torch's vectorised CPU sqrt is
    not (it is off by an ulp now and then), so on the CPU numpy's is
    taken; on the card torch.sqrt is IEEE's."""
    if t.device.type == "cpu":
        return torch.as_tensor(np.sqrt(t.numpy()))
    return torch.sqrt(t)


def _sqrt(x: DD) -> DD:
    """QUAD_SQRT: one Newton step on the float square root."""
    s = _sqrt_rn(x.hi)
    zero = s == 0
    safe = torch.where(zero, torch.ones_like(s), s)
    p, e = two_prod(safe, safe)
    d = DD(x.hi - p, x.lo - e)
    corr = (d.hi + d.lo) / (2.0 * safe)
    hi, lo = quick_two_sum(safe, corr)
    return DD(torch.where(zero, torch.zeros_like(hi), hi),
              torch.where(zero, torch.zeros_like(lo), lo))


def where(c, x: DD, y: DD) -> DD:
    return DD(torch.where(c, x.hi, y.hi), torch.where(c, x.lo, y.lo))


def zeros_like(x: DD) -> DD:
    return DD(torch.zeros_like(x.hi), torch.zeros_like(x.lo))


def is_zero(a: DD):
    """DD == 0 (the reference's breakdown comparisons)."""
    return (a.hi == 0.0) & (a.lo == 0.0)


def _sub(x: DD, y: DD) -> DD:
    return _add(x, neg(y))


# ---- kernel P: dd_update (the elementwise vector updates) ------------------

_AXPY, _XPAY, _SCAL, _ADD, _SUB, _MUL, _DIV, _SQRT = range(8)
_ELEMENTWISE = {_ADD: _add, _SUB: _sub, _MUL: _mul, _DIV: _div}


def _update_plain(mode, alpha, x, y):
    """The plain version of kernel P, in lis_tpu's order of operations:
    axpy y + α·x, xpay x + α·y, scal α·x, and the elementwise x + y,
    x − y, x·y, x / y and sqrt(x)."""
    if mode == _AXPY:
        return _add(y, _mul(alpha, x))
    if mode == _XPAY:
        return _add(x, _mul(alpha, y))
    if mode == _SCAL:
        return _mul(alpha, x)
    if mode == _SQRT:
        return _sqrt(x)
    return _ELEMENTWISE[mode](x, y)


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel or plain path for {t.device}")
    return False


def _limb(t, name, dtype, numel=None):
    _cuda.check(t, name, dtype, numel, aligned=False)
    return t.data_ptr()


def dd_update(mode: int, alpha, x: DD, y) -> DD:
    """One pass of kernel P over ``x`` (and ``y``, of the same shape), with
    the 0-d DD scalar ``alpha`` read on the device (axpy, xpay, scal).  On
    vectors it is the BLAS-1 update; on 0-d pairs it is the solvers' DD
    scalar algebra, one launch where the plain version is 20-100 torch
    operations.  Bound on the H100: bytes, each limb read once and the
    result written once (axpy 6 streams)."""
    if not _on_card(x.hi):
        return _update_plain(mode, alpha, x, y)
    dt = x.hi.dtype
    if dt not in DD_DTYPES:
        raise ValueError(f"dd_update: dtype {dt} not supported")
    n = x.hi.numel()
    if y is not None and y.hi.shape != x.hi.shape:
        raise ValueError(f"dd_update: shapes {tuple(x.hi.shape)} and "
                         f"{tuple(y.hi.shape)} differ")
    ptrs = [_limb(x.hi, "x.hi", dt), _limb(x.lo, "x.lo", dt, n)]
    ptrs += ([0, 0] if y is None else
             [_limb(y.hi, "y.hi", dt, n), _limb(y.lo, "y.lo", dt, n)])
    aptr = [0, 0] if alpha is None else [_limb(alpha.hi, "alpha.hi", dt, 1),
                                          _limb(alpha.lo, "alpha.lo", dt, 1)]
    oh, ol = torch.empty_like(x.hi), torch.empty_like(x.lo)
    _cuda.launch("lis_dd_update", _cuda.DTYPE_CODE[dt], mode, *aptr, *ptrs,
                 oh.data_ptr(), ol.data_ptr(), n, _cuda.stream())
    dd_update.launches += 1
    return DD(oh, ol)


dd_update.launches = 0


def add(x: DD, y: DD) -> DD:
    return dd_update(_ADD, None, x, y)


def sub(x: DD, y: DD) -> DD:
    return dd_update(_SUB, None, x, y)


def mul(x: DD, y: DD) -> DD:
    """Elementwise QUAD_MUL of two pairs of one shape (a scalar times an
    array is ``scal``)."""
    return dd_update(_MUL, None, x, y)


def div(x: DD, y: DD) -> DD:
    return dd_update(_DIV, None, x, y)


def sqrt(x: DD) -> DD:
    return dd_update(_SQRT, None, x, None)


def axpy(alpha: DD, x: DD, y: DD) -> DD:
    """y + alpha*x (axpyex_mmm)."""
    return dd_update(_AXPY, alpha, x, y)


def xpay(x: DD, alpha: DD, y: DD) -> DD:
    """x + alpha*y."""
    return dd_update(_XPAY, alpha, x, y)


def scal(alpha: DD, x: DD) -> DD:
    """alpha*x."""
    return dd_update(_SCAL, alpha, x, None)


# ---- kernel O: dd_reduce (the halving-tree reductions) ---------------------

_SUM, _DOT, _NRM2, _NRM1 = range(4)
_RED_THREADS = 256           # threads of a block of the grid (B)
_RED_FINAL = 1024            # threads of the single block, up to 2^15 terms
_RED_BLOCKS = 128            # most blocks of the grid (G), all resident


def _pow2(n: int) -> int:
    """lis_tpu's padded length: the next power of two (1 for n <= 1)."""
    return 1 << max((n - 1).bit_length(), 0) if n > 1 else 1


def _halving_sum(hi, lo) -> DD:
    """lis_tpu's ``_dd_sum`` tree over a flat pair: pad with zeros to a
    power of two, add the halves pairwise until one element is left, then
    renormalise."""
    n = hi.shape[0]
    m = _pow2(n)
    if m != n:
        hi = torch.cat([hi, hi.new_zeros(m - n)])
        lo = torch.cat([lo, lo.new_zeros(m - n)])
    while m > 1:
        half = m // 2
        s = _add(DD(hi[:half], lo[:half]), DD(hi[half:], lo[half:]))
        hi, lo = s.hi, s.lo
        m = half
    s, e = quick_two_sum(hi[0], lo[0])
    return DD(s, e)


def _reduce_terms(mode, x: DD, y):
    if mode == _DOT:
        return _mul(x, y)
    if mode == _NRM2:
        return _mul(x, x)
    if mode == _NRM1:
        return DD(torch.abs(x.hi), torch.sign(x.hi) * x.lo)
    return x


def _reduce_plain(mode, x: DD, y=None) -> DD:
    """The plain version of kernel O: the DD terms of ``mode``, then
    ``_halving_sum`` (and the DD square root for nrm2)."""
    t = _reduce_terms(mode, x, y)
    s = _halving_sum(t.hi.reshape(-1), t.lo.reshape(-1))
    return _sqrt(s) if mode == _NRM2 else s


def _reduce_plan(n: int, resident: int = _RED_BLOCKS) -> tuple[int, int]:
    """Kernel O's schedule for n terms: (G, R), G blocks of
    ``_RED_THREADS`` threads in R groups of G / R.  (0, 0) up to 2^15
    padded terms: one block of up to ``_RED_FINAL`` threads does it all.
    Above, each thread walks at least 8 terms, with at most ``_RED_BLOCKS``
    blocks, and at most the power of two at or below ``resident``, the
    blocks the card holds at once (a cooperative launch); with fewer than
    4 the one block.  The groups' size and count are near the square root
    of G, so that the group trees (G / R partials a position) and the final
    tree (R a position) take about as long.  Every plan sums in the same
    order."""
    m = _pow2(n)
    cap = min(_RED_BLOCKS, resident)
    if m <= _RED_FINAL * 32 or cap < 4:
        return 0, 0
    G = min(1 << (cap.bit_length() - 1), m // (8 * _RED_THREADS))
    g = 1 << ((G.bit_length() - 1) // 2)
    return G, G // g


def _reduce_launch(mode, x: DD, y, plan) -> DD:
    """One call of kernel O with the schedule ``plan`` = (G, R), into one
    allocation: the result (hi, lo), then with G > 0 the block and group
    partials."""
    dt = x.hi.dtype
    if dt not in DD_DTYPES:
        raise ValueError(f"dd_reduce: dtype {dt} not supported")
    n = x.hi.numel()
    ptrs = [_limb(x.hi, "x.hi", dt), _limb(x.lo, "x.lo", dt, n)]
    ptrs += ([0, 0] if y is None else
             [_limb(y.hi, "y.hi", dt, n), _limb(y.lo, "y.lo", dt, n)])
    G, R = plan
    scratch = torch.empty(2 + 2 * (G + R) * _RED_THREADS if G else 2,
                          dtype=dt, device=x.hi.device)
    _cuda.launch("lis_dd_reduce", _cuda.DTYPE_CODE[dt], mode, *ptrs, n,
                 _pow2(n), G, R, scratch.data_ptr(), _cuda.stream())
    dd_reduce.launches += 1
    return DD(scratch[0], scratch[1])


def dd_reduce(mode: int, x: DD, y=None) -> DD:
    """Kernel O: sum (``_dd_sum``), dot, nrm2 or nrm1 of DD arrays into a
    0-d DD pair on the device, lis_tpu's halving tree reproduced bit for
    bit (csrc/dd.cu says how).  Bound on the H100: bytes, each limb read
    once.  One launch a call (``_reduce_plan``'s schedule), and one
    allocation: the result and the kernel's scratch."""
    if not _on_card(x.hi):
        return _reduce_plain(mode, x, y)
    return _reduce_launch(mode, x, y, _reduce_plan(x.hi.numel()))


dd_reduce.launches = 0


def _mesh_sum(s: DD, mesh) -> DD:
    """The ranks' 0-d DD partials summed as lis_tpu's ``_dd_sum`` does
    under a mesh axis (the reference's lis_mpi_msum reduction op): one
    all-gather of every rank's (hi, lo), zero-padded to a power of two,
    then the halving tree of ``_add`` in rank order and the final
    renormalisation.  The local partial arrives renormalised by kernel O,
    which lis_tpu's local tree leaves to the end."""
    both = mesh.all_gather(torch.stack([s.hi, s.lo])).view(-1, 2)
    return _halving_sum(both[:, 0].contiguous(), both[:, 1].contiguous())


def _dd_sum(x: DD, axis_name=None) -> DD:
    """Reduction of a DD array to a DD scalar by the pairwise two-sum tree
    (lis_tpu's ``_dd_sum``), over the mesh ``axis_name`` when given."""
    s = dd_reduce(_SUM, x)
    return s if axis_name is None else _mesh_sum(s, axis_name)


def dot(x: DD, y: DD, axis_name=None) -> DD:
    """dotex_mmm: elementwise DD products, then the compensated sum."""
    s = dd_reduce(_DOT, x, y)
    return s if axis_name is None else _mesh_sum(s, axis_name)


def nrm2(x: DD, axis_name=None) -> DD:
    if axis_name is None:
        return dd_reduce(_NRM2, x)
    return _sqrt(_mesh_sum(dd_reduce(_DOT, x, x), axis_name))


def nrm1(x: DD, axis_name=None) -> DD:
    s = dd_reduce(_NRM1, x)
    return s if axis_name is None else _mesh_sum(s, axis_name)


# ---- kernels M and N: the DD matvecs ----------------------------------------

def _shifted(v, off: int, n: int):
    """out[i] = v[i + off] for 0 <= i + off < len(v), else 0 (lis_tpu's
    slice of a zero-padded copy)."""
    out = v.new_zeros(n)
    lo, hi = max(0, -off), min(n, v.shape[0] - off)
    if hi > lo:
        out[lo:hi] = v[lo + off:hi + off]
    return out


def _dia_plain(value, offsets, x: DD, value_lo, trans: bool) -> DD:
    """The plain version of kernel M (lis_tpu's ``DDDiaOperator._mv``):
    per diagonal in the order of ``offsets``, TWO_PROD of the value and
    the shifted x.hi, plus v·x.lo (and v_lo·x.hi with f32 limbs), added
    to the row's DD sum.  ``trans`` is matvech: each offset negated and
    its value stream shifted by the offset, with zero fill."""
    n = value.shape[1]
    acc = DD(x.hi.new_zeros(n), x.hi.new_zeros(n))
    for k, off in enumerate(offsets):
        v = value[k] if not trans else _shifted(value[k], -off, n)
        vlo = None if value_lo is None else (
            value_lo[k] if not trans else _shifted(value_lo[k], -off, n))
        o = -off if trans else off
        sh, sl = _shifted(x.hi, o, n), _shifted(x.lo, o, n)
        ph, pe = two_prod(v, sh)
        pe = pe + v * sl
        if vlo is not None:
            pe = pe + vlo * sh
        acc = _add(acc, DD(ph, pe))
    return acc


def dd_dia_spmv(A: "DDDiaOperator", x: DD, trans: bool = False) -> DD:
    """Kernel M: y = A·x (``trans``: Aᵀ·x) in DD over the port's (nnd, n)
    diagonals, read as they are: no shifted copies of the values, no
    padded copy of x.  Bound on the H100: bytes, the diagonals (and their
    f32 second limbs) read once plus x and y."""
    if trans and A.nrows != A.ncols:
        raise ValueError("dd_dia_spmv: the transpose needs a square A")
    if x.hi.shape[0] != (A.nrows if trans else A.ncols):
        raise ValueError(f"dd_dia_spmv: x has {x.hi.shape[0]} entries")
    if not _on_card(x.hi):
        return _dia_plain(A.value, A.offsets, x, A.value_lo, trans)
    dt = x.hi.dtype
    if A.value.dtype != dt:
        raise ValueError(f"dd_dia_spmv: values {A.value.dtype}, x {dt}")
    nnd, n = A.value.shape
    if nnd > _MAX_NND:
        raise ValueError(f"dd_dia_spmv: {nnd} diagonals, at most {_MAX_NND}")
    vlo = 0 if A.value_lo is None else _limb(A.value_lo, "value_lo", dt,
                                             nnd * n)
    yh = torch.empty(n, dtype=dt, device=x.hi.device)
    yl = torch.empty_like(yh)
    _cuda.launch("lis_dd_dia_spmv", _cuda.DTYPE_CODE[dt], int(trans),
                 _limb(A.value, "value", dt, nnd * n), vlo,
                 _limb(A.off, "off", torch.int64, nnd),
                 _limb(x.hi, "x.hi", dt), _limb(x.lo, "x.lo", dt),
                 yh.data_ptr(), yl.data_ptr(), n, A.ncols, nnd,
                 _cuda.stream())
    dd_dia_spmv.launches += 1
    return DD(yh, yl)


dd_dia_spmv.launches = 0
_MAX_NND = 512               # csrc/dd.cu keeps the offsets in shared memory
# kernel N: rows up to _ELL_STAGE_W entries are staged, _ELL_ROWS at most a
# block, in about _ELL_STAGE_BYTES of shared memory (the staged kernel takes
# rows up to 128 entries; past 64 a warp a row measured faster on the H100,
# PERF.md); a warp a row keeps its row's terms in shared memory, 227 KB at
# most
_ELL_STAGE_W = 64
_ELL_ROWS = 256
_ELL_STAGE_BYTES = 72 * 1024
MAX_ELL_WIDTH = {torch.float32: 232448 // 8 - 1,
                 torch.float64: 232448 // 16 - 1}


def _ell_rows(w: int, es: int) -> int:
    """Rows a block of kernel N's staged form for rows of ``w`` entries
    with limbs of ``es`` bytes: as many as fit their ceil(w/2) staged
    terms, at a stride of ceil(w/2) | 1 values, in ``_ELL_STAGE_BYTES``,
    at most ``_ELL_ROWS``."""
    stride = ((w + 1) // 2) | 1
    return min(_ELL_ROWS, _ELL_STAGE_BYTES // (2 * stride * es))


def _ell_plan(w: int, es: int) -> int:
    """Kernel N's rows a block: ``_ell_rows`` up to ``_ELL_STAGE_W``
    entries, else 0 (a warp a row)."""
    return _ell_rows(w, es) if w <= _ELL_STAGE_W else 0


def _row_reduce(p, e) -> DD:
    """(n, m) DD entries -> (n,) row sums by lis_tpu's pairwise two-sum
    tree along the row (``_dd_row_reduce``), an odd width padded with one
    zero column at each level."""
    m = p.shape[1]
    while m > 1:
        if m % 2:
            p = torch.cat([p, p.new_zeros(p.shape[0], 1)], dim=1)
            e = torch.cat([e, e.new_zeros(e.shape[0], 1)], dim=1)
            m += 1
        half = m // 2
        s = _add(DD(p[:, :half], e[:, :half]), DD(p[:, half:], e[:, half:]))
        p, e = s.hi, s.lo
        m = half
    return DD(p[:, 0], e[:, 0])


def _ell_plain(index, value, x: DD, value_lo) -> DD:
    """The plain version of kernel N (lis_tpu's ``matvec_dd_ell``): gather
    both limbs, TWO_PROD per entry, then ``_row_reduce``."""
    idx = index.long()
    xh, xl = x.hi[idx], x.lo[idx]
    p, e = two_prod(value, xh)
    e = e + value * xl
    if value_lo is not None:
        e = e + value_lo * xh
    return _row_reduce(p, e)


def _ell_launch(index, value, x: DD, value_lo, rows: int) -> DD:
    """One call of kernel N with ``rows`` rows a block (0: a warp a
    row)."""
    dt = x.hi.dtype
    n, w = value.shape
    if not 1 <= w <= MAX_ELL_WIDTH[dt]:
        raise ValueError(f"dd_ell_spmv: rows of {w} entries (1 to "
                         f"{MAX_ELL_WIDTH[dt]} at {dt})")
    vlo = 0 if value_lo is None else _limb(value_lo, "value_lo", dt, n * w)
    nx = x.hi.numel()
    xpack = torch.empty(2 * nx, dtype=dt, device=x.hi.device)
    yh = torch.empty(n, dtype=dt, device=x.hi.device)
    yl = torch.empty_like(yh)
    _cuda.launch("lis_dd_ell_spmv", _cuda.DTYPE_CODE[dt],
                 _limb(index, "index", torch.int32, n * w),
                 _limb(value, "value", dt, n * w), vlo,
                 _limb(x.hi, "x.hi", dt), _limb(x.lo, "x.lo", dt, nx),
                 xpack.data_ptr(), yh.data_ptr(), yl.data_ptr(), n, nx, w,
                 rows, _cuda.stream())
    dd_ell_spmv.launches += 1
    return DD(yh, yl)


def dd_ell_spmv(index, value, x: DD, value_lo=None) -> DD:
    """Kernel N: y = A·x in DD for ELL arrays (n, w) (rows padded at the
    end with index 0 and value 0), lis_tpu's row tree reproduced bit for
    bit: a block stages the first level of consecutive rows in shared
    memory from coalesced loads, then a thread a row adds the rest
    (``_ell_plan``; rows past 64 entries: a warp a row).  A first small
    launch lays x's limbs side by side, so one gather brings both.  Bound
    on the H100: bytes, the index and value arrays read once (x's gathers
    from the caches) plus y."""
    if not _on_card(x.hi):
        return _ell_plain(index, value, x, value_lo)
    return _ell_launch(index, value, x, value_lo,
                       _ell_plan(value.shape[1], x.hi.element_size()))


dd_ell_spmv.launches = 0


def _split_limbs(value, limb):
    """f64 values -> (hi, lo) limbs of type ``limb``, so the operator
    keeps its full precision (a system cast to f32 is perturbed by about
    1e-7 relative)."""
    if limb is None or value.dtype == limb:
        return value, None
    vhi = value.to(limb)
    vlo = (value - vhi.to(value.dtype)).to(limb)
    return vhi, vlo


def _ell_arrays(ptr, idx, val, n):
    """lis_tpu's ELL layout of CSR arrays (``ELLMatrix.from_csr_arrays``):
    (n, maxnzr) index and value, rows padded at the end with index 0 and
    value 0."""
    lens = np.diff(ptr)
    w = int(lens.max()) if n else 0
    eidx = np.zeros((n, w), dtype=np.int32)
    eval_ = np.zeros((n, w), dtype=val.dtype)
    rows = np.repeat(np.arange(n), lens)
    pos = np.arange(len(idx)) - np.repeat(ptr[:-1], lens)
    eidx[rows, pos] = idx
    eval_[rows, pos] = val
    return eidx, eval_


class DDOperator:
    """A matrix as the ELL pair for DD matvec and matvech: ELL arrays of A
    and of Aᵀ (the transpose from the CSR transpose), in f64 or as f32
    limb pairs (``limb=torch.float32``)."""

    def __init__(self, index, value, index_t, value_t, nrows, ncols,
                 value_lo=None, value_t_lo=None):
        self.index, self.value = index, value
        self.index_t, self.value_t = index_t, value_t
        self.value_lo, self.value_t_lo = value_lo, value_t_lo
        self.nrows, self.ncols = nrows, ncols

    @property
    def device(self):
        return self.value.device

    def matvec(self, x: DD) -> DD:
        return dd_ell_spmv(self.index, self.value, x, self.value_lo)

    def matvech(self, x: DD) -> DD:
        return dd_ell_spmv(self.index_t, self.value_t, x, self.value_t_lo)

    @classmethod
    def from_matrix(cls, A, limb=None) -> "DDOperator":
        import scipy.sparse as sp
        ptr, idx, val = A.to_csr_arrays()
        ptr, idx, val = np.asarray(ptr), np.asarray(idx), np.asarray(val)
        n, m = A.shape
        at = sp.csr_matrix((val, idx, ptr), shape=(n, m)).T.tocsr()
        at.sort_indices()
        dev = A.device

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        ei, ev = _ell_arrays(ptr, idx, val, n)
        eti, etv = _ell_arrays(at.indptr, at.indices, at.data, m)
        v, vlo = _split_limbs(put(ev), limb)
        vt, vtlo = _split_limbs(put(etv), limb)
        return cls(put(ei), v, put(eti), vt, n, m, vlo, vtlo)


class DDDiaOperator:
    """A DIA (stencil) operator for DD matvec and matvech: the port's
    (nnd, n) diagonals as they are (f64, or f32 limb pairs), no gather."""

    def __init__(self, value, off, offsets, nrows, ncols, value_lo=None):
        self.value = value            # (nnd, n)
        self.off = off                # (nnd,) int64 on the device
        self.offsets = offsets        # host tuple of ints
        self.nrows, self.ncols = nrows, ncols
        self.value_lo = value_lo      # (nnd, n) second limbs or None

    @property
    def device(self):
        return self.value.device

    def matvec(self, x: DD) -> DD:
        return dd_dia_spmv(self, x)

    def matvech(self, x: DD) -> DD:
        return dd_dia_spmv(self, x, trans=True)

    @classmethod
    def from_matrix(cls, A, limb=None) -> "DDDiaOperator":
        v, vlo = _split_limbs(A.value, limb)
        return cls(v.contiguous(), A.off, tuple(A.offsets), A.nrows, A.ncols,
                   None if vlo is None else vlo.contiguous())


class DDF64Operator:
    """A format's own matvec at f64 for f32 limbs (lis_tpu ``DDBesOperator``
    and ``DDF64Operator``, ddreal.py:426-526): x is formed as hi + lo in
    f64, the product accumulates in f64 (unit roundoff 2^-53, tighter than
    the f32 pair's 2^-48) and the result is split back into f32 limbs.
    For BES and multi-BES this keeps the slab path (kernels Q and R at
    f64); only f32 limbs may take it."""

    def __init__(self, A64):
        self.A64 = A64              # the operator with f64 values

    @property
    def nrows(self):
        return self.A64.nrows

    @property
    def ncols(self):
        return self.A64.ncols

    @property
    def device(self):
        return self.A64.device

    def _mv(self, x: DD, transpose: bool) -> DD:
        f64 = torch.float64
        xs = x.hi.to(f64) + x.lo.to(f64)
        y = self.A64.matvech(xs) if transpose else self.A64.matvec(xs)
        h = y.to(x.hi.dtype)
        return DD(h, (y - h.to(f64)).to(x.hi.dtype))

    def matvec(self, x: DD) -> DD:
        return self._mv(x, False)

    def matvech(self, x: DD) -> DD:
        return self._mv(x, True)

    @classmethod
    def from_matrix(cls, A, limb=None) -> "DDF64Operator":
        if limb != torch.float32:
            raise ValueError("DDF64Operator: f64 accumulation serves f32 "
                             "limbs only; f64 limbs take the ELL pair")
        return cls(A.to(dtype=torch.float64))


def make_dd_operator(A, limb=None):
    """Wrap a matrix for DD iterations: DIA stays DIA (kernel M); BES and
    multi-BES under f32 limbs keep their slabs at f64 (kernels Q and R);
    every other case takes the ELL gather pair (kernel N).  With
    ``limb=torch.float32`` the values are carried as f32 pairs."""
    fmt = getattr(A, "format_name", None)
    if fmt == "dia":
        return DDDiaOperator.from_matrix(A, limb)
    if fmt in ("bes", "mbes") and limb == torch.float32:
        return DDF64Operator.from_matrix(A, limb)
    return DDOperator.from_matrix(A, limb)
