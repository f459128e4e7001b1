"""SA-AMG's coarse-grid transfers on a lattice: kernels J and L.

Port of the streamed prolongator of ``lis_tpu/precon/saamg.py``
(``LatticeTent``, :298-327, and ``ImplicitP``, :330-352).  On a lattice
of dims f (slowest to fastest) the aggregates are boxes of 3 points per
dimension (cropped at the far edges), c = ceil(f/3) of them per dimension.
The tentative prolongator Pt broadcasts a coarse value over its box,
scaled by wc = 1/sqrt(|box|), and the smoothed prolongator
P = (I − ω·D⁻¹A)·Pt (ω = 2/3) is applied without being formed:

- J ``lattice_prolong``: x + P·ec = x + (z − (ω·dinv)·(A·z)), z = Pt·ec;
- L ``lattice_restrict``: Pᵀ·r = wc ⊙ boxsum(r − ω·Aᵀ(dinv ⊙ r)).

lis_tpu leaves both to XLA fusion (broadcast and crop, a DIA product,
pad and box sum).  In PyTorch that is about nine launches and three
fine-level temporaries each, so each is one hand-written launch here
(``csrc/amg.cu``), on a square DIA operator A.  On a CPU tensor each takes
its plain version below, lis_tpu's formulas in torch, which is also the
oracle on the card.  Both kernels round every product and sum on its own,
in the plain version's order, so on real data they equal it bit for bit.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from lis_tpu_torch.matrix.base import TensorFields, static
from lis_tpu_torch.matrix.dia import (MAX_NND, _REAL_OF, _spmv_plain,
                                      _spmvh_plain)
from lis_tpu_torch.ops import _cuda

OMEGA = 2.0 / 3.0             # the prolongator's Jacobi smoothing weight


@dataclasses.dataclass(frozen=True, eq=False)
class LatticeTent(TensorFields):
    """The tentative prolongator of a 3x-per-dimension box decimation:
    Pt[i, c] = wc[c] when box(i) == c (lis_tpu ``LatticeTent``)."""
    wc: torch.Tensor          # (nc,) 1/sqrt(|box|)
    fdims: tuple = static()   # fine dims, slowest..fastest
    cdims: tuple = static()   # coarse dims

    @property
    def n(self) -> int:
        return int(np.prod(self.fdims))

    def matvec(self, ec):
        """Pt·ec: the broadcast, in lis_tpu's order (ec·wc, then repeat and
        crop)."""
        z = (ec * self.wc.to(ec.dtype)).reshape(self.cdims)
        for ax in range(len(self.cdims)):
            z = torch.repeat_interleave(z, 3, dim=ax)
        return z[tuple(slice(0, f) for f in self.fdims)].reshape(-1)

    def matvech(self, r):
        """Ptᵀ·r: each box's sum in lexicographic order within the box (the
        order kernel L sums in), times wc."""
        pad = []
        for f, c in reversed(list(zip(self.fdims, self.cdims))):
            pad += [0, 3 * c - f]
        rp = torch.nn.functional.pad(r.reshape(self.fdims), pad)
        shape = []
        for c in self.cdims:
            shape += [c, 3]
        rp = rp.reshape(shape)
        acc = None
        for digits in itertools.product(range(3), repeat=len(self.cdims)):
            term = rp[tuple(x for d in digits for x in (slice(None), d))]
            acc = term if acc is None else acc + term
        return acc.reshape(-1) * self.wc.to(r.dtype)


def _prolong_plain(A, dinv, tent: LatticeTent, ec, x):
    """x + P·ec in plain torch, lis_tpu's order of operations
    (``x + ImplicitP.matvec(ec)``, saamg.py:102, :341-343)."""
    z = tent.matvec(ec)
    Az = _spmv_plain(A.value, A.offsets, z, A.ncols)
    return x + (z - (OMEGA * dinv.to(z.dtype)) * Az)


def _restrict_plain(A, dinv, tent: LatticeTent, r):
    """Pᵀ·r in plain torch, lis_tpu's ``ImplicitP.matvech`` (:345-347):
    z = r − ω·Aᵀ(dinv ⊙ r), then the tent's box sums times wc."""
    z = r - OMEGA * _spmvh_plain(A.value, A.offsets, dinv.to(r.dtype) * r,
                                 A.ncols)
    return tent.matvech(z)


def _dims3(dims) -> tuple:
    """A lattice's dims as three, with leading 1s."""
    return (1,) * (3 - len(dims)) + tuple(int(d) for d in dims)


def _check_level(name, A, dinv, tent, vecs):
    """Shapes and types the kernels take; returns the vectors' dtype and
    the real type of the level's tensors."""
    n = A.nrows
    if A.ncols != n or tent.n != n:
        raise ValueError(f"{name}: a square operator on the lattice "
                         f"{tent.fdims} ({tent.n} points), got {A.shape}")
    if len(tent.fdims) > 3 or n >= 2 ** 31:
        raise ValueError(f"{name}: lattices of at most 3 dims and 2^31 "
                         f"points")
    if A.value.shape[0] > MAX_NND:
        raise ValueError(f"{name}: {A.value.shape[0]} diagonals, at most "
                         f"{MAX_NND}")
    vt = A.value.dtype
    if vt not in (torch.float32, torch.float64) or dinv.dtype != vt \
            or tent.wc.dtype != vt:
        raise ValueError(f"{name}: the level's diagonals, dinv and wc must "
                         f"share one real type")
    dt = vecs[0].dtype
    if _REAL_OF.get(dt, dt) != vt or any(v.dtype != dt for v in vecs):
        raise ValueError(f"{name}: vectors of {dt} with a {vt} level")
    return dt, vt


def _ops(*ts):
    for t in ts:
        if t.is_conj():
            t = t.resolve_conj()
        yield t.contiguous()


def lattice_prolong(A, dinv, tent: LatticeTent, ec, x):
    """``x + P·ec`` with P = (I − ω·D⁻¹A)·Pt, Pt the tent ``tent`` and
    ``A`` the level's square DIA operator (``dinv`` = 1/diag(A)).

    Kernel J (``csrc/amg.cu``): one thread per fine row forms z = wc·ec of
    its neighbours' boxes on the fly, so no fine temporary is stored.
    lis_tpu leaves this to XLA (precon/saamg.py:102, :341-343).  Bound on
    the H100: bytes, A's diagonals, dinv, x and the result once each."""
    if ec.shape != tent.wc.shape or x.shape != (A.nrows,):
        raise ValueError(f"lattice_prolong: ec {tuple(ec.shape)} and x "
                         f"{tuple(x.shape)} for {tent.wc.shape[0]} coarse "
                         f"and {A.nrows} fine points")
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"no kernel or plain path for {x.device}")
        return _prolong_plain(A, dinv, tent, ec, x)
    dt, vt = _check_level("lattice_prolong", A, dinv, tent, (ec, x))
    ec, x = _ops(ec, x)
    val, off = A.value.contiguous(), A.off
    for name, t in (("value", val), ("off", off), ("dinv", dinv),
                    ("wc", tent.wc), ("ec", ec), ("x", x)):
        _cuda.check(t, name, aligned=False)
    out = torch.empty_like(x)
    f0, f1, f2 = _dims3(tent.fdims)
    _, c1, c2 = _dims3(tent.cdims)
    _cuda.launch("lis_lattice_prolong", _cuda.DTYPE_CODE[vt],
                 _cuda.DTYPE_CODE[dt], val.data_ptr(), off.data_ptr(),
                 dinv.data_ptr(), tent.wc.data_ptr(),
                 ec.data_ptr(), x.data_ptr(), out.data_ptr(), A.nrows,
                 val.shape[0], f0, f1, f2, c1, c2, OMEGA, _cuda.stream())
    lattice_prolong.launches += 1
    return out


lattice_prolong.launches = 0


def lattice_restrict(A, dinv, tent: LatticeTent, r):
    """``Pᵀ·r = wc ⊙ boxsum(r − ω·Aᵀ(dinv ⊙ r))`` on the level's square DIA
    operator ``A``.

    Kernel L (``csrc/amg.cu``): a block takes a tile of coarse points
    along the fastest dimension, forms z for the fine rows of their boxes
    (kernel F's term order, coalesced along the fastest dimension) into
    shared memory, and one thread per coarse point sums its box in
    lexicographic order.  lis_tpu leaves this to XLA (saamg.py:312-323,
    :345-347).  Bound on the H100: bytes, A's diagonals, dinv and r once
    each and the coarse result."""
    if r.shape != (A.nrows,):
        raise ValueError(f"lattice_restrict: r {tuple(r.shape)} for "
                         f"{A.nrows} fine points")
    if not r.is_cuda:
        if r.device.type != "cpu":
            raise ValueError(f"no kernel or plain path for {r.device}")
        return _restrict_plain(A, dinv, tent, r)
    dt, vt = _check_level("lattice_restrict", A, dinv, tent, (r,))
    (r,) = _ops(r)
    val, off = A.value.contiguous(), A.off
    for name, t in (("value", val), ("off", off), ("dinv", dinv),
                    ("wc", tent.wc), ("r", r)):
        _cuda.check(t, name, aligned=False)
    out = torch.empty(tent.wc.shape[0], dtype=dt, device=r.device)
    f0, f1, f2 = _dims3(tent.fdims)
    c0, c1, c2 = _dims3(tent.cdims)
    _cuda.launch("lis_lattice_restrict", _cuda.DTYPE_CODE[vt],
                 _cuda.DTYPE_CODE[dt], val.data_ptr(), off.data_ptr(),
                 dinv.data_ptr(), tent.wc.data_ptr(), r.data_ptr(),
                 out.data_ptr(), A.nrows, val.shape[0], f0, f1, f2, c0, c1,
                 c2, OMEGA, _cuda.stream())
    lattice_restrict.launches += 1
    return out


lattice_restrict.launches = 0
