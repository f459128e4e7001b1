"""The fused double-double CG step of ``cg_quad`` (kernels S,
``csrc/dd_cg.cu``).

lis_tpu compiles its ``cg_quad`` step (``lis_tpu/solvers/quad.py:65``),
jnp code, into one XLA while-loop and fuses it there; no Pallas kernel
computes it.  In PyTorch the same step is about 38 launches an iteration:
kernels O and P, the limb-wise Jacobi, and torch operations for the
breakdown's merges and the DD scalar algebra.  Here the step is three
passes around the operator's DD matvec, with every loop scalar in the
device blocks of a ``DDCGScalars``:

- ``ddcg_direction`` (S1): p ← z + β·p in place, z = (dinv·r.hi,
  dinv·r.lo) for a Jacobi preconditioner folded in, or r for none;
- ``ddcg_pq`` (S2): p·q by kernel O's tree, then on the card broke =
  (p·q == 0) and α = ρ / (broke ? 1 : p·q);
- ``ddcg_update`` (S3): r' = r + (−α)·q and, unless broke,
  x ← x + α·p and r ← r' in place; the norm of r' and the next ρ = r'·z'
  by O's tree in the same pass; then nrm, rh[it], the flag, it + 1, the
  next β and live.

Each does nothing once ``live`` is 0.  The operations, their order and
the trees are those of ``solvers/quad.py::cg_quad_plain``, so the step
equals it bit for bit.  On a CUDA tensor each wrapper launches its kernel;
on a CPU tensor it takes the plain torch version beside it, which runs the
plain step's own functions (``ddreal._update_plain``, ``_reduce_plain``).
"""

from __future__ import annotations

import ctypes

import torch

from lis_tpu_torch.core import ddreal as q
from lis_tpu_torch.core.ddreal import DD
from lis_tpu_torch.core.vector import _ptr
from lis_tpu_torch.ops import _cuda

# slots of DDCGScalars.dd ((hi, lo) pairs), .f and .ic: csrc/dd_cg.cu's layout
_RHO, _RHO_OLD, _ALPHA, _BETA, _PQ = 0, 2, 4, 6, 8
_NRM, _TOL, _BNRM_INV = range(3)
_IT, _FLAG, _LIVE, _MAXITER, _RUNNING, _BREAKDOWN, _BROKE = range(7)


_RESIDENT: dict = {}


def resident_blocks(dtype, device) -> int:
    """The blocks of S2's and S3's grid kernels the card ``device`` holds
    at once (its SMs times the fewer of the two kernels' blocks an SM),
    queried once a card and limb type: their cooperative grid's cap."""
    idx = torch.device(device).index
    key = (dtype, torch.cuda.current_device() if idx is None else idx)
    if key not in _RESIDENT:
        out = ctypes.c_int64(0)
        with torch.cuda.device(key[1]):
            _cuda.launch("lis_ddcg_resident", _cuda.DTYPE_CODE[dtype],
                         ctypes.addressof(out))
        _RESIDENT[key] = out.value
    return _RESIDENT[key]


class DDCGScalars:
    """The loop scalars of the fused DD CG step, resident on the device.

    ``dd`` holds rho, rho_old, alpha, beta and p·q as (hi, lo) pairs of
    the limb type; ``f`` (f64) nrm, tol and bnrm_inv; ``ic`` (int64) it,
    flag, live, maxiter, the two flag values the kernels write or compare
    (running, breakdown) and broke; ``part`` the block and group partials
    of kernel O's grid tree (two trees side by side in S3), for
    ``plan`` = ``ddreal._reduce_plan(n, resident)``, ``resident`` the
    blocks the card holds at once (``resident_blocks`` by default).
    ``it``, ``flag``, ``nrm`` and
    ``live`` are 0-d views for the solver loop.  The first step's rho is
    given; rho_old starts at 1 and beta at rho / 1, as in the plain step."""

    def __init__(self, r: DD, maxiter: int, tol, bnrm_inv, nrm0, rho: DD,
                 nrm1: bool, running: int, breakdown: int,
                 resident: int | None = None):
        dt, dev = r.dtype, r.device
        self.n = r.hi.numel()
        self.nrm1 = bool(nrm1)
        one = q.dd(torch.ones((), dtype=dt, device=dev))
        beta = q.div(rho, one)
        zero = torch.zeros(2, dtype=dt, device=dev)
        self.dd = torch.cat([torch.stack(rho), torch.stack(one), zero,
                             torch.stack(beta), zero])
        f64 = dict(dtype=torch.float64, device=dev)
        self.f = torch.stack([torch.as_tensor(v, **f64).reshape(())
                              for v in (nrm0, tol, bnrm_inv)])
        self.ic = torch.tensor([1, running, 0, maxiter, running, breakdown,
                                0], dtype=torch.int64, device=dev)
        self.ic[_LIVE] = (self.f[_NRM] > self.f[_TOL]) & (maxiter >= 1)
        if resident is None:
            resident = (resident_blocks(dt, dev) if q._on_card(r.hi)
                        else q._RED_BLOCKS)
        self.plan = q._reduce_plan(self.n, resident)
        G, R = self.plan
        self.part = torch.empty(max(1, 4 * (G + R) * q._RED_THREADS),
                                dtype=dt, device=dev)
        self.it, self.flag = self.ic[_IT], self.ic[_FLAG]
        self.live, self.nrm = self.ic[_LIVE], self.f[_NRM]
        # what every launch passes, looked up once
        self._code = _cuda.DTYPE_CODE[dt]
        self._ptr = [t.data_ptr() for t in (self.dd, self.f, self.ic,
                                            self.part)]

    def pair(self, k: int) -> DD:
        """Slot ``k`` of ``dd`` as a 0-d pair of views."""
        return DD(self.dd[k], self.dd[k + 1])

    def _put(self, k: int, v: DD) -> None:
        self.dd[k:k + 2] = torch.stack([v.hi.reshape(()), v.lo.reshape(())])

    def _check(self, *limbs):
        for t in limbs:
            if t is not None:
                _cuda.check(t, "vector", self.dd.dtype, self.n, aligned=False)

    def _is_live(self) -> bool:
        return bool(self.ic[_LIVE])


def z_limbs(r: DD, dinv) -> DD:
    """The preconditioned residual the plain step forms limb by limb:
    Jacobi's ``dinv * r`` on each limb, or r itself."""
    return r if dinv is None else DD(dinv * r.hi, dinv * r.lo)


def _copy(dst: DD, src: DD) -> None:
    dst.hi.copy_(src.hi)
    dst.lo.copy_(src.lo)


# ---- S1: the direction ------------------------------------------------------

def _direction_plain(p: DD, r: DD, dinv, ws: DDCGScalars) -> None:
    if ws._is_live():
        _copy(p, q._update_plain(q._XPAY, ws.pair(_BETA), z_limbs(r, dinv),
                                 p))


def ddcg_direction(p: DD, r: DD, dinv, ws: DDCGScalars) -> None:
    """``p ← z + beta·p`` in place (the plain step's ``xpay``), z =
    (dinv·r.hi, dinv·r.lo) or r with ``dinv`` None.  Kernel S1; bound:
    bytes, r, dinv and p read and p written once (7 limb streams)."""
    if not q._on_card(p.hi):
        return _direction_plain(p, r, dinv, ws)
    ws._check(p.hi, p.lo, r.hi, r.lo, dinv)
    _cuda.launch("lis_ddcg_direction", ws._code, p.hi.data_ptr(),
                 p.lo.data_ptr(), r.hi.data_ptr(), r.lo.data_ptr(),
                 _ptr(dinv), ws.n, ws._ptr[0], ws._ptr[2], _cuda.stream())
    ddcg_direction.launches += 1


ddcg_direction.launches = 0


# ---- S2: p·q and alpha ------------------------------------------------------

def _pq_plain(p: DD, qv: DD, ws: DDCGScalars) -> None:
    if not ws._is_live():
        return
    pq = q._reduce_plain(q._DOT, p, qv)
    broke = q.is_zero(pq)
    one = DD(torch.ones_like(pq.hi), torch.zeros_like(pq.lo))
    ws._put(_PQ, pq)
    ws._put(_ALPHA, q._div(ws.pair(_RHO), q.where(broke, one, pq)))
    ws.ic[_BROKE] = broke


def ddcg_pq(p: DD, qv: DD, ws: DDCGScalars) -> None:
    """pq = p·q by kernel O's tree; broke = (pq == 0); ``alpha = rho /
    (broke ? 1 : pq)``, all on the card.  Kernel S2 (O's dot with this
    finish); bound: bytes, p and q read once."""
    if not q._on_card(p.hi):
        return _pq_plain(p, qv, ws)
    ws._check(p.hi, p.lo, qv.hi, qv.lo)
    G, R = ws.plan
    _cuda.launch("lis_ddcg_pq", ws._code, p.hi.data_ptr(), p.lo.data_ptr(),
                 qv.hi.data_ptr(), qv.lo.data_ptr(), ws.n, q._pow2(ws.n), G,
                 R, ws._ptr[3], ws._ptr[0], ws._ptr[2], _cuda.stream())
    ddcg_pq.launches += 1


ddcg_pq.launches = 0


# ---- S3: the update, the norm and the next rho ------------------------------

def _update_plain(x: DD, r: DD, p: DD, qv: DD, dinv, ws: DDCGScalars,
                  rh: torch.Tensor) -> None:
    if not ws._is_live():
        return
    alpha = ws.pair(_ALPHA)
    xn = q._update_plain(q._AXPY, alpha, p, x)
    rn = q._update_plain(q._AXPY, q.neg(alpha), qv, r)
    if ws.nrm1:
        nrm = q.to_float(q._reduce_plain(q._NRM1, rn))
    else:
        nrm = q.to_float(q._reduce_plain(q._NRM2, rn)) * ws.f[_BNRM_INV]
    rho = q._reduce_plain(q._DOT, rn, z_limbs(rn, dinv))
    it = int(ws.ic[_IT])
    rh[it] = nrm
    if bool(ws.ic[_BROKE]):
        ws.ic[_FLAG] = ws.ic[_BREAKDOWN]
    else:
        _copy(x, xn)
        _copy(r, rn)
        ws.f[_NRM] = nrm
        ws._put(_RHO_OLD, ws.pair(_RHO))
    ws._put(_RHO, rho)
    ws._put(_BETA, q._div(rho, ws.pair(_RHO_OLD)))
    ws.ic[_IT] = it + 1
    ws.ic[_LIVE] = int(it + 1 <= int(ws.ic[_MAXITER])
                       and bool(ws.f[_NRM] > ws.f[_TOL])
                       and int(ws.ic[_FLAG]) == int(ws.ic[_RUNNING]))


def ddcg_update(x: DD, r: DD, p: DD, qv: DD, dinv, ws: DDCGScalars,
                rh: torch.Tensor) -> None:
    """``r' = r + (−alpha)·q``; unless broke ``x ← x + alpha·p`` and
    ``r ← r'`` in place (the plain step's two ``axpy`` and its merge);
    nrm = ‖r'‖₂·bnrm_inv (‖r'‖₁ under ``-conv_cond nrm1_b``) and the next
    rho = r'·z' by kernel O's trees, folded by the thread that updates
    each element; ``rh[it] = nrm``; on a breakdown the flag is set and nrm
    and rho_old stay; it += 1; the next beta; live.  Kernel S3; bound:
    bytes, x, r, p, q and dinv read and x and r written once (13 limb
    streams)."""
    if not q._on_card(x.hi):
        return _update_plain(x, r, p, qv, dinv, ws, rh)
    ws._check(x.hi, x.lo, r.hi, r.lo, p.hi, p.lo, qv.hi, qv.lo, dinv)
    _cuda.check(rh, "rh", torch.float64, aligned=False)
    G, R = ws.plan
    _cuda.launch("lis_ddcg_update", ws._code, x.hi.data_ptr(),
                 x.lo.data_ptr(), r.hi.data_ptr(), r.lo.data_ptr(),
                 p.hi.data_ptr(), p.lo.data_ptr(), qv.hi.data_ptr(),
                 qv.lo.data_ptr(), _ptr(dinv), ws.n, q._pow2(ws.n), G, R,
                 ws._ptr[3], ws._ptr[0], ws._ptr[1], ws._ptr[2],
                 rh.data_ptr(), int(ws.nrm1), _cuda.stream())
    ddcg_update.launches += 1


ddcg_update.launches = 0
