"""BLAS-1 vector operations used by the solvers, and the fused CG step.

Port of ``lis_tpu/core/vector.py`` (reference src/vector/lis_vector_ops.c):
vectors are torch tensors and every reduction returns a 0-d tensor on the
vector's device, so a solver loop never waits for the device unless it
reads a value on the host.  Each reduction takes lis_tpu's ``axis_name``:
None (serial, no collective) or the ``parallel.mesh.Mesh`` of a
distributed solve, over which the local value is all-reduced (lis_tpu's
``psum`` / ``pmax``, the reference's MPI_Allreduce).

The second half is the fused CG step (kernels G, ``csrc/krylov.cu``):
lis_tpu compiles its Krylov loop to one XLA while-loop, whose vector
updates and reductions XLA fuses; PyTorch runs each as its own launch.
``krylov_dot``, ``cg_direction``, ``cg_update`` and ``cg_finish`` do one
CG iteration's vector work in four launches, with every loop scalar in
the device blocks of a ``KrylovScalars``.  They update their operands in
place, and each does nothing once ``live`` is 0.  On a CUDA tensor each
launches its kernel; on a CPU tensor it takes the plain torch version
beside it.
"""

from __future__ import annotations

import numpy as np
import torch

from lis_tpu_torch.ops import _cuda


def axpy(alpha, x, y):
    """y + alpha*x (lis_vector_axpy semantics, returned functionally)."""
    return y + alpha * x


def xpay(x, alpha, y):
    """x + alpha*y (lis_vector_xpay: y := x + alpha*y)."""
    return x + alpha * y


def axpyz(alpha, x, y):
    """z = alpha*x + y (lis_vector_axpyz)."""
    return alpha * x + y


def scale(alpha, x):
    return alpha * x


def pmul(x, y):
    """Element-wise product (lis_vector_pmul)."""
    return x * y


def pdiv(x, y):
    """Element-wise division (lis_vector_pdiv)."""
    return x / y


def set_all(alpha, like):
    return torch.full_like(like, alpha)


def abs_(x):
    return torch.abs(x)


def reciprocal(x):
    return 1.0 / x


def shift(sigma, x):
    """x - sigma (lis_vector_shift subtracts the scalar)."""
    return x - sigma


def _reduced(local, axis_name, op="sum"):
    """``local`` all-reduced over the mesh ``axis_name`` (None: as it is)."""
    return local if axis_name is None else axis_name.all_reduce(local, op)


def dot(x, y, axis_name=None):
    """<x, y> with conjugation of x for complex (lis_vector_dot)."""
    return _reduced(torch.vdot(x, y) if x.is_complex() else torch.dot(x, y),
                    axis_name)


def nhdot(x, y, axis_name=None):
    """Σ x_i·y_i, neither side conjugated (lis_vector_nhdot): the
    bilinear form of the complex-symmetric solvers COCG and COCR."""
    return _reduced(torch.dot(x, y), axis_name)


def conj(x):
    """Complex conjugate, materialised (no lazy conj view, so a kernel's
    data pointer sees the conjugated values); a real vector is returned
    as it is."""
    return torch.conj_physical(x) if x.is_complex() else x


conjugate = conj          # lis_tpu's name (lis_vector_conjugate)


def nrm2(x, axis_name=None):
    local = torch.vdot(x, x).real if x.is_complex() else torch.dot(x, x)
    if axis_name is not None:
        local = axis_name.all_reduce(local.clone())
    return torch.sqrt(local)


def nrm1(x, axis_name=None):
    return _reduced(torch.sum(torch.abs(x)), axis_name)


def nrmi(x, axis_name=None):
    return _reduced(torch.max(torch.abs(x)), axis_name, "max")


def vsum(x, axis_name=None):
    return _reduced(torch.sum(x), axis_name)


def gather(v):
    """Copy a (possibly device-resident) vector into a host numpy array
    (lis_vector_gather, src/vector/lis_vector.c)."""
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def scatter(arr, like=None):
    """Place a host array on a device as a solver-ready vector
    (lis_vector_scatter): ``like``'s device and dtype, or the default
    device."""
    from lis_tpu_torch.config import default_device
    t = torch.as_tensor(np.asarray(arr))
    if like is None:
        return t.to(default_device())
    return t.to(device=like.device, dtype=like.dtype)


# ---- the fused CG step (kernels G) -----------------------------------------

FUSED_DTYPES = (torch.float32, torch.float64)
_THREADS = 256            # threads per block of csrc/krylov.cu
_MAX_BLOCKS = 1024        # most partials of one reduction

# slots of KrylovScalars.sc / .ic / .part (the layout of csrc/krylov.cu)
_RHO, _RHO_OLD, _PQ, _NRM, _TOL, _BNRM_INV = range(6)
_IT, _FLAG, _LIVE, _MAXITER, _RUNNING, _BREAKDOWN = range(6)
P_RHO, P_PQ, P_NRM = range(3)


class KrylovScalars:
    """The loop scalars of a fused Krylov step, resident on the device.

    ``sc`` holds rho, rho_old, pq, nrm, tol and bnrm_inv in the vectors'
    dtype; ``ic`` (int64) holds it, flag, live, maxiter and the two flag
    values the kernels write or compare (running, breakdown); ``part`` is
    (3, nb): the per-block partial sums of rho, p·q and the residual norm.
    ``it``, ``flag``, ``nrm`` and ``live`` are 0-d views for the solver
    loop: ``live`` is 1 while it <= maxiter, nrm > tol and flag ==
    running, and is the one value the host reads per check."""

    def __init__(self, like: torch.Tensor, maxiter: int, tol, bnrm_inv, nrm0,
                 nrm1: bool, running: int, breakdown: int):
        if like.dtype not in FUSED_DTYPES:
            raise ValueError(f"fused CG step: dtype {like.dtype} not "
                             f"supported (float32 or float64)")
        n, dev = like.shape[0], like.device
        self.n = n
        self.nrm1 = bool(nrm1)
        self.nb = max(1, min(_MAX_BLOCKS, -(-n // _THREADS)))
        self.sc = torch.zeros(8, dtype=like.dtype, device=dev)
        self.sc[_RHO_OLD] = 1.0
        self.sc[_PQ] = 1.0
        self.sc[_NRM] = nrm0
        self.sc[_TOL] = tol
        self.sc[_BNRM_INV] = bnrm_inv
        self.ic = torch.tensor([1, running, 0, maxiter, running, breakdown,
                                0, 0], dtype=torch.int64, device=dev)
        self.ic[_LIVE] = (self.sc[_NRM] > self.sc[_TOL]) & (maxiter >= 1)
        self.part = torch.zeros((3, self.nb), dtype=like.dtype, device=dev)
        self.it, self.flag = self.ic[_IT], self.ic[_FLAG]
        self.live, self.nrm = self.ic[_LIVE], self.sc[_NRM]
        # what every launch passes, looked up once: a step is five
        # launches and its host time is what bounds a small system
        self._code = _cuda.DTYPE_CODE[like.dtype]
        self._sc, self._ic = self.sc.data_ptr(), self.ic.data_ptr()
        self._part = [self.part[k].data_ptr() for k in range(3)]

    def _check(self, *vecs):
        for t in vecs:
            if t is not None:
                _cuda.check(t, "vector", self.sc.dtype, self.n, aligned=False)

    def _is_live(self) -> bool:
        return bool(self.ic[_LIVE])


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one (the plain version);
    any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"no kernel or plain path for {t.device}")
    return False


def _put_sum(ws, slot, total):
    """The plain version of a block reduction: the whole sum in partial
    0, zeros in the others."""
    ws.part[slot].zero_()
    ws.part[slot, 0] = total


def _krylov_dot_plain(u, v, w, ws, slot):
    if ws._is_live():
        _put_sum(ws, slot, torch.dot(u, v if w is None else v * w))


def krylov_dot(u, v, w, ws: KrylovScalars, slot: int) -> None:
    """Partial sums of Σ u_i·(v_i·w_i) (``w`` None: Σ u_i·v_i) into
    ``ws.part[slot]``: rho = ⟨r, D⁻¹r⟩ as (r, dinv, r), rho = ⟨r, z⟩ and
    p·q with ``w`` None.  Kernel G1; bound: bytes, the operands read
    once."""
    if not _on_card(u):
        return _krylov_dot_plain(u, v, w, ws, slot)
    ws._check(u, v, w)
    _cuda.launch("lis_krylov_dot", ws._code, u.data_ptr(), v.data_ptr(),
                 _ptr(w), ws.n, ws._part[slot], ws.nb, ws._ic, _cuda.stream())
    krylov_dot.launches += 1


krylov_dot.launches = 0


def _cg_direction_plain(p, r, z, dinv, ws):
    if not ws._is_live():
        return
    rho = ws.part[P_RHO].sum()
    beta = rho / ws.sc[_RHO_OLD]
    ws.sc[_RHO] = rho
    if z is None:
        z = r if dinv is None else dinv * r
    p.copy_(z + beta * p)


def cg_direction(p, r, z, dinv, ws: KrylovScalars) -> None:
    """rho = Σ part[P_RHO]; beta = rho / rho_old; ``p ← z + beta·p`` in
    place, with z given, or ``dinv·r`` (a diagonal preconditioner folded
    in), or r (none).  Kernel G2; bound: bytes."""
    if not _on_card(p):
        return _cg_direction_plain(p, r, z, dinv, ws)
    ws._check(p, r, z, dinv)
    _cuda.launch("lis_cg_direction", ws._code, p.data_ptr(), r.data_ptr(),
                 _ptr(z), _ptr(dinv), ws.n, ws._part[P_RHO], ws.nb, ws._sc,
                 ws._ic, _cuda.stream())
    cg_direction.launches += 1


cg_direction.launches = 0


def _cg_update_plain(x, r, p, q, dinv, ws, next_rho):
    if not ws._is_live():
        return
    pq = ws.part[P_PQ].sum()
    ws.sc[_PQ] = pq
    broke = bool(pq == 0)
    alpha = ws.sc[_RHO] / (torch.ones_like(pq) if broke else pq)
    rn = r - alpha * q
    if not broke:
        x.copy_(x + alpha * p)
        r.copy_(rn)
    _put_sum(ws, P_NRM, rn.abs().sum() if ws.nrm1 else torch.dot(rn, rn))
    if next_rho:
        _put_sum(ws, P_RHO, torch.dot(rn, rn if dinv is None else dinv * rn))


def cg_update(x, r, p, q, dinv, ws: KrylovScalars, next_rho: bool) -> None:
    """pq = Σ part[P_PQ]; alpha = rho / pq; ``x ← x + alpha·p`` and
    ``r ← r − alpha·q`` in place; partial sums of ‖r‖² (‖r‖₁ under
    ``-conv_cond nrm1_b``) into part[P_NRM] and, with ``next_rho``, of the
    next step's rho = Σ r_i·(dinv_i·r_i) into part[P_RHO].  pq == 0 (the
    breakdown of lis_cg) leaves x and r as they were.  Kernel G3; bound:
    bytes, one pass over x, p, r, q (and dinv)."""
    if not _on_card(x):
        return _cg_update_plain(x, r, p, q, dinv, ws, next_rho)
    ws._check(x, r, p, q, dinv)
    _cuda.launch("lis_cg_update", ws._code, x.data_ptr(), r.data_ptr(),
                 p.data_ptr(), q.data_ptr(), _ptr(dinv), ws.n,
                 ws._part[P_PQ], ws._part[P_NRM],
                 ws._part[P_RHO] if next_rho else 0, ws.nb, ws._sc, ws._ic,
                 int(ws.nrm1), _cuda.stream())
    cg_update.launches += 1


cg_update.launches = 0


def _cg_finish_plain(ws, rh):
    if not ws._is_live():
        return
    s = ws.part[P_NRM].sum()
    nrm_new = s if ws.nrm1 else torch.sqrt(s) * ws.sc[_BNRM_INV]
    it = int(ws.ic[_IT])
    rh[it] = nrm_new
    flag = int(ws.ic[_FLAG])
    if bool(ws.sc[_PQ] == 0):
        flag = int(ws.ic[_BREAKDOWN])
    else:
        ws.sc[_NRM] = nrm_new
    ws.sc[_RHO_OLD] = ws.sc[_RHO]
    ws.ic[_IT] = it + 1
    ws.ic[_FLAG] = flag
    ws.ic[_LIVE] = int(it + 1 <= int(ws.ic[_MAXITER])
                       and bool(ws.sc[_NRM] > ws.sc[_TOL])
                       and flag == int(ws.ic[_RUNNING]))


def cg_finish(ws: KrylovScalars, rh: torch.Tensor) -> None:
    """Close the step: nrm = sqrt(Σ part[P_NRM])·bnrm_inv (or the
    1-norm), ``rh[it] = nrm``, it += 1, rho_old = rho, flag = breakdown
    when pq was 0 (nrm then stays), and live for the next step.  Kernel
    G4, one block."""
    if not _on_card(rh):
        return _cg_finish_plain(ws, rh)
    _cuda.check(rh, "rh", ws.sc.dtype, aligned=False)
    _cuda.launch("lis_cg_finish", ws._code, ws._part[P_NRM], ws.nb, ws._sc,
                 ws._ic, rh.data_ptr(), int(ws.nrm1), _cuda.stream())
    cg_finish.launches += 1


cg_finish.launches = 0
