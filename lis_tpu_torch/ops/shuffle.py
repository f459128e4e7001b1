"""Fixed-permutation shuffle engine — a Benes network of lane gathers.

Port of ``lis_tpu/ops/shuffle.py``.  An arbitrary build-time-fixed
permutation of M = 2^t slots is realised as a mixed-radix Benes network:
M is factored into digits d_1 ... d_k (powers of two <= 128), and the
network permutes digit 1, 2, ..., k, ..., 2, 1 in turn (2k-1 passes);
each pass moves elements only within groups that share every other
digit.  Routing — which group position each element takes in each pass —
is the recursive edge colouring of d-regular bipartite multigraphs,
computed on the host at build time (native C++ from lis_native.cpp, with
pure-Python fallbacks).  The host half is ported unchanged, so both
packages produce equal pass tables for the same permutation.

The device half applies the passes.  Its four hand-written CUDA kernels
(``csrc/lane_shuffle.cu``, ``csrc/benes.cu``) replace lis_tpu's Pallas
kernels:

- ``lane_shuffle`` (kernel #1) — the row-local lane gather of 128-lane
  rows, any 4-, 8- or 16-byte element; it serves the CST select and the
  passes whose digit is below 128;
- ``benes_pass`` (kernel B) — one pass with d = 128 at any stride;
- ``benes_pass_rowsum`` (kernel C) — the last pass fused with the ELL row
  sums of groups of Kp;
- ``benes_small_run`` (kernel D) — a run of s in {1, 128} passes inside
  16384-slot tiles, optionally with the Kp row sums.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version for CPU tensors; any other device raises.  Each counts
its kernel launches in ``<wrapper>.launches``.  A complex vector goes
through a plan as its real and imaginary planes, since B, C and D are
linear and take real values only (lis_tpu ops/shuffle.py:693-698).
"""

from __future__ import annotations

import ctypes
import hashlib
from dataclasses import dataclass

import numpy as np
import torch

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.base import TensorFields, static
from lis_tpu_torch.ops import _cuda

_TAKE_MAX = 1 << 14       # below this, one index_select replaces the passes


# ---------------------------------------------------------------------------
# Routing (host, build time) — logic identical to lis_tpu
# ---------------------------------------------------------------------------

def _euler_split_py(u, v, nu, nv):
    """Pure-Python Hierholzer fallback (slow; the native engine is the
    production path)."""
    m = len(u)
    n = nu + nv
    deg = np.zeros(n + 1, dtype=np.int64)
    np.add.at(deg, u + 1, 1)
    np.add.at(deg, nu + v + 1, 1)
    deg = np.cumsum(deg)
    pos = deg[:-1].copy()
    adj = np.empty(2 * m, dtype=np.int64)
    for i in range(m):
        adj[pos[u[i]]] = i
        pos[u[i]] += 1
        adj[pos[nu + v[i]]] = i
        pos[nu + v[i]] += 1
    cursor = deg[:-1].copy()
    used = np.zeros(m, dtype=bool)
    bit = np.zeros(m, dtype=np.uint8)
    for s in range(n):
        while True:
            while cursor[s] < deg[s + 1] and used[adj[cursor[s]]]:
                cursor[s] += 1
            if cursor[s] == deg[s + 1]:
                break
            node = s
            while True:
                while cursor[node] < deg[node + 1] \
                        and used[adj[cursor[node]]]:
                    cursor[node] += 1
                if cursor[node] == deg[node + 1]:
                    break
                e = adj[cursor[node]]
                used[e] = True
                if node < nu:
                    bit[e] = 1
                    node = nu + v[e]
                else:
                    bit[e] = 0
                    node = u[e]
    return bit


def _euler_split(u, v, nu, nv):
    from lis_tpu_torch import _native
    out = _native.euler_split(u, v, nu, nv)
    if out is None:
        out = _euler_split_py(np.asarray(u, np.int64),
                              np.asarray(v, np.int64), nu, nv)
    return out


def _edge_color_euler(left, right, d):
    """Colour the edges of a d-regular bipartite multigraph (d = 2^p) with
    d colours so each colour class is a perfect matching (Birkhoff/Euler).
    Exact; used when the slot grid has no slack."""
    color = np.zeros(len(left), dtype=np.int64)
    nl = int(left.max()) + 1 if len(left) else 1
    nr = int(right.max()) + 1 if len(right) else 1
    deg = d
    while deg > 1:
        # prefix current colours into node ids: each class splits
        # independently (disjoint components of one multigraph)
        u = color * nl + left
        v = color * nr + right
        ncls = int(color.max()) + 1 if len(color) else 1
        bit = _euler_split(u, v, ncls * nl, ncls * nr)
        color = color * 2 + bit
        deg //= 2
    return color


def _edge_color_greedy(left, right, d, n_nodes, seed=0):
    """Partial edge colouring by randomized rounds (vectorized): an
    uncoloured edge samples a colour and sticks when the (node, colour)
    slot is free on BOTH endpoints and no same-round rival claimed it.
    Three phases trade vector width for hit rate as the free-slot pool
    drains: uniform sampling -> sampling among the left node's free
    colours -> sequential first-free walk.  Returns None if edges remain
    (the caller falls back to the exact Euler decomposition)."""
    rng = np.random.default_rng(seed)
    m = len(left)
    left = left.astype(np.int64)
    right = right.astype(np.int64)
    free_l = np.ones((n_nodes, d), dtype=bool)
    free_r = np.ones((n_nodes, d), dtype=bool)
    color = np.full(m, -1, dtype=np.int64)
    todo = np.arange(m)
    # same-round rival detection by claim-stamping: a slot's last writer
    # survives iff it reads its own unique stamp back
    claim = np.zeros(n_nodes * d, dtype=np.int64)
    stamp = np.int64(1)

    def accept(c):
        nonlocal todo, stamp
        kl = left[todo] * d + c
        kr = right[todo] * d + c
        ok = free_l.reshape(-1)[kl] & free_r.reshape(-1)[kr]
        i = np.flatnonzero(ok)
        claim[kl[i]] = stamp + i
        i = i[claim[kl[i]] == stamp + i]
        claim[kr[i]] = stamp + i
        i = i[claim[kr[i]] == stamp + i]
        stamp += m
        color[todo[i]] = c[i]
        free_l.reshape(-1)[kl[i]] = False
        free_r.reshape(-1)[kr[i]] = False
        keep = np.ones(len(todo), dtype=bool)
        keep[i] = False
        todo = todo[keep]

    # phase 1: uniform colours — cheap rounds while slots are plentiful
    for _ in range(24):
        if len(todo) <= (1 << 18):
            break
        before = len(todo)
        accept(rng.integers(0, d, size=len(todo)))
        if len(todo) > 0.9 * before:
            break                      # occupancy too high for blind luck
    # phase 2: sample among the LEFT node's free colours (d-wide rows)
    for _ in range(96):
        if not len(todo) or len(todo) <= (1 << 13):
            break
        fl = free_l[left[todo]]
        cnt = fl.sum(axis=1, dtype=np.uint8)
        if (cnt == 0).any():
            return None
        r = (rng.random(len(todo)) * cnt).astype(np.uint8)
        c = (fl.cumsum(axis=1, dtype=np.uint8)
             > r[:, None]).argmax(axis=1)
        accept(c)
    # phase 3: sequential first-free walk over the stragglers
    if len(todo) > (1 << 15):
        return None
    for e in todo:
        both = free_l[left[e]] & free_r[right[e]]
        c = int(both.argmax())
        if not both[c]:
            return None
        color[e] = c
        free_l[left[e], c] = False
        free_r[right[e], c] = False
    return color


def factor_digits(M: int):
    """Digits (powers of two <= 128) with the fastest digit 128 so the
    centre pass is a plain stride-1 lane gather."""
    t = int(M).bit_length() - 1
    if (1 << t) != M:
        raise ValueError("shuffle plan needs a power-of-two slot count")
    k = -(-t // 7)
    first = t - 7 * (k - 1)
    return [1 << first] + [128] * (k - 1)


def block_digits(M: int, L: int):
    """Digits whose trailing product is the block length L: a block-local
    permutation (every element stays within its L-aligned block) leaves
    the leading digits untouched, and _route skips those levels.  L must
    be a power of 128 so every coloured level has d = 128."""
    q = 0
    ll = L
    while ll > 1:
        if ll % 128:
            raise ValueError("block length must be a power of 128")
        ll //= 128
        q += 1
    lead = factor_digits(M // L) if M > L else []
    return lead + [128] * q


def _edge_color(left, right, d, n_nodes):
    """Proper partial edge colouring (distinct colours per node on both
    sides): native greedy first, then the vectorized greedy (only when the
    native library is missing), then the exact Euler decomposition with
    the graph completed to d-regular by dummy edges."""
    from lis_tpu_torch import _native
    out = _native.greedy_color(left, right, n_nodes, d)
    if out is not None and out[0] == 0:
        return out[1].astype(np.int64)
    if out is None:
        c = _edge_color_greedy(left, right, d, n_nodes)
        if c is not None:
            return c
    deg_l = np.bincount(left, minlength=n_nodes)
    deg_r = np.bincount(right, minlength=n_nodes)
    dum_l = np.repeat(np.arange(n_nodes, dtype=np.int64), d - deg_l)
    dum_r = np.repeat(np.arange(n_nodes, dtype=np.int64), d - deg_r)
    full = _edge_color_euler(np.concatenate([left, dum_l]),
                             np.concatenate([right, dum_r]), d)
    return full[: len(left)]


def _pass_idx(pos_before, pos_after, d, s, M, exact_holes=False):
    """Lane gather indices (M/128, 128) for one Benes pass.

    The pass permutes digit j (size d, stride s): group
    g = (pos // (d*s)) * s + pos % s is invariant.  The array is viewed as
    (M/(d*s), d, s), transposed to (.., s, d), and cut into rows of 128
    lanes holding 128/d consecutive groups; idx is the within-row gather.
    Unoccupied slots read their own lane unless ``exact_holes``, which
    routes unread source lanes into unwritten output lanes so every row
    stays a true permutation."""
    from lis_tpu_torch import _native
    out = _native.pass_idx(pos_before, pos_after, int(d), int(s), int(M),
                           exact_holes)
    if out is not None:
        return out
    ls = s.bit_length() - 1
    ld = d.bit_length() - 1
    g = ((pos_after >> (ld + ls)) << ls) + (pos_after & (s - 1))
    a_before = ((pos_before >> ls) & (d - 1)).astype(np.int32)
    a_after = ((pos_after >> ls) & (d - 1)).astype(np.int32)
    gpr = 128 // d
    lg = gpr.bit_length() - 1
    rows = g >> lg
    base = ((g & (gpr - 1)) << ld).astype(np.int32)
    if exact_holes:
        idx = np.full((M // 128, 128), -1, dtype=np.int32)
        idx[rows, base + a_after] = base + a_before
        read = np.zeros((M // 128, 128), dtype=bool)
        read[rows, base + a_before] = True
        # pair the j-th unwritten output with the j-th unread lane per row
        unread = np.argsort(read, axis=1, kind="stable").astype(np.int32)
        hole = idx < 0
        jrank = np.cumsum(hole, axis=1, dtype=np.int32) - 1
        np.copyto(idx, np.take_along_axis(unread, jrank, axis=1),
                  where=hole)
        return idx
    idx = np.broadcast_to(np.arange(128, dtype=np.int32),
                          (M // 128, 128)).copy()
    idx.reshape(-1)[rows * 128 + base + a_after] = base + a_before
    return idx


def _route(src: np.ndarray, dst: np.ndarray, M: int, digits=None,
           exact_holes=False, skip_identity=True):
    """Benes routing: list of (d, s, idx) passes moving the element at
    slot src[i] to slot dst[i] (injective; free slots hole-filled).
    Levels whose digit is already final for every element are skipped."""
    digits = digits or factor_digits(M)
    if int(np.prod(digits)) != M:
        raise ValueError(f"digits {digits} do not multiply to M = {M}")
    k = len(digits)
    strides = np.cumprod([1] + digits[:0:-1])[::-1]  # s_j = prod d_{>j}
    dst = dst.astype(np.int64)
    cur = src.astype(np.int64)
    passes = []
    # forward half: level-j colouring pins digit j to the sub-network id
    mirrored = []
    for j in range(k - 1):
        d, s = digits[j], int(strides[j])
        ls, ld = s.bit_length() - 1, d.bit_length() - 1
        if skip_identity and np.array_equal((cur >> ls) & (d - 1),
                                            (dst >> ls) & (d - 1)):
            continue
        prefix = ((cur >> (ld + ls)) << ls)
        left = (cur & (s - 1)) + prefix
        right = (dst & (s - 1)) + prefix
        c = _edge_color(left, right, d, M // d)
        nxt = ((cur >> (ld + ls)) << (ld + ls)) + (c << ls) + (cur & (s - 1))
        passes.append((d, s, _pass_idx(cur, nxt, d, s, M, exact_holes)))
        cur = nxt
        mirrored.append(j)
    # centre pass: digit k goes to its final value
    d = digits[-1]
    ld = d.bit_length() - 1
    nxt = ((cur >> ld) << ld) + (dst & (d - 1))
    if not (skip_identity and np.array_equal(nxt, cur)):
        passes.append((d, 1, _pass_idx(cur, nxt, d, 1, M, exact_holes)))
    cur = nxt
    # mirrored half: coloured digits from colour to final, innermost first
    for j in reversed(mirrored):
        d, s = digits[j], int(strides[j])
        ls, ld = s.bit_length() - 1, d.bit_length() - 1
        nxt = (((cur >> (ld + ls)) << ld) + ((dst >> ls) & (d - 1))) * s \
            + (cur & (s - 1))
        if not (skip_identity and np.array_equal(nxt, cur)):
            passes.append((d, s, _pass_idx(cur, nxt, d, s, M, exact_holes)))
        cur = nxt
    if not (cur == dst).all():
        raise AssertionError("Benes routing failed to realise the perm")
    return passes


def apply_host(passes, v, M):
    """Numpy application of a pass list (build-time validation)."""
    out = np.asarray(v)
    for d, s, idx in passes:
        pre = M // (d * s)
        x = np.swapaxes(out.reshape(pre, d, s), 1, 2).reshape(-1, 128)
        x = np.take_along_axis(x, idx, axis=1)
        out = np.swapaxes(x.reshape(pre, s, d), 1, 2).reshape(-1)
    return out


# ---------------------------------------------------------------------------
# Device kernels and their plain versions
# ---------------------------------------------------------------------------

_FLOATS = (torch.float32, torch.float64)
_ELEMS = _FLOATS + (torch.complex64, torch.complex128)


def _on_cuda(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU tensor (plain
    version); any other device raises."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {x.device}")


def _lane_shuffle_plain(x, idx, rep=1):
    if rep > 1:
        x = x.repeat_interleave(rep, dim=0)
    return torch.gather(x, 1, idx.long())


def lane_shuffle(x: torch.Tensor, idx: torch.Tensor, rep: int = 1):
    """``out[r, l] = x[r // rep, idx[r, l]]``: x is (R/rep, 128), idx is
    (R, 128) uint8, out is (R, 128); rep is a power of two dividing R.

    Kernel #1 replaces lis_tpu ``_lane_shuffle32`` (ops/shuffle.py:350)
    and the dtype-generic ``_lane_shuffle`` (:393): f32, f64, complex64
    and complex128 move as whole elements.  ``rep`` folds the chunk
    repeat of ``CSTMatrix._select`` into the kernel.  Bound on the H100:
    bytes — per output slot 1 B of idx read and one element written, x
    read once per source row.  One block stages 16 output rows' idx and
    their source rows in shared memory (16-byte loads), gathers there and
    stores coalesced."""
    R = idx.shape[0]
    if (rep < 1 or rep & (rep - 1) or R % rep
            or tuple(x.shape) != (R // rep, 128) or idx.shape[1:] != (128,)):
        raise ValueError(f"lane_shuffle: x {tuple(x.shape)}, idx "
                         f"{tuple(idx.shape)}, rep {rep}")
    if not _on_cuda(x):
        return _lane_shuffle_plain(x, idx, rep)
    _cuda.check(x, "x", _ELEMS)
    _cuda.check(idx, "idx", torch.uint8)
    out = torch.empty((R, 128), dtype=x.dtype, device=x.device)
    if R == 0:
        return out
    _cuda.launch("lis_lane_shuffle", _cuda.DTYPE_CODE[x.dtype], x.data_ptr(),
                 idx.data_ptr(), out.data_ptr(), R, rep, _cuda.stream())
    lane_shuffle.launches += 1
    return out


lane_shuffle.launches = 0


def _pass_rows(x, idx, d, s, shuffle):
    """One pass as lis_tpu's legacy route (ops/shuffle.py:701-705) takes
    it: view (pre, d, s), transpose to rows of 128 lanes, ``shuffle``
    them by idx, transpose back."""
    pre = x.numel() // (d * s)
    t = x.view(pre, d, s).transpose(1, 2).reshape(-1, 128)
    t = shuffle(t, idx)
    return t.view(pre, s, d).transpose(1, 2).reshape(-1)


def _pass_plain(x, idx, d, s):
    return _pass_rows(x, idx, d, s, _lane_shuffle_plain)


def benes_pass(x: torch.Tensor, idx: torch.Tensor, d: int, s: int):
    """One Benes pass ``out[p, a, w] = x[p, idx[p*s + w, a], w]`` over the
    flat (M,) x viewed as (M/(d*s), d, s); idx is (M/128, 128) uint8.

    Kernel B replaces lis_tpu ``_fused_pass32`` (ops/shuffle.py:419).
    Bound on the H100: bytes — per slot 8 B read + 1 B idx + 8 B write at
    f64.  The kernel moves (128 x 32)-slot tiles through shared memory:
    coalesced loads along w, the lane gather out of shared memory, then
    coalesced stores; it takes every power-of-two stride, s = 1 included.
    A pass with d < 128 takes the legacy route instead: two transposing
    copies around ``lane_shuffle`` (kernel #1)."""
    if not _on_cuda(x):
        return _pass_plain(x, idx, d, s)
    M = x.numel()
    if d != 128:
        return _pass_rows(x, idx, d, s, lane_shuffle)
    _cuda.check(x, "x", _FLOATS)
    _cuda.check(idx, "idx", torch.uint8, M)
    if M % (128 * 32) or s & (s - 1) or M % (128 * s):
        raise ValueError(f"benes_pass: bad shape M={M}, s={s}")
    out = torch.empty_like(x)
    _cuda.launch("lis_benes_pass", _cuda.DTYPE_CODE[x.dtype], x.data_ptr(),
                 idx.data_ptr(), out.data_ptr(), M, s, _cuda.stream())
    benes_pass.launches += 1
    return out


benes_pass.launches = 0


def benes_pass_rowsum(x: torch.Tensor, idx: torch.Tensor, s: int, Kp: int):
    """``benes_pass(x, idx, 128, s).view(-1, Kp).sum(1)`` with Kp | s:
    the last pass of an exact-holes plan fused with the ELL row sums.

    Kernel C replaces lis_tpu ``_fused_pass_rowsum32``
    (ops/shuffle.py:509).  Bound on the H100: bytes — the routed array is
    never written, only its sums (8/Kp B per slot).  The kernel gathers
    the same shared-memory tile as kernel B and sums each group of Kp
    consecutive w: within the tile for Kp < 32, and carried in a register
    per lane over Kp/32 tiles for Kp >= 32 (any Kp <= 256 dividing s).
    The summation order differs from the plain version's."""
    if not _on_cuda(x):
        return _pass_plain(x, idx, 128, s).view(-1, Kp).sum(1)
    M = x.numel()
    _cuda.check(x, "x", _FLOATS)
    _cuda.check(idx, "idx", torch.uint8, M)
    if (Kp & (Kp - 1) or s % Kp or Kp > 256 or s & (s - 1)
            or M % (128 * max(32, Kp)) or M % (128 * s)):
        raise ValueError(f"benes_pass_rowsum: bad shape M={M}, s={s}, "
                         f"Kp={Kp}")
    y = torch.empty(M // Kp, dtype=x.dtype, device=x.device)
    _cuda.launch("lis_benes_pass_rowsum", _cuda.DTYPE_CODE[x.dtype],
                 x.data_ptr(), idx.data_ptr(), y.data_ptr(), M, s, Kp,
                 _cuda.stream())
    benes_pass_rowsum.launches += 1
    return y


benes_pass_rowsum.launches = 0


class RunTables:
    """The idx tables and strides of one fused run, as ``benes_small_run``
    takes them.  The tables are validated and the ctypes arrays of the C
    entry made at the first launch and kept, so a plan that holds its
    RunTables pays for them once; the tables are held here, which keeps
    their pointers valid."""

    __slots__ = ("idxs", "ss", "_c_args")

    def __init__(self, idxs, ss):
        self.idxs = tuple(idxs)
        self.ss = tuple(int(s) for s in ss)
        self._c_args = None
        if any(s not in (1, 128) for s in self.ss):
            raise ValueError(f"benes_small_run takes strides 1 and 128 "
                             f"only, got {list(self.ss)}")
        if len(self.idxs) != len(self.ss):
            raise ValueError(f"benes_small_run: {len(self.idxs)} tables for "
                             f"{len(self.ss)} strides")

    def c_args(self, x: torch.Tensor):
        """(idx pointer array, stride array, pass count) for a launch on
        ``x``."""
        M = x.numel()
        if self._c_args is None:
            n = len(self.ss)
            if M % 16384 or M == 0 or not 1 <= n <= 8:
                raise ValueError(f"benes_small_run: bad shape M={M}, "
                                 f"{n} passes")
            for idx in self.idxs:
                _cuda.check(idx, "idx", torch.uint8, M)
            # the kernel does not mask its lane ids (one read per run)
            if max(int(idx.max()) for idx in self.idxs) >= 128:
                raise ValueError("benes_small_run: idx holds a lane id "
                                 ">= 128")
            ptrs = (ctypes.c_void_p * n)(*[i.data_ptr() for i in self.idxs])
            strides = (ctypes.c_int * n)(*self.ss)
            # the casts hold references to the arrays they point into
            self._c_args = (M, ctypes.cast(ptrs, ctypes.c_void_p),
                            ctypes.cast(strides, ctypes.c_void_p), n)
        if self._c_args[0] != M:
            raise ValueError(f"benes_small_run: x has {M} slots, the "
                             f"tables {self._c_args[0]}")
        if self.idxs[0].device != x.device:
            raise ValueError(f"benes_small_run: x on {x.device}, the tables "
                             f"on {self.idxs[0].device}")
        return self._c_args[1:]


def benes_small_run(x: torch.Tensor, run: RunTables, Kp: int | None = None):
    """A run of d = 128 passes with strides ``run.ss`` (each 1 or 128)
    applied in one go, optionally followed by the row sums
    ``.view(-1, Kp).sum(1)`` (Kp <= 128, 128 % Kp == 0).  Every such pass
    permutes within aligned 16384-slot tiles T[a][w]: s = 1 gathers within
    row a, s = 128 within column w.  ``run`` holds the idx tables and
    their strides (a plan keeps one per run).

    Kernel D replaces lis_tpu ``_fused_small32`` (ops/shuffle.py:583).
    Bound on the H100: bytes — one read and one write of the array for the
    whole run instead of one per pass, plus 1 B of idx per slot and pass.
    A persistent grid of one block per SM walks the tiles.  A tile comes
    into shared memory unpadded by bulk asynchronous copies (one buffer,
    128 KB at f64, reloaded as soon as the last pass has read it, so the
    load overlaps that pass's stores), and the idx
    bytes of the next five passes wait in a shared-memory ring filled by
    cp.async, so a pass touches no global memory.  Each pass gathers the
    whole tile into registers, meets at one barrier and writes back; the
    last pass stores its registers straight to global memory, or reduces
    them to the Kp row sums by a pairwise tree over w (warp shuffles), an
    order that differs from the plain version's.  Strides other than 1
    and 128 raise (lis_tpu's run detector let 1 < s < 128 through, which
    its kernel mis-permutes)."""
    if Kp is not None and (Kp > 128 or 128 % Kp):
        raise ValueError(f"benes_small_run: Kp = {Kp} must divide 128")
    if not _on_cuda(x):
        out = x
        for idx, s in zip(run.idxs, run.ss):
            out = _pass_plain(out, idx, 128, s)
        return out if Kp is None else out.view(-1, Kp).sum(1)
    M = x.numel()
    _cuda.check(x, "x", _FLOATS)
    ptrs, strides, n = run.c_args(x)
    out = torch.empty(M if Kp is None else M // Kp, dtype=x.dtype,
                      device=x.device)
    lkp = -1 if Kp is None else Kp.bit_length() - 1
    _cuda.launch("lis_benes_small_run", _cuda.DTYPE_CODE[x.dtype],
                 x.data_ptr(), ptrs, strides, n, out.data_ptr(), M, lkp,
                 _cuda.stream())
    benes_small_run.launches += 1
    return out


benes_small_run.launches = 0


def _small_run(meta):
    """(start, stop) of the first maximal run of >= 2 consecutive passes
    with d == 128 and s in {1, 128} (the 16384-tile-local passes
    ``benes_small_run`` fuses), or None."""
    def small(m):
        return m[0] == 128 and m[1] in (1, 128)
    i = 0
    n = len(meta)
    while i < n:
        if small(meta[i]):
            j = i
            while j < n and small(meta[j]):
                j += 1
            if j - i >= 2:
                return i, j
            i = j
        else:
            i += 1
    return None


@dataclass(frozen=True, eq=False)
class ShufflePlan(TensorFields):
    """A fixed permutation compiled to Benes passes.

    apply(v) returns w with w[perm[i]] = v[i]."""
    idxs: tuple               # (M/128, 128) uint8 per pass
    meta: tuple = static()    # ((d, s), ...)
    M: int = static()
    small: object = None      # tiny plans: int64 gather order, or None

    def _run(self):
        """(start, stop, RunTables) of the passes ``benes_small_run``
        fuses, or None; made once per plan object."""
        try:
            return self._run_cache
        except AttributeError:
            pass
        run = None
        if self.M >= 16384 and self.M % 16384 == 0:
            span = _small_run(self.meta)
            if span is not None:
                i, j = span
                run = (i, j, RunTables(self.idxs[i:j],
                                       [s for _, s in self.meta[i:j]]))
        object.__setattr__(self, "_run_cache", run)
        return run

    def apply(self, v):
        if self.small is not None:
            return v.index_select(0, self.small)
        if v.is_complex():
            return torch.complex(self.apply(v.real.contiguous()),
                                 self.apply(v.imag.contiguous()))
        out = v
        metas, idxs = self.meta, self.idxs
        run = self._run()
        i = 0
        while i < len(metas):
            if run is not None and i == run[0]:
                out = benes_small_run(out, run[2])
                i = run[1]
                continue
            (d, s), idx = metas[i], idxs[i]
            out = benes_pass(out, idx, d, s)
            i += 1
        return out

    def apply_rowsum(self, v, Kp: int):
        """apply(v).view(M // Kp, Kp).sum(1), with the row sums fused into
        the last pass or run.  Only meaningful for exact-holes plans,
        where every hole slot carries a zero."""
        if self.small is not None:
            return v.index_select(0, self.small).view(-1, Kp).sum(1)
        if v.is_complex():
            return torch.complex(self.apply_rowsum(v.real.contiguous(), Kp),
                                 self.apply_rowsum(v.imag.contiguous(), Kp))
        out = v
        metas, idxs = self.meta, self.idxs
        run = self._run()
        last = len(metas) - 1
        i = 0
        while i < len(metas):
            if run is not None and i == run[0]:
                stop = run[1]
                if stop == len(metas) and Kp <= 128 and 128 % Kp == 0:
                    return benes_small_run(out, run[2], Kp=Kp)
                out = benes_small_run(out, run[2])
                i = stop
                continue
            (d, s), idx = metas[i], idxs[i]
            if i == last and d == 128 and s % Kp == 0 and Kp <= 256:
                return benes_pass_rowsum(out, idx, s, Kp)
            out = benes_pass(out, idx, d, s)
            i += 1
        return out.view(-1, Kp).sum(1)

    @property
    def nbytes(self) -> int:
        n = sum(t.numel() * t.element_size() for t in self.idxs)
        if self.small is not None:
            n += self.small.numel() * self.small.element_size()
        return n


# Plans are memoised on a content hash of (perm, M, digits, flags), so a
# re-assembled matrix with an unchanged sparsity pattern skips the host
# routing.  Cached plans keep their tables on the host (a device copy is
# made by ``.to(device)``), and the cache is bounded by the bytes it holds.
_PLAN_CACHE: "dict[bytes, ShufflePlan]" = {}
_PLAN_CACHE_MAX_BYTES = 1 << 30


def plan_shuffle(perm: np.ndarray, M: int | None = None,
                 validate: bool = True, digits=None,
                 exact_holes: bool = False,
                 skip_identity: bool = True, device=None) -> ShufflePlan:
    """Compile a permutation into a ShufflePlan on ``device`` (None: the
    default device, the card).  The routing runs on the host; the cache
    keeps the host copy, which ``device="cpu"`` returns as it is.

    ``perm`` maps src slot -> dst slot; -1 entries are free, and dst slots
    not hit are free — both are completed into a full bijection.  ``M``
    (power of two >= len(perm)) pads the slot count."""
    plan = _plan_host(perm, M, validate, digits, exact_holes,
                      skip_identity)
    dev = resolve_device(device)
    return plan if dev.type == "cpu" else plan.to(dev)


def _plan_host(perm, M, validate, digits, exact_holes,
               skip_identity) -> ShufflePlan:
    perm = np.asarray(perm, dtype=np.int64)
    h = hashlib.blake2b(perm.tobytes(), digest_size=16)
    h.update(repr((M, tuple(digits) if digits else None, exact_holes,
                   skip_identity, validate)).encode())
    key = h.digest()
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit
    M = M or len(perm)
    if M < len(perm):
        raise ValueError(f"M = {M} < len(perm) = {len(perm)}")
    real = np.flatnonzero(perm >= 0)
    src = real.astype(np.int64)
    dst = perm[real]
    if len(np.unique(dst)) != len(dst):
        raise ValueError("perm has duplicate destinations")
    if M <= _TAKE_MAX:
        # tiny: one gather; unfilled outputs read unread (empty) slots
        inv = np.full(M, -1, dtype=np.int64)
        inv[dst] = src
        unread = np.setdiff1d(np.arange(M, dtype=np.int64), src,
                              assume_unique=False)
        inv[inv < 0] = unread[: int((inv < 0).sum())]
        return _plan_cache_put(key, ShufflePlan(
            idxs=(), meta=(), M=M, small=torch.from_numpy(inv)))
    passes = _route(src, dst, M, digits=digits,
                    exact_holes=exact_holes, skip_identity=skip_identity)
    if validate:
        got = apply_host(passes, np.arange(M, dtype=np.int64), M)
        if not np.array_equal(got[dst], src):
            raise AssertionError("shuffle routing produced a wrong plan")
    return _plan_cache_put(key, ShufflePlan(
        # lane ids are < 128: one byte per slot of index traffic
        idxs=tuple(torch.from_numpy(idx.astype(np.uint8))
                   for (_, _, idx) in passes),
        meta=tuple((d, s) for (d, s, _) in passes), M=M))


def _plan_cache_put(key: bytes, plan: ShufflePlan) -> ShufflePlan:
    size = plan.nbytes
    if size > _PLAN_CACHE_MAX_BYTES:
        return plan
    held = sum(p.nbytes for p in _PLAN_CACHE.values())
    while _PLAN_CACHE and held + size > _PLAN_CACHE_MAX_BYTES:
        held -= _PLAN_CACHE.pop(next(iter(_PLAN_CACHE))).nbytes  # FIFO
    _PLAN_CACHE[key] = plan
    return plan
