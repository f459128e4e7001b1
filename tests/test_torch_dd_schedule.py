"""The order of additions of kernels O (dd_reduce) and N (dd_ell_spmv),
modelled in numpy on the CPU.

Both kernels reproduce a summation tree of lis_tpu bit for bit but add
in another place: O splits lis_tpu's halving tree (``_dd_sum``) over a
thread's walk, the groups of blocks, the last group and the last block;
N adds the first level of lis_tpu's row tree (``_dd_row_reduce``) while
it stages a span of rows, then one thread a row adds the rest
(``lis_tpu_torch/csrc/dd.cu`` says how).  Each model here follows its
kernel's schedule step by step, with the parameters (G, R, B, the rows a
block) taken from the functions the wrappers call (``_reduce_plan``,
``_ell_plan``, ``_ell_rows``), and must be bit-equal to the port's plain version and to
lis_tpu on the same inputs, made by numpy from a seed, in f64 and in f32
limbs.  numpy rounds every operation on its own, as the kernels'
``_rn`` intrinsics do.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from lis_tpu.core import ddreal as J
from lis_tpu_torch.core import ddreal as T

LIMBS = [np.float64, np.float32]
SPLIT = {np.float64: 134217729.0, np.float32: 4097.0}


# ---- the DD arithmetic of csrc/dd.cu, in numpy -------------------------

def two_sum(a, b):
    s = a + b
    v = s - a
    return s, (a - (s - v)) + (b - v)


def quick_two_sum(a, b):
    s = a + b
    return s, b - (s - a)


def split(a):
    t = a.dtype.type(SPLIT[a.dtype.type]) * a
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, (((ah * bh - p) + ah * bl) + al * bh) + al * bl


def dd_add(x, y):
    sh, se = two_sum(x[0], y[0])
    th, te = two_sum(x[1], y[1])
    sh, se = quick_two_sum(sh, se + th)
    return quick_two_sum(sh, se + te)


def dd_mul(x, y):
    p, e = two_prod(x[0], y[0])
    return quick_two_sum(p, (e + x[0] * y[1]) + x[1] * y[0])


def dd_sqrt(x):
    hi = x[0]
    s = np.sqrt(hi)
    zero = s == 0
    s = np.where(zero, 1, s).astype(hi.dtype)
    p, e = two_prod(s, s)
    corr = ((hi - p) + (x[1] - e)) / (hi.dtype.type(2) * s)
    r = quick_two_sum(s, corr)
    return np.where(zero, 0, r[0]).astype(hi.dtype), \
        np.where(zero, 0, r[1]).astype(hi.dtype)


def _vec(rng, n, dt, nan=False):
    hi = rng.standard_normal(n)
    hi[::97] = 0.0
    lo = hi * rng.uniform(-0.5, 0.5, n) * np.finfo(dt).eps
    hi, lo = hi.astype(dt), lo.astype(dt)
    if nan:
        hi[0] = np.nan
    return hi, lo


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


# ---- kernel O ----------------------------------------------------------

def _terms(mode, x, y):
    if mode == T._DOT:
        return dd_mul(x, y)
    if mode == T._NRM2:
        return dd_mul(x, x)
    if mode == T._NRM1:               # torch.sign: 0 for 0 and for NaN
        sg = ((x[0] > 0).astype(x[0].dtype) - (x[0] < 0).astype(x[0].dtype))
        return np.abs(x[0]), sg * x[1]
    return x


def _bitrev(p, bits):
    return int(format(p, f"0{bits}b")[::-1], 2) if bits else 0


def _walk(v, chunk):
    """csrc/dd.cu's ``walk`` over v = (hi, lo) of shape (J, ...): the
    halving tree over axis 0, walked in bit-reversed order, in register
    subtrees of ``chunk`` values and a stack above them."""
    J = v[0].shape[0]
    bits = J.bit_length() - 1
    at = [(v[0][_bitrev(p, bits)], v[1][_bitrev(p, bits)]) for p in range(J)]
    stack = []
    if J < chunk:
        for p in range(J):
            s, q = at[p], p
            while q & 1:
                s = dd_add(stack.pop(), s)
                q >>= 1
            stack.append(s)
        return stack[0]
    for c in range(J // chunk):
        u = at[chunk * c:chunk * c + chunk]
        while len(u) > 1:
            u = [dd_add(u[2 * k], u[2 * k + 1]) for k in range(len(u) // 2)]
        s, q = u[0], c
        while q & 1:
            s = dd_add(stack.pop(), s)
            q >>= 1
        stack.append(s)
    return stack[0]


# the walks' chunks in csrc/dd.cu: kChunk terms in pass 1 and in the single
# block, 8 partials in the group and final trees
PASS1_CHUNK, PARTS_CHUNK = 4, 8


def _block_finish(v, mode):
    """The in-block halving tree over B values (the levels down to 32 in
    shared memory, then the shuffles: the same pairs), then the finish."""
    h, lo = v
    half = h.shape[0] // 2
    while half > 0:
        h, lo = dd_add((h[:half], lo[:half]), (h[half:2 * half],
                                              lo[half:2 * half]))
        half //= 2
    r = quick_two_sum(h[0], lo[0])
    return dd_sqrt(r) if mode == T._NRM2 else r


def reduce_model(mode, x, y, plan):
    """Kernel O's schedule for ``plan`` = (G, R) from ``_reduce_plan``."""
    n = x[0].shape[0]
    m = T._pow2(n)
    t = _terms(mode, x, y)
    t = tuple(np.concatenate([a, np.zeros(m - n, a.dtype)]) for a in t)
    G, R = plan
    if G == 0:
        B = min(m, T._RED_FINAL)
        return _block_finish(_walk(tuple(a.reshape(m // B, B) for a in t),
                                   PASS1_CHUNK), mode)
    B = T._RED_THREADS
    TT = G * B
    # pass 1: thread t = b*B + s owns terms t + TT*j
    part = _walk(tuple(a.reshape(m // TT, TT) for a in t), PASS1_CHUNK)
    # groups: block b = r + R*u, the tree over u for each (r, s)
    q = _walk(tuple(a.reshape(G // R, R, B) for a in part), PARTS_CHUNK)
    # final: the tree over r for each s, then over s
    return _block_finish(_walk(q, PARTS_CHUNK), mode)


def _lis_tpu_reduce(mode, x, y):
    jx = J.DD(jnp.asarray(x[0]), jnp.asarray(x[1]))
    if mode == T._DOT:
        return J.dot(jx, J.DD(jnp.asarray(y[0]), jnp.asarray(y[1])))
    return {T._SUM: J._dd_sum, T._NRM2: J.nrm2, T._NRM1: J.nrm1}[mode](jx)


def _port_plain(mode, x, y):
    def lift(p):
        return T.DD(torch.from_numpy(p[0]), torch.from_numpy(p[1]))
    r = T._reduce_plain(mode, lift(x), None if y is None else lift(y))
    return r.hi.numpy(), r.lo.numpy()


REDUCE_N = [1, 2, 7, 1 << 15, (1 << 15) + 1, (1 << 16) + 1, 1 << 17,
            (1 << 17) + 1, 1 << 18, (1 << 18) + 1]


@pytest.mark.parametrize("mode", [T._SUM, T._DOT, T._NRM2, T._NRM1])
@pytest.mark.parametrize("n", REDUCE_N)
@pytest.mark.parametrize("dt", LIMBS)
def test_reduce_schedule(dt, n, mode):
    """n = 2^15 + 1 is the first grid plan; 2^16 + 1 and 2^17 + 1 are
    m/2 + 1 of m = 2^17 and 2^18; 2^18 + 1 reaches the widest grid."""
    rng = np.random.default_rng(n + mode)
    x, y = _vec(rng, n, dt), _vec(rng, n, dt)
    y = y if mode == T._DOT else None
    got = reduce_model(mode, x, y, T._reduce_plan(n))
    _same(got, _port_plain(mode, x, y))
    _same(got, _lis_tpu_reduce(mode, x, y))


@pytest.mark.parametrize("dt", LIMBS)
def test_reduce_schedule_nan(dt):
    rng = np.random.default_rng(5)
    n = (1 << 17) + 3
    x, y = _vec(rng, n, dt, nan=True), _vec(rng, n, dt)
    for mode in range(4):
        yy = y if mode == T._DOT else None
        got = reduce_model(mode, x, yy, T._reduce_plan(n))
        assert np.isnan(got[0]) and np.isnan(got[1])
        want = _port_plain(mode, x, yy)
        np.testing.assert_array_equal(np.isnan(want), [True, True])


@pytest.mark.parametrize("G", [4, 8, 16, 32, 64, 128])
def test_reduce_schedule_any_grid(G):
    """Every grid the C entry accepts adds in lis_tpu's order: G blocks
    in each group split the wrapper's rule allows, at m = 2^18."""
    dt = np.float64
    rng = np.random.default_rng(G)
    n = (1 << 18) - 5
    x, y = _vec(rng, n, dt), _vec(rng, n, dt)
    want = _port_plain(T._DOT, x, y)
    R = 1
    while R <= G:
        _same(reduce_model(T._DOT, x, y, (G, R)), want)
        R *= 4


def test_reduce_plan():
    """The plan fits the C entry's checks: one block up to 2^15 padded
    terms; above, G a power of two from 32 to _RED_BLOCKS (128, all
    resident at once) with at least 8 terms a thread, R groups of G / R,
    both powers of two, G / R <= R."""
    for k in range(0, 31):
        n = 1 << k
        G, R = T._reduce_plan(n)
        if n <= 1 << 15:
            assert (G, R) == (0, 0)
            continue
        assert G & (G - 1) == 0 and 32 <= G <= T._RED_BLOCKS
        assert G * T._RED_THREADS * 8 <= n
        assert R & (R - 1) == 0 and G % R == 0 and G // R <= R
    assert T._reduce_plan((1 << 15) + 1) == (32, 8)
    assert T._reduce_plan(884736) == (128, 16)


@pytest.mark.parametrize("resident, plan", [
    (264, (128, 16)), (132, (128, 16)), (114, (64, 8)), (57, (32, 8)),
    (8, (8, 4)), (7, (4, 2)), (4, (4, 2)), (3, (0, 0)), (1, (0, 0))])
def test_reduce_plan_capped_by_resident(resident, plan):
    """A plan against ``resident`` blocks (what the card holds at once
    of a cooperative kernel, as the fused DD CG step asks) takes the
    power of two at or below it, or one block below 4, and still adds in
    lis_tpu's order."""
    n = (1 << 18) + 1
    assert T._reduce_plan(n, resident) == plan
    rng = np.random.default_rng(resident)
    x, y = _vec(rng, n, np.float64), _vec(rng, n, np.float64)
    _same(reduce_model(T._DOT, x, y, plan), _port_plain(T._DOT, x, y))


# ---- kernel N ----------------------------------------------------------

def _ell(rng, n, w, dt, lo=False, nan=False):
    """ELL arrays with row lengths from 0 to w (padded at the end with
    index 0 and value 0), as lis_tpu lays them out."""
    idx = rng.integers(0, n, (n, w)).astype(np.int32)
    val = rng.standard_normal((n, w))
    lens = rng.integers(0, w + 1, n)
    lens[0] = w
    pad = np.arange(w)[None, :] >= lens[:, None]
    idx[pad] = 0
    val[pad] = 0.0
    vhi = val.astype(dt)
    vlo = (val - vhi.astype(np.float64)).astype(dt) if lo else None
    return idx, vhi, vlo, _vec(rng, n, dt, nan)


def ell_model(idx, val, vlo, x, rows):
    """Kernel N's staged schedule with ``rows`` rows a block
    (``_ell_plan``): pairs p of a block, r = p // h, j = p % h, add terms
    j and j + h of row r (the zero pad where j + h = w); then a thread a
    row adds the rest of the row tree.  rows = 0 is the warp-per-row
    kernel: lis_tpu's tree itself."""
    n, w = val.shape
    dt = val.dtype

    def term(e):
        c = idx.reshape(-1)[e]
        v = val.reshape(-1)[e]
        p, err = two_prod(v, x[0][c])
        err = err + v * x[1][c]
        if vlo is not None:
            err = err + vlo.reshape(-1)[e] * x[0][c]
        return p, err

    if rows == 0:
        h = w
        sh, sl = (a.reshape(n, w) for a in term(np.arange(n * w)))
    else:
        h = (w + 1) // 2
        sh = np.empty((n, h), dt)
        sl = np.empty((n, h), dt)
        for row0 in range(0, n, rows):
            nr = min(rows, n - row0)
            p = np.arange(nr * h)
            r, j = p // h, p % h
            e = (row0 + r) * w + j
            a = term(e)
            if w > 1:
                inb = j + h < w
                b = term(np.where(inb, e + h, 0))
                b = (np.where(inb, b[0], 0).astype(dt),
                     np.where(inb, b[1], 0).astype(dt))
                a = dd_add(a, b)
            sh[row0 + r, j], sl[row0 + r, j] = a
    m = h
    while m > 1:
        valid = m
        m += m & 1
        half = m // 2
        bh = np.zeros((n, half), dt)
        bl = np.zeros((n, half), dt)
        k = valid - half
        bh[:, :k], bl[:, :k] = sh[:, half:valid], sl[:, half:valid]
        sh, sl = dd_add((sh[:, :half], sl[:, :half]), (bh, bl))
        m = half
    return sh[:, 0], sl[:, 0]


def _check_ell(w, dt, n=601, lo=False, nan=False):
    """n = 601 is prime: no plan's rows a block divides it."""
    rng = np.random.default_rng(w)
    idx, val, vlo, x = _ell(rng, n, w, dt, lo, nan)
    es = np.dtype(dt).itemsize
    rows = T._ell_plan(w, es)
    assert rows == (T._ell_rows(w, es) if w <= T._ELL_STAGE_W else 0)
    got = ell_model(idx, val, vlo, x, rows)
    if w <= 128:           # the staged kernel's reach (csrc/dd.cu)
        staged = T._ell_rows(w, es)
        assert 0 < staged <= T._ELL_ROWS
        assert 2 * staged * (((w + 1) // 2) | 1) * es <= T._ELL_STAGE_BYTES
        _same(ell_model(idx, val, vlo, x, staged), got)
    tv = torch.from_numpy
    want = T._ell_plain(tv(idx), tv(val), T.DD(tv(x[0]), tv(x[1])),
                        None if vlo is None else tv(vlo))
    _same(got, (want.hi.numpy(), want.lo.numpy()))
    if w in LIS_TPU_W:
        jw = J.matvec_dd_ell(jnp.asarray(idx), jnp.asarray(val),
                             J.DD(jnp.asarray(x[0]), jnp.asarray(x[1])),
                             None if vlo is None else jnp.asarray(vlo))
        _same(got, (jw.hi, jw.lo))


# the widths also run through lis_tpu (each new width costs it about a
# second of compiles on the CPU); the others are held to the port's plain
# version, which tests/test_torch_quad.py holds to lis_tpu
LIS_TPU_W = {1, 2, 3, 4, 5, 7, 8, 16, 17, 31, 32, 33, 34, 35, 63, 64, 65,
             127, 128, 129, 300}


@pytest.mark.parametrize("w", range(1, 131))
@pytest.mark.parametrize("dt", LIMBS)
def test_ell_schedule(dt, w):
    _check_ell(w, dt, lo=dt == np.float32)


@pytest.mark.parametrize("w", [129, 160, 255, 256, 300])
def test_ell_schedule_long_rows(w):
    _check_ell(w, np.float64)


@pytest.mark.parametrize("w", [1, 2, 33, 34, 128])
def test_ell_schedule_nan(w):
    """x[0] NaN: the padded entries (index 0) carry it into the rows,
    as in lis_tpu."""
    _check_ell(w, np.float64, nan=True)
