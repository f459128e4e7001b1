"""The compact form of a BES slab (``BESPack``), which kernels Q and R
read on the card, on the CPU:

- scattered back, it equals the slab exactly, for the routed
  ``bes_small`` and ``bes_large`` matrices, strided, complex, 16-bit
  offset and remainder slabs, each part of a three-band multi-BES and the
  SA-AMG graph path's prolongators;
- Q's lists run in increasing w and R's in increasing r, and every pad
  lies past its list's length, 0 at offset 0;
- scaling, a cast to f32 and back, and the state rebuild from lis_tpu's
  leaves keep it equal to one derived afresh from the slab;
- the router builds none for its candidates, so a refused one has none;
- a reading of the lists in torch (the kernels' sums, term by term)
  equals the plain versions ``_spmv_plain`` / ``_spmvh_plain`` and
  lis_tpu's products to 1e-14 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lis_tpu_torch
from lis_tpu.matrix.bes import BESMatrix as JBES
from lis_tpu_torch.interop.state import from_numpy_state
from lis_tpu_torch.matrix import bes as tb
from lis_tpu_torch.precon import saamg as ts
from lis_tpu_torch.runtime.options import SolverOptions as TOptions
from lis_tpu_torch.solvers import driver as tdrv
from tests.test_torch_bes import cplx, prolongator, stencil7, with_far
from tests.test_torch_route import windowed


def _csr_args(a):
    return a.indptr, a.indices, a.data, a.shape


def _routed(a):
    T = lis_tpu_torch.CSRMatrix.from_csr_arrays(*_csr_args(a), device="cpu")
    B = tdrv.auto_storage(T, need_at=False)
    assert B.format_name == "bes"
    return B


def three_bands(n=1 << 14, seed=1):
    """Entries near the diagonal and n/4 either side of it: a multi-BES of
    three parts (as chip_smoke.py's, at a CPU size)."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 6)
    band = np.tile([-(n // 4), -(n // 4), 0, 0, n // 4, n // 4], n)
    cols = np.clip(rows + band + rng.integers(-40, 40, 6 * n), 0, n - 1)
    a = (sp.coo_matrix((rng.standard_normal(6 * n), (rows, cols)),
                       shape=(n, n)) + 30 * sp.eye(n)).tocsr()
    a.sort_indices()
    return a


def _bes(a, **kw):
    return tb.BESMatrix.from_csr_arrays(*_csr_args(a), device="cpu", **kw)


SLABS = {
    "bes_small": lambda: (_routed(windowed(4000, 30)),),
    "bes_large": lambda: (_routed(windowed(1 << 15, 40)),),
    "strided": lambda: (_bes(prolongator()),),
    "complex": lambda: (_bes(cplx(windowed(2000, 30))),),
    "remainder": lambda: (_bes(with_far()),),
    "W16": lambda: (_bes(windowed(2000, 30), W=512),),
    "R16": lambda: (_bes(windowed(3000, 40), R=512),),
    "three_bands": lambda: tb.multi_bes_from_csr(
        *_csr_args(three_bands()), device="cpu").parts,
    "stencil7": lambda: tb.multi_bes_from_csr(
        *_csr_args(stencil7(16)), device="cpu", w_max=256).parts,
}


def _entries(val, off, lens, ptr, A):
    """Every slot of one side's lists: (tile, list index a, position k in
    the list, value, offset, inside its list's length)."""
    ns = -(-A // tb.SLICE)
    p = torch.arange(val.numel())
    g = torch.searchsorted(ptr, p, right=True) - 1
    rel = p - ptr[g]
    k = rel // tb.SLICE
    t, a = g // ns, g % ns * tb.SLICE + rel % tb.SLICE
    inside = (a < A) & (k < lens.long()[(t * A + a).clamp(max=len(lens) - 1)])
    return t, a, k, val, off.long(), inside


def unpack(P):
    """The slab that Q's lists and R's lists each scatter back to, with
    the checks of order and padding on the way."""
    T, W, R = P.T, P.W, P.R
    out = []
    for val, off, lens, ptr, A, B, rows in (
            (P.qval, P.qoff, P.qlen, P.qptr, R, W, True),
            (P.hval, P.hoff, P.hlen, P.hptr, W, R, False)):
        t, a, k, v, o, inside = _entries(val, off, lens, ptr, A)
        # pads: past the length, 0 at offset 0; entries: no exact zero
        assert not v[~inside].any() and not o[~inside].any()
        assert v[inside].ne(0).all()
        assert (o[inside] < B).all()
        # each list strictly increasing in its offset
        later = inside & (k > 0)
        idx = torch.nonzero(later).squeeze(1)
        assert (o[idx] > o[idx - tb.SLICE]).all()
        slab = torch.zeros(T, W, R, dtype=val.dtype)
        hits = torch.zeros(T, W, R, dtype=torch.int64)
        t, a, v, o = t[inside], a[inside], v[inside], o[inside]
        w, r = (o, a) if rows else (a, o)
        slab.index_put_((t, w, r), v, accumulate=True)
        hits.index_put_((t, w, r), torch.ones_like(t), accumulate=True)
        assert hits.max() <= 1
        # a slice is as wide as its longest list
        ns = -(-A // tb.SLICE)
        padded = torch.zeros(T, ns * tb.SLICE, dtype=torch.int64)
        padded[:, :A] = lens.long().view(T, A)
        assert torch.equal((ptr[1:] - ptr[:-1]) // tb.SLICE,
                           padded.view(-1, tb.SLICE).amax(dim=1))
        out.append(slab)
    return out


def same_pack(P, Q):
    for f in ("qval", "qoff", "qlen", "qptr", "hval", "hoff", "hlen", "hptr"):
        u, v = getattr(P, f), getattr(Q, f)
        assert u.dtype == v.dtype and torch.equal(u, v), f
    assert (P.T, P.W, P.R) == (Q.T, Q.W, Q.R)


@pytest.mark.parametrize("name", list(SLABS))
def test_compact_form_scatters_back_to_the_slab(name):
    if name == "three_bands":
        assert len(SLABS[name]()) >= 3
    for B in SLABS[name]():
        P = B.pack
        assert P is not None and (P.T, P.W, P.R) == tuple(B.slab.shape)
        assert P.qoff.dtype == (torch.uint8 if B.W <= 256 else torch.int16)
        assert P.hoff.dtype == (torch.uint8 if B.R <= 256 else torch.int16)
        assert P.qval.dtype == P.hval.dtype == B.slab.dtype
        for slab in unpack(P):
            assert torch.equal(slab, B.slab)
        assert P.qval.numel() >= B.nnz - (0 if B.rem is None else B.rem.nnz)


def test_saamg_graph_prolongators_carry_their_compact_form():
    """The graph path's multi-BES prolongators (those of
    test_torch_bes.test_saamg_graph_prolongators_are_multi_bes_as_in_lis_tpu)
    each carry a compact form that scatters back to their slab."""
    from tests.test_torch_precon import _scipy
    a = _scipy("poisson3d27", 12, 12, 12)
    T = lis_tpu_torch.CSRMatrix.from_csr_arrays(*_csr_args(a), device="cpu")
    M = ts.create_saamg(T, TOptions.from_string("-saamg_lattice false"))
    parts = [q for lv in M.levels if lv.P.format_name in ("bes", "mbes")
             for q in getattr(lv.P, "parts", (lv.P,))]
    assert parts
    for q in parts:
        for slab in unpack(q.pack):
            assert torch.equal(slab, q.slab)


def test_an_empty_tile_and_an_empty_slab():
    rng = np.random.default_rng(2)
    slab = torch.from_numpy(rng.standard_normal((3, 256, 128)))
    slab[1] = 0                                 # an all-zero tile
    slab[2, :, 5] = 0                           # an empty row
    slab[0, 7, :] = 0                           # an empty window column
    slab[0].masked_fill_(torch.from_numpy(rng.random((256, 128)) < 0.9), 0)
    P = tb.bes_pack(slab)
    assert P.qptr[8] == P.qptr[4] and P.hptr[16] == P.hptr[8]
    assert P.qlen[2 * 128 + 5] == 0 and P.hlen[7] == 0
    for got in unpack(P):
        assert torch.equal(got, slab)
    E = tb.bes_pack(torch.zeros(0, 256, 128))
    assert E.qval.numel() == E.hval.numel() == 0
    assert E.qptr.tolist() == E.hptr.tolist() == [0]
    with pytest.raises(ValueError, match="W = 32768"):
        tb.bes_pack(torch.zeros(1, 32768, 1))


def test_compact_form_follows_scaling_casts_and_the_state_rebuild():
    """Every path that makes a slab leaves a compact form equal to one
    derived afresh from it."""
    def fresh(B):
        same_pack(B.pack, tb.bes_pack(B.slab))

    B = _routed(windowed(4000, 30))
    s = torch.from_numpy(np.abs(np.random.default_rng(3).standard_normal(
        B.nrows)) + 0.5)
    for S in (B.scale_rows(s), B.scale_symm(s)):
        assert not torch.equal(S.slab, B.slab)
        fresh(S)
    d = s.clone()
    d[:300] = 0                                 # whole rows fall out
    S = B.scale_rows(d)
    fresh(S)
    assert S.pack.qval.numel() < B.pack.qval.numel()
    B32 = B.to(dtype=torch.float32)
    assert B32.pack.qval.dtype == torch.float32
    assert B32.pack.qoff.dtype == torch.uint8   # offsets are not cast
    fresh(B32)
    fresh(B32.to(dtype=torch.float64))
    M = tb.multi_bes_from_csr(*_csr_args(three_bands()), device="cpu")
    for S in (M.scale_rows(torch.ones(M.nrows) * 2), M.scale_symm(
            torch.ones(M.nrows) * 2), M.to(dtype=torch.float32)):
        for q in S.parts:
            fresh(q)
    J = JBES.from_csr_arrays(*_csr_args(with_far()))
    R = from_numpy_state(
        "bes", {"slab": np.asarray(J.slab), "rem": None},
        {k: getattr(J, k) for k in ("nrows", "ncols", "nnz", "R", "W", "c0",
                                    "stride")}, device="cpu")
    fresh(R)
    assert torch.equal(R.slab, torch.from_numpy(np.array(J.slab)))


def test_router_candidates_carry_no_compact_form(monkeypatch):
    """The router builds its BES candidate on the host without the compact
    form: a refused one never derives it, an accepted one derives it when
    it moves to the matrix's device."""
    calls = []
    real = tb.bes_pack
    monkeypatch.setattr(tb, "bes_pack",
                        lambda slab: calls.append(slab.shape) or real(slab))
    rng = np.random.default_rng(4)
    n = 3000
    far = sp.random(n, n, density=6 / n, random_state=rng, format="csr") \
        + sp.eye(n)
    assert tdrv._bes_candidate(*_csr_args(far.tocsr())) == (None, 0.0)
    a = windowed(4000, 30)
    cand, rate = tdrv._bes_candidate(*_csr_args(a))
    assert cand.pack is None and rate > 0
    assert calls == []
    assert cand.to("cpu").pack is not None and len(calls) == 1
    far_bes = tb.multi_bes_from_csr(*_csr_args(far.tocsr()), compact=False)
    assert all(q.pack is None for q in getattr(far_bes, "parts", (far_bes,)))
    assert len(calls) == 1


def read_q(B, x):
    """Q over the compact lists, term by term in torch."""
    P = B.pack
    t, r, _, v, w, inside = _entries(P.qval, P.qoff, P.qlen, P.qptr, P.R)
    t, r, v, w = t[inside], r[inside], v[inside], w[inside]
    dt = torch.promote_types(v.dtype, x.dtype)
    j = t * B.s + B.c0 + w
    ok = (j >= 0) & (j < B.ncols)
    y = torch.zeros(P.T * P.R, dtype=dt)
    y.index_add_(0, (t * P.R + r)[ok], v[ok].to(dt) * x.to(dt)[j[ok]])
    return y[:B.nrows]


def read_r(B, x):
    """R over the compact lists, term by term in torch."""
    P = B.pack
    t, w, _, v, r, inside = _entries(P.hval, P.hoff, P.hlen, P.hptr, P.W)
    t, w, v, r = t[inside], w[inside], v[inside], r[inside]
    dt = torch.promote_types(v.dtype, x.dtype)
    row = t * P.R + r
    j = t * B.s + B.c0 + w
    ok = (row < B.nrows) & (j >= 0) & (j < B.ncols)
    y = torch.zeros(B.ncols, dtype=dt)
    v = v[ok].to(dt)
    y.index_add_(0, j[ok], (v.conj() if v.is_complex() else v)
                 * x.to(dt)[row[ok]])
    return y


def _rel(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


READS = [("bes_small", False), ("strided", False), ("complex", False),
         ("complex", True), ("bes_small", True), ("W16", False),
         ("R16", False), ("three_bands", False)]


@pytest.mark.parametrize("name,x_complex", READS,
                         ids=[f"{n}-{'c' if c else 'r'}" for n, c in READS])
def test_reading_the_lists_gives_the_plain_products(name, x_complex):
    """The kernels' sums over the lists (the slab's nonzeros) against the
    plain versions over the dense slab, to 1e-14 relative; a complex x on
    a real slab keeps its imaginary part."""
    rng = np.random.default_rng(5)
    for B in SLABS[name]():
        n, m = B.nrows, B.ncols
        x = torch.from_numpy(rng.standard_normal(m))
        y = torch.from_numpy(rng.standard_normal(n))
        if x_complex:
            x = x + 1j * torch.from_numpy(rng.standard_normal(m))
            y = y + 1j * torch.from_numpy(rng.standard_normal(n))
        want_q = tb._spmv_plain(B.slab, x, B.c0, B.s, n, m)
        want_r = tb._spmvh_plain(B.slab, y, B.c0, B.s, n, m)
        got_q, got_r = read_q(B, x), read_r(B, y)
        assert got_q.dtype == want_q.dtype and got_r.dtype == want_r.dtype
        assert _rel(got_q, want_q) <= 1e-14
        assert _rel(got_r, want_r) <= 1e-14


def test_reading_the_routed_lists_gives_lis_tpus_products():
    """The routed bes_small: the lists' reading against lis_tpu's matvec
    and matvech of the same slab (real x: lis_tpu casts x to the slab's
    type)."""
    a = windowed(4000, 30)
    B = _routed(a)
    J = JBES.from_csr_arrays(*_csr_args(a))
    assert (B.W, B.c0) == (J.W, J.c0)
    rng = np.random.default_rng(6)
    x, y = rng.standard_normal(4000), rng.standard_normal(4000)
    assert _rel(read_q(B, torch.from_numpy(x)),
                torch.from_numpy(np.array(J.matvec(jnp.asarray(x))))) \
        <= 1e-14
    assert _rel(read_r(B, torch.from_numpy(y)),
                torch.from_numpy(np.array(J.matvech(jnp.asarray(y))))) \
        <= 1e-14
