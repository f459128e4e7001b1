"""lis_tpu's side of the distributed parity tests: the same problems
(tests/_torch_dist_ranks.py) distributed over a mesh of the conftest's
virtual CPU devices, as tests/test_dist.py runs them."""

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from lis_tpu.matrix.csr import CSRMatrix as JCSR
from lis_tpu.parallel import dist as jd
from lis_tpu.parallel.mesh import AXIS, make_mesh
from lis_tpu_torch.parallel import RankPool
from tests._torch_dist_ranks import problem, solve as rank_solve

WAIT = 120.0          # seconds any call on the ranks may take
_MESH = {}


@pytest.fixture(scope="module")
def pools():
    """get(p): a pool of p spawned gloo ranks on the CPU, started at first
    use and kept for the module."""
    made = {}

    def get(p):
        if p not in made:
            made[p] = RankPool(p, device="cpu", timeout=WAIT)
        return made[p]
    yield get
    for pool in made.values():
        pool.close()


def same_solve(t, j, band=0, xtol=1e-10):
    """Status equal, count within ``band``, x to ``xtol`` (relative to
    max |x|); a step apart, the two x differ by the last step's
    correction, and both are held to the solution's accuracy (1e-7)."""
    assert t["status"] == j["status"], (t["status"], j["status"])
    assert abs(t["iters"] - j["iters"]) <= band, (t["iters"], j["iters"])
    if t["iters"] != j["iters"]:
        xtol = max(xtol, 1e-7)
    scale = max(np.abs(j["x"]).max(), 1.0)
    np.testing.assert_allclose(t["x"], j["x"], rtol=0, atol=xtol * scale)
    assert np.isfinite(t["true_resid"])


def both(pools, name, layout, p, options, b=None, band=0, xtol=1e-10):
    """The same dist_solve in the port's p ranks and in lis_tpu on a mesh
    of p devices, held to each other (``same_solve``)."""
    a = problem(name)
    b = np.ones(a.shape[0]) if b is None else b
    t = pools(p).run(rank_solve, name, layout, b, options, timeout=WAIT)
    j = solve(name, layout, p, b, options)
    assert t["type"] == j["type"], (t["type"], j["type"])
    same_solve(t, j, band, xtol)
    return t, j


def mesh(p):
    if p not in _MESH:
        _MESH[p] = make_mesh(p)
    return _MESH[p]


def matrix(name):
    a = problem(name)
    return JCSR.from_csr_arrays(a.indptr, a.indices, a.data, a.shape)


def distribute(name, layout, p):
    A, m = matrix(name), mesh(p)
    if layout == "route":
        return jd.distribute_matrix(A, m)
    if layout in ("gather", "neighbor", "table", "auto"):
        return jd.distribute_csr(A, m, halo=layout)
    if layout == "dia":
        return jd.distribute_dia(A, m)
    if layout == "cst":
        return jd.distribute_csr_cst(A, m)
    raise ValueError(layout)


def products(name, layout, p, x):
    Ad, m = distribute(name, layout, p), mesh(p)
    xd = jd.distribute_vector(x, m, Ad.gn_pad)
    spec = (jax.tree.map(lambda _: P(AXIS), Ad), P(AXIS))
    f = jd._shard_map(lambda A, v: A.matvec(v), m, spec, P(AXIS))
    fh = jd._shard_map(lambda A, v: A.matvech(v), m, spec, P(AXIS))
    n = Ad.gn
    return (type(Ad).__name__, np.asarray(jax.jit(f)(Ad, xd))[:n],
            np.asarray(jax.jit(fh)(Ad, xd))[:n])


def solve(name, layout, p, b, options, x0=None):
    Ad = distribute(name, layout, p)
    r = jd.dist_solve(Ad, b, mesh(p), options=options, x0=x0)
    return {"status": r.status, "iters": r.iters,
            "x": np.asarray(r.x)[: Ad.gn], "true_resid": r.true_resid,
            "type": type(Ad).__name__}


def esolve(name, layout, p, options, bname=None):
    """lis_tpu's dist_esolve of problem ``name`` (and B ``bname``) in
    ``layout`` on a mesh of p devices."""
    from lis_tpu.parallel.dist_esolve import dist_esolve
    Ad = distribute(name, layout, p)
    Bd = None if bname is None else distribute(bname, layout, p)
    r = dist_esolve(Ad, mesh(p), options=options, B=Bd)
    return {"status": r.status, "iters": r.iters, "evalue": r.evalue,
            "evalues": np.asarray(r.evalues),
            "iters_all": np.asarray(r.iters_all),
            "evector": np.asarray(r.evector)[: Ad.gn],
            "evectors": np.asarray(r.evectors)[:, : Ad.gn],
            "type": type(Ad).__name__}


def state(Ad):
    """A lis_tpu distributed matrix as the (kind, arrays, statics) triple
    of lis_tpu_torch's from_numpy_state: leaves as numpy arrays, every
    shard stacked."""
    from tests.test_torch_cst import to_state
    a = lambda v: np.asarray(v)
    base = {"nlocal": Ad.nlocal, "gn": Ad.gn, "gn_pad": Ad.gn_pad,
            "nprocs": Ad.nprocs}
    if isinstance(Ad, jd.DistHybridMatrix):
        return ("dist_hybrid", {"dia": state(Ad.dia), "rem": state(Ad.rem)},
                base)
    if isinstance(Ad, jd.DistDIAMatrix):
        return ("dist_dia", {"value": [a(v) for v in Ad.value]},
                dict(base, offsets=Ad.offsets, hw=Ad.hw))
    if isinstance(Ad, jd.DistBESMatrix):
        return ("dist_bes", {"slab": a(Ad.slab),
                             "rem": None if Ad.rem is None else state(Ad.rem)},
                dict(base, R=Ad.R, W=Ad.W, c0=Ad.c0))
    table = dict(base, dists=Ad.dists, exp_lens=Ad.exp_lens, G=Ad.G) \
        if hasattr(Ad, "exports") else None
    common = {"ghost_gids": a(Ad.ghost_gids),
              "exports": [a(e) for e in Ad.exports]} if table else None
    if isinstance(Ad, jd.DistTableCSRMatrix):
        return ("dist_table_csr", dict(common, **{
            n: a(getattr(Ad, n)) for n in ("value", "lidx", "row_ids",
                                           "value_b", "lidx_b",
                                           "row_ids_b")}), table)
    if isinstance(Ad, jd.DistCSTMatrix):
        arrays = {n: a(getattr(Ad, n)) for n in (
            "rem_val", "rem_lidx", "rem_rows", "art_val", "art_lidx",
            "art_rows", "bnd_val", "bnd_lidx", "bnd_rows")}
        return ("dist_cst", dict(common, cst=to_state(Ad.cst),
                                 at_cst=to_state(Ad.at_cst), **arrays),
                table)
    return ("dist_csr", {n: a(getattr(Ad, n))
                         for n in ("value", "index", "row_ids")},
            dict(base, halo=Ad.halo, hw=Ad.hw))
