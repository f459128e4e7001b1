"""Rank-side code of the distributed parity tests (tests/test_torch_dist*.py).

The test process starts ranks with ``lis_tpu_torch.parallel.RankPool``;
each rank imports this module to run the functions below, and imports
only torch, numpy, scipy and lis_tpu_torch (every function asserts that
jax was never imported in the rank).  The problem builders are plain
scipy, shared with the test process, which feeds the same matrices to
lis_tpu.
"""

import sys
import warnings

import numpy as np
import scipy.sparse as sp


# ---- problems (numpy / scipy only) ------------------------------------------

def _canon(a):
    a = sp.csr_matrix(a)
    a.sum_duplicates()
    a.sort_indices()
    return a


def poisson2d(m, n):
    """The 5-point Laplacian on an m x n grid (4 on the diagonal)."""
    t = lambda k: sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    return _canon(sp.kron(sp.eye(n), t(m)) + sp.kron(t(n), sp.eye(m)))


def tridiag(n, diag=2.0):
    return _canon(sp.diags([-1.0, diag, -1.0], [-1, 0, 1], shape=(n, n)))


def windowed(n=1024, K=10, bw=40, seed=3, sym=False):
    """Random entries within bw of the diagonal, diagonally dominant: the
    sharded BES route."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), K)
    cols = np.clip(rows + rng.integers(-bw, bw + 1, size=n * K), 0, n - 1)
    m = sp.coo_matrix((rng.standard_normal(n * K), (rows, cols)),
                      shape=(n, n)).tocsr()
    if sym:
        return _canon(m + m.T + sp.diags(np.abs(m).sum(axis=1).A1 * 2 + 1))
    return _canon(m + sp.diags(np.abs(m).sum(axis=1).A1 + 1))


def two_bands(n=4000, far=2500, seed=7):
    """Half the entries near the diagonal, half near +far: multi-BES, the
    far band read from shards two and three away."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 8)
    off = np.where(rng.random(n * 8) < 0.5,
                   rng.integers(-40, 41, size=n * 8),
                   far + rng.integers(-40, 41, size=n * 8))
    cols = np.clip(rows + off, 0, n - 1)
    m = sp.coo_matrix((rng.standard_normal(n * 8), (rows, cols)),
                      shape=(n, n)).tocsr()
    return _canon(m + sp.diags(np.abs(m).sum(axis=1).A1 + 1))


def random_sym(n, k, seed):
    """Locality-free symmetric, diagonally shifted: the comm-table and CST
    routes."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, size=n * k)
    a = sp.coo_matrix((rng.standard_normal(n * k), (rows, cols)),
                      shape=(n, n)).tocsr()
    return _canon(a + a.T + sp.eye(n) * (4 * k))


def table_general(n=1200, seed=3):
    rng = np.random.default_rng(seed)
    return _canon(sp.random(n, n, density=0.008, random_state=rng)
                  + 20 * sp.eye(n))


def table_sparse_links(seed=5):
    """poisson2d(40, 40) and 100 long-range couplings of 0.01."""
    rng = np.random.default_rng(seed)
    m = poisson2d(40, 40)
    r, c = rng.integers(0, 1600, 50), rng.integers(0, 1600, 50)
    return _canon(m + sp.coo_matrix((np.full(50, 0.01), (r, c)),
                                    shape=m.shape)
                  + sp.coo_matrix((np.full(50, 0.01), (c, r)),
                                  shape=m.shape))


def quasi_banded():
    n = 400
    return _canon(poisson2d(20, 20)
                  + sp.random(n, n, density=0.001, random_state=7))


def complex_tri(n=512):
    return _canon(sp.diags([-(1 + 0.5j), 4 + 1j, -(1 - 0.25j)], [-1, 0, 1],
                           shape=(n, n)))


def wide_band(n=600, hw=57, seed=2):
    """A symmetric band whose outermost diagonals (±hw) reach both ends
    of the global range: the ring-wrap check."""
    rng = np.random.default_rng(seed)
    offs = [-hw, -5, -1, 0, 1, 5, hw]
    diags = [rng.standard_normal(n - abs(o)) for o in offs]
    a = sp.diags(diags, offs, shape=(n, n))
    return _canon(a + a.T + sp.eye(n) * 10)


PROBLEMS = {
    "p2d20": lambda: poisson2d(20, 20),
    "p2d13x11": lambda: poisson2d(13, 11),
    "p2d13x7": lambda: poisson2d(13, 7),
    "p2d11x9": lambda: poisson2d(11, 9),
    "p2d18": lambda: poisson2d(18, 18),
    "p2d24": lambda: poisson2d(24, 24),
    "p2d48": lambda: poisson2d(48, 48),
    "tri100d3": lambda: tridiag(100, 3.0),
    "tri173": lambda: tridiag(173),
    "tri120d4": lambda: tridiag(120, 4.0),
    "tri400d4": lambda: tridiag(400, 4.0),
    "bes1024": lambda: windowed(),
    "mbes4000": two_bands,
    "table1200": table_general,
    "links1600": table_sparse_links,
    "hybrid400": quasi_banded,
    "cplx512": complex_tri,
    "cst960": lambda: random_sym(960, 8, 11),
    "rand480": lambda: random_sym(480, 6, 3),
    "band600": wide_band,
}


def problem(name):
    return PROBLEMS[name]()


# ---- rank side --------------------------------------------------------------

def _no_jax():
    assert "jax" not in sys.modules, "a rank imported jax"


def _port_matrix(a):
    from lis_tpu_torch.matrix.csr import CSRMatrix
    return CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape,
                                     device="cpu")


def distribute(mesh, name, layout):
    from lis_tpu_torch import parallel as P
    A = _port_matrix(problem(name))
    if layout == "route":
        return P.distribute_matrix(A, mesh)
    if layout in ("gather", "neighbor", "table", "auto"):
        return P.distribute_csr(A, mesh, halo=layout)
    if layout == "dia":
        return P.distribute_dia(A, mesh)
    if layout == "cst":
        return P.distribute_csr_cst(A, mesh)
    raise ValueError(layout)


def products(mesh, name, layout, x):
    """(class name, A·x, Aᴴ·x) gathered to length gn."""
    from lis_tpu_torch.parallel import distribute_vector
    _no_jax()
    Ad = distribute(mesh, name, layout)
    xl = distribute_vector(x, mesh, Ad.gn_pad)
    y = mesh.all_gather(Ad.matvec(xl))[: Ad.gn]
    yh = mesh.all_gather(Ad.matvech(xl))[: Ad.gn]
    return type(Ad).__name__, y.numpy(), yh.numpy()


def tables(mesh, name, layout):
    """The rank's comm-table and halo statics and arrays."""
    _no_jax()
    Ad = distribute(mesh, name, layout)
    out = {"type": type(Ad).__name__, "nlocal": Ad.nlocal,
           "gn_pad": Ad.gn_pad, "hw": getattr(Ad, "hw", None)}
    if hasattr(Ad, "exports"):
        out.update(dists=Ad.dists, exp_lens=Ad.exp_lens, G=Ad.G,
                   exports=[e.numpy() for e in Ad.exports],
                   ghost_gids=Ad.ghost_gids.numpy(),
                   comm_elems=Ad.comm_elems)
    return out


def solve(mesh, name, layout, b, options, x0=None):
    """dist_solve on the rank's shard: status, count, x, the true residual,
    the layout and the warnings it raised."""
    from lis_tpu_torch.parallel import dist_solve
    _no_jax()
    Ad = distribute(mesh, name, layout)
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        r = dist_solve(Ad, b, mesh, options=options, x0=x0)
    return {"status": r.status, "iters": r.iters, "x": r.x.numpy(),
            "true_resid": r.true_resid, "type": type(Ad).__name__,
            "warnings": [str(w.message) for w in got]}


def on_first(mesh, k, fn, *args):
    """fn on the mesh of the first k ranks (None on the others): one pool
    serves several mesh widths."""
    sub = mesh.first(k)
    return None if sub is None else fn(sub, *args)


def esolve(mesh, name, layout, options, bname=None):
    """dist_esolve on the rank's shard (with B, problem ``bname``, in the
    same layout): the result's fields, the layout and this rank's
    collectives."""
    from lis_tpu_torch.parallel import dist_esolve
    _no_jax()
    Ad = distribute(mesh, name, layout)
    Bd = None if bname is None else distribute(mesh, bname, layout)
    mesh.reset_counts()
    r = dist_esolve(Ad, mesh, options=options, B=Bd)
    return {"status": r.status, "iters": r.iters, "evalue": r.evalue,
            "evalues": r.evalues, "iters_all": r.iters_all,
            "resids_all": r.resids_all, "evector": r.evector.numpy(),
            "evectors": r.evectors, "rhistory": r.rhistory,
            "type": type(Ad).__name__, "coll": dict(mesh.counts)}


def roundtrip(mesh, name):
    """undistribute_csr of a neighbour-halo shard, then a redistributed
    (gather halo) CG solve."""
    from lis_tpu_torch import parallel as P
    _no_jax()
    Ad = distribute(mesh, name, "auto")
    g = P.undistribute_csr(Ad)
    Ad2 = P.redistribute_csr(Ad, mesh, halo="gather")
    r = P.dist_solve(Ad2, np.ones(Ad.gn), mesh, options="-i cg -tol 1e-10")
    p_, i_, v_ = g.to_csr_arrays()
    return p_, i_, v_, Ad2.halo, r.status, r.iters, r.x.numpy()


def saamg_mid(mesh, name, options):
    """The distributed SA-AMG's mid levels: (n, nloc, slab nnz) each."""
    from lis_tpu_torch.parallel.dist_precon import make_dist_saamg
    from lis_tpu_torch.runtime.options import SolverOptions
    _no_jax()
    Ad = distribute(mesh, name, "route")
    M = make_dist_saamg(Ad, mesh, SolverOptions.from_string(options))
    return [(m.n, m.nloc, int(m.A.value.numel())) for m in M.mids]


def devices(mesh, name):
    """Where the rank's default device, its mesh, a shard and the solution
    of a dist_solve given no device argument live."""
    from lis_tpu_torch import parallel as P
    from lis_tpu_torch.config import default_device
    from lis_tpu_torch.utils.testmat import poisson2d as t_poisson2d
    _no_jax()
    A = t_poisson2d(12, 12)                 # no device: the default
    Ad = P.distribute_matrix(A, mesh)
    r = P.dist_solve(Ad, np.ones(A.nrows), mesh, options="-i cg -tol 1e-8")
    return (str(default_device()), str(mesh.device), str(Ad.value.device),
            str(r.x.device), r.status)


def state_products(mesh, triple, x):
    """(class name, A·x, Aᴴ·x) of the shard from_numpy_state builds from
    lis_tpu's leaves."""
    from lis_tpu_torch.interop.state import from_numpy_state
    from lis_tpu_torch.parallel import distribute_vector
    _no_jax()
    Ad = from_numpy_state(*triple, mesh=mesh)
    xl = distribute_vector(x, mesh, Ad.gn_pad)
    y = mesh.all_gather(Ad.matvec(xl))[: Ad.gn]
    yh = mesh.all_gather(Ad.matvech(xl))[: Ad.gn]
    return type(Ad).__name__, y.numpy(), yh.numpy()
