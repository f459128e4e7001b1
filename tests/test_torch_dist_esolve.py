"""The distributed eigensolvers in both packages, on the CPU: the port's
``dist_esolve`` in 4 spawned gloo ranks (and, for padded shards, on the
first 3 of them) held to lis_tpu's ``dist_esolve`` on a mesh of the same
width, on poisson2d(20, 20) routed to DIA and on the BES, comm-table CSR
and per-rank CST shards of tests/test_torch_dist.py.

Tolerances: pi, ii, cg and cr: status equal, counts within 2 (the band
tests/test_dist.py allows against one device), the eigenvalue to 1e-10
relative, the eigenvector to 1e-8 after aligning the sign; rqi: the
eigenpair's residual under 1e-6 and the eigenvalue to 1e-8; li and ai:
status equal, eigenvalues to rtol 1e-8; si: its first pair as lis_tpu's,
the later pairs held to the port's serial esolve and to the spectrum
(lis_tpu starts them from rounding noise, ROADMAP.md queue 3); gii,
grqi, gcg, gcr and the capped gpi: counts equal, the eigenvalue to 1e-8;
gli, gai and gsi: held to the port's serial gesolve on the same pencil
(counts equal, eigenvalues to rtol 1e-8; lis_tpu's distributed run of
these takes minutes here).  Every case also holds that each rank
returned the same eigenvalues, counts and whole eigenvectors.

lis_tpu's side of each case is computed once (``_lis``).  Every wait on
the ranks is bounded (tests/_torch_dist_jax.py).
"""

import functools

import numpy as np
import pytest

import lis_tpu_torch
import tests._torch_dist_jax as J
import tests._torch_dist_ranks as R
from tests._torch_dist_jax import WAIT, pools  # noqa: F401 (a fixture)

PENCIL = "tri400d4"          # B of the generalized cases: tridiag(4, -1)


def _run(pools, p, name, layout, options, bname=None):
    """The port's dist_esolve on p of the pool's 4 ranks; every rank's
    result held equal to rank 0's, which is returned."""
    outs = [o for o in pools(4).run_all(R.on_first, p, R.esolve, name, layout,
                                        options, bname, timeout=WAIT)
            if o is not None]
    assert len(outs) == p
    t = outs[0]
    for o in outs[1:]:
        assert o["evalue"] == t["evalue"] and o["iters"] == t["iters"]
        assert o["status"] == t["status"]
        assert np.array_equal(o["evalues"], t["evalues"])
        assert np.array_equal(o["iters_all"], t["iters_all"])
        assert np.array_equal(o["evectors"], t["evectors"])
        assert np.array_equal(o["evector"], t["evector"])
    assert t["evector"].shape == (R.problem(name).shape[0],)
    return t


@functools.lru_cache(maxsize=None)
def _lis(name, layout, p, options, bname=None):
    return J.esolve(name, layout, p, options, bname)


def _serial(name, options, bname=None):
    """The port's serial gesolve of the same problem on the CPU."""
    from tests._torch_dist_ranks import _port_matrix
    A = _port_matrix(R.problem(name))
    B = None if bname is None else _port_matrix(R.problem(bname))
    return lis_tpu_torch.gesolve(A, B, options=options)


def _aligned(a, b):
    """a with its sign turned to b's."""
    return a if np.dot(a, b) >= 0 else -a


def _same_pair(t, j, band=2, evtol=1e-10, xtol=1e-8):
    assert t["status"] == j["status"], (t["status"], j["status"])
    assert abs(t["iters"] - j["iters"]) <= band, (t["iters"], j["iters"])
    assert abs(t["evalue"] - j["evalue"]) <= evtol * abs(j["evalue"])
    np.testing.assert_allclose(_aligned(t["evector"], j["evector"]),
                               j["evector"], rtol=0, atol=xtol)


def _pair_resid(name, lam, x, bname=None):
    a = R.problem(name)
    bx = x if bname is None else R.problem(bname) @ x
    return np.linalg.norm(a @ x - lam * bx) / (abs(lam) * np.linalg.norm(x))


# ---- the device-loop families -----------------------------------------------

@pytest.mark.parametrize("p", [4, 3])
@pytest.mark.parametrize("es", ["pi", "ii", "cg", "cr"])
def test_power_and_cgcr_families_match(pools, es, p):
    opts = f"-e {es} -etol 1e-8 -emaxiter 2000"
    t = _run(pools, p, "p2d20", "route", opts)
    assert t["type"] == "DistDIAMatrix"
    _same_pair(t, _lis("p2d20", "route", p, opts))
    assert t["status"] == lis_tpu_torch.LIS_SUCCESS


@pytest.mark.parametrize("p", [4, 3])
def test_rqi_converges_to_lis_tpus_pair(pools, p):
    """RQI's count rests on rounding (tests/test_dist.py:255-266): its
    eigenpair is held, with the inner MINRES of the parity runs."""
    opts = "-e rqi -i minres -etol 1e-8 -emaxiter 200"
    t = _run(pools, p, "p2d20", "route", opts)
    j = _lis("p2d20", "route", p, opts)
    assert t["status"] == j["status"] == lis_tpu_torch.LIS_SUCCESS
    assert _pair_resid("p2d20", t["evalue"], t["evector"]) <= 1e-6
    assert abs(t["evalue"] - j["evalue"]) <= 1e-8 * abs(j["evalue"])


def test_ii_shift_on_the_dia(pools):
    """-shift on the sharded DIA: II finds the eigenvalue nearest σ."""
    target = float(np.linalg.eigvalsh(R.problem("p2d20").toarray())[0])
    opts = f"-e ii -shift {target - 0.01} -etol 1e-8"
    t = _run(pools, 4, "p2d20", "route", opts)
    _same_pair(t, _lis("p2d20", "route", 4, opts))
    assert abs(t["evalue"] - target) < 1e-6


# ---- the subspace families --------------------------------------------------

@pytest.mark.parametrize("es,p,refine", [("li", 4, True), ("ai", 4, False),
                                         ("li", 3, False)])
def test_lanczos_and_arnoldi_match(pools, es, p, refine):
    """Lanczos with its Ritz pairs refined by II (``-rval false``), and
    Arnoldi and Lanczos on the padded shards of 3 ranks as raw Ritz
    pairs."""
    opts = f"-e {es} -ss 3 -i minres -tol 1e-10 -etol 1e-8 -emaxiter 60" + (
        "" if refine else " -rval true")
    t = _run(pools, p, "p2d20", "route", opts)
    j = _lis("p2d20", "route", p, opts)
    assert t["status"] == j["status"]
    assert np.array_equal(t["iters_all"], j["iters_all"])
    np.testing.assert_allclose(t["evalues"], j["evalues"], rtol=1e-8)
    assert t["evectors"].shape == (3, 400)


def test_subspace_iteration(pools):
    """The first pair as lis_tpu's (pair 1 does not depend on -ss, so
    lis_tpu runs -ss 1); pair 2 from the port's global seeded start, as
    its serial esolve finds it, on the spectrum."""
    opts = "-e si -ss 2 -i cg -tol 1e-10 -etol 1e-8 -emaxiter 60"
    t = _run(pools, 4, "p2d20", "route", opts)
    j = _lis("p2d20", "route", 4, opts.replace("-ss 2", "-ss 1"))
    s = _serial("p2d20", opts)
    assert t["status"] == s.status == lis_tpu_torch.LIS_SUCCESS
    assert abs(t["iters_all"][0] - j["iters_all"][0]) <= 2
    assert abs(t["evalues"][0] - j["evalues"][0]) <= 1e-10 * j["evalues"][0]
    assert np.all(np.abs(t["iters_all"] - s.iters_all) <= 2)
    np.testing.assert_allclose(t["evalues"], s.evalues, rtol=1e-8)
    spec = np.linalg.eigvalsh(R.problem("p2d20").toarray())
    np.testing.assert_allclose(t["evalues"], spec[[0, 1]], rtol=1e-7)


# ---- the generalized families -----------------------------------------------

def test_gpi_matches(pools):
    """Generalized PI (two nested B-solves an iteration), capped: both
    packages stop at the cap with the same iterate."""
    opts = "-e gpi -i cg -emaxiter 15"
    t = _run(pools, 4, "p2d20", "route", opts, PENCIL)
    j = _lis("p2d20", "route", 4, opts, PENCIL)
    assert t["status"] == j["status"] == lis_tpu_torch.LIS_MAXITER
    assert t["iters"] == j["iters"] == 15
    assert abs(t["evalue"] - j["evalue"]) <= 1e-8 * abs(j["evalue"])
    np.testing.assert_allclose(t["evector"], j["evector"], rtol=0, atol=1e-8)


@pytest.mark.parametrize("opts", ["-e gii -i cg -etol 1e-8",
                                  "-e grqi -etol 1e-8",
                                  "-e gcg -etol 1e-8 -emaxiter 2000",
                                  "-e gcr -i cg -tol 1e-10 -etol 1e-8"])
def test_generalized_loops_match(pools, opts):
    t = _run(pools, 4, "p2d20", "route", opts, PENCIL)
    j = _lis("p2d20", "route", 4, opts, PENCIL)
    assert t["status"] == j["status"] == lis_tpu_torch.LIS_SUCCESS
    assert t["iters"] == j["iters"], (t["iters"], j["iters"])
    assert abs(t["evalue"] - j["evalue"]) <= 1e-8 * abs(j["evalue"])
    assert _pair_resid("p2d20", t["evalue"], t["evector"], PENCIL) < 1e-6


@pytest.mark.parametrize("opts", ["-e gli -ss 2 -rval true",
                                  "-e gai -ss 2 -rval true",
                                  "-e gsi -i cg -etol 1e-8 -emaxiter 300"])
def test_generalized_subspace_matches_serial(pools, opts):
    t = _run(pools, 4, "p2d20", "route", opts, PENCIL)
    s = _serial("p2d20", opts, PENCIL)
    assert t["status"] == s.status
    assert np.array_equal(t["iters_all"], s.iters_all)
    np.testing.assert_allclose(t["evalues"], s.evalues, rtol=1e-8)


# ---- the other shards -------------------------------------------------------

@pytest.mark.parametrize("name,layout,kind", [
    ("bes1024", "route", "DistBESMatrix"),
    ("table1200", "table", "DistTableCSRMatrix")])
def test_pi_over_other_shards(pools, name, layout, kind):
    opts = "-e pi -etol 1e-7 -emaxiter 500"
    t = _run(pools, 4, name, layout, opts)
    assert t["type"] == kind
    _same_pair(t, _lis(name, layout, 4, opts), band=0, xtol=1e-7)


def test_lanczos_over_the_cst(pools):
    opts = "-e li -ss 2 -rval true"
    t = _run(pools, 4, "cst960", "cst", opts)
    j = _lis("cst960", "cst", 4, opts)
    assert t["type"] == j["type"] == "DistCSTMatrix"
    assert t["status"] == j["status"]
    np.testing.assert_allclose(t["evalues"], j["evalues"], rtol=1e-8)


# ---- one rank, and every rank -----------------------------------------------

def test_one_rank_is_the_serial_esolve(pools):
    opts = "-e pi -etol 1e-8 -emaxiter 2000"
    t = _run(pools, 1, "p2d20", "route", opts)
    s = _serial("p2d20", opts)
    assert t["status"] == s.status and t["iters"] == s.iters
    assert abs(t["evalue"] - s.evalue) <= 1e-12 * abs(s.evalue)


def test_collectives_and_whole_vectors(pools):
    """Each rank returns the whole eigenvectors; CR's products go out in
    three all-reduces an iteration (one per group no update separates)."""
    opts = "-e cr -etol 1e-8 -emaxiter 2000"
    t = _run(pools, 4, "p2d20", "route", opts)
    it = t["iters"]
    # x0's norm, λ0 and the final norm; 3 an iteration
    assert t["coll"]["all_reduce"] == 3 * it + 3
    assert t["coll"]["all_gather"] == 1
    assert t["evectors"].shape == (1, 400)
    np.testing.assert_array_equal(t["evectors"][0], t["evector"])
