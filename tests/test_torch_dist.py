"""The distributed layer in both packages, on the CPU: ranges, the comm
tables and halo widths (exactly), the sharded products of every layout
(gather, neighbour, table, DIA, CST, BES, multi-BES, hybrid) to 1e-12,
the shards that ``from_numpy_state`` builds from lis_tpu's leaves, and
``dist_solve`` of the solvers, halo modes, Jacobi, block
preconditioners, non-divisible sizes, redistribution, GS/SOR (and the
omega clamp's warning), the CST route and switch_df over the comm
table, each held to
lis_tpu's own distributed run on a mesh of the same width: status and
count equal (±1 only where tests/test_dist.py allows a band against a
single device), x to 1e-10.

The port runs in a pool of 4 (and one of 3) spawned gloo ranks that
import no jax (tests/_torch_dist_ranks.py); lis_tpu runs in this process
on the conftest's virtual CPU devices (tests/_torch_dist_jax.py).  Every
wait on the ranks is bounded, so a hung collective fails its case.
"""

import numpy as np
import pytest

import tests._torch_dist_jax as J
import tests._torch_dist_ranks as R
from lis_tpu.core import ranges as jranges
from lis_tpu_torch.core import ranges as tranges
from lis_tpu_torch.parallel import RankPool
from tests._torch_dist_jax import WAIT, pools  # noqa: F401 (a fixture)


# ---- ranges -----------------------------------------------------------------

@pytest.mark.parametrize("p,gn", [(1, 7), (3, 10), (4, 173), (8, 5), (3, 2)])
def test_ranges_match(p, gn):
    assert np.array_equal(tranges.ranges_create(p, gn),
                          jranges.ranges_create(p, gn))
    assert tranges.padded_local_n(p, gn) == jranges.padded_local_n(p, gn)
    for k in range(p):
        assert tranges.get_isie(k, p, gn) == jranges.get_isie(k, p, gn)
    for row in range(gn):
        assert tranges.owner_of(row, p, gn) == jranges.owner_of(row, p, gn)


# ---- comm tables and halos --------------------------------------------------

@pytest.mark.parametrize("name,layout,p", [
    ("table1200", "table", 4), ("links1600", "auto", 4),
    ("table1200", "table", 3), ("cst960", "cst", 4)])
def test_comm_table_matches(pools, name, layout, p):
    outs = pools(p).run_all(R.tables, name, layout, timeout=WAIT)
    Ad = J.distribute(name, layout, p)
    assert outs[0]["type"] == type(Ad).__name__
    for k, o in enumerate(outs):
        assert o["dists"] == tuple(Ad.dists)
        assert o["exp_lens"] == tuple(Ad.exp_lens)
        assert o["G"] == Ad.G and o["nlocal"] == Ad.nlocal
        assert o["gn_pad"] == Ad.gn_pad
        assert o["comm_elems"] == Ad.comm_elems
        for e_t, e_j, Ed in zip(o["exports"], Ad.exports, Ad.exp_lens):
            assert np.array_equal(e_t, np.asarray(e_j).reshape(p, Ed)[k])
        gg = np.asarray(Ad.ghost_gids).reshape(p, Ad.G)[k]
        assert np.array_equal(o["ghost_gids"], gg)


@pytest.mark.parametrize("name,layout,p", [
    ("p2d20", "neighbor", 4), ("p2d13x11", "route", 4),
    ("p2d13x11", "route", 3), ("hybrid400", "route", 4)])
def test_halo_widths_match(pools, name, layout, p):
    o = pools(p).run(R.tables, name, layout, timeout=WAIT)
    Ad = J.distribute(name, layout, p)
    assert o["type"] == type(Ad).__name__
    hw = Ad.dia.hw if o["type"] == "DistHybridMatrix" else Ad.hw
    assert o["nlocal"] == Ad.nlocal and o["gn_pad"] == Ad.gn_pad
    if o["type"] != "DistHybridMatrix":
        assert o["hw"] == hw


# ---- products ---------------------------------------------------------------

@pytest.mark.parametrize("name,layout,p", [
    ("p2d20", "gather", 4), ("p2d20", "neighbor", 4), ("p2d20", "table", 4),
    ("table1200", "table", 3), ("p2d13x11", "dia", 4), ("p2d13x11", "dia", 3),
    ("cst960", "cst", 4), ("bes1024", "route", 4), ("mbes4000", "route", 4),
    ("hybrid400", "route", 4), ("cplx512", "route", 4)])
def test_products_match(pools, name, layout, p):
    a = R.problem(name)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(a.shape[0])
    if np.iscomplexobj(a.data):
        x = x + 1j * rng.standard_normal(a.shape[0])
    kind, y, yh = pools(p).run(R.products, name, layout, x, timeout=WAIT)
    jkind, jy, jyh = J.products(name, layout, p, x)
    assert kind == jkind
    s = max(np.abs(a @ x).max(), 1.0)
    np.testing.assert_allclose(y, jy, rtol=0, atol=1e-12 * s)
    np.testing.assert_allclose(yh, jyh, rtol=0, atol=1e-12 * s)
    np.testing.assert_allclose(y, a @ x, rtol=0, atol=1e-12 * s)
    np.testing.assert_allclose(yh, a.conj().T @ x, rtol=0, atol=1e-12 * s)


@pytest.mark.parametrize("layout,p", [("dia", 4), ("dia", 3),
                                      ("neighbor", 4), ("neighbor", 3)])
def test_ring_wrap_products(pools, layout, p):
    """lis_tpu's ring hands rank 0 the last rank's slab and the last rank
    rank 0's; a band reaching both ends of the global range, with x
    nonzero in both edge slabs, shows the wrapped slabs cancel."""
    a = R.problem("band600")
    x = 1.0 + np.random.default_rng(9).random(a.shape[0])
    kind, y, yh = pools(p).run(R.products, "band600", layout, x,
                               timeout=WAIT)
    assert kind in ("DistDIAMatrix", "DistCSRMatrix")
    s = np.abs(a @ x).max()
    np.testing.assert_allclose(y, a @ x, rtol=0, atol=1e-13 * s)
    np.testing.assert_allclose(yh, a.T @ x, rtol=0, atol=1e-13 * s)


@pytest.mark.parametrize("name,layout", [
    ("p2d20", "gather"), ("p2d20", "neighbor"), ("table1200", "table"),
    ("p2d13x11", "dia"), ("cst960", "cst"), ("bes1024", "route"),
    ("hybrid400", "route")])
def test_numpy_state_of_lis_tpu_shards(pools, name, layout):
    """from_numpy_state's distributed kinds: each rank takes its part of
    lis_tpu's stacked leaves and gives lis_tpu's products."""
    a = R.problem(name)
    x = np.random.default_rng(4).standard_normal(a.shape[0])
    Ad = J.distribute(name, layout, 4)
    kind, y, yh = pools(4).run(R.state_products, J.state(Ad), x,
                               timeout=WAIT)
    jkind, jy, jyh = J.products(name, layout, 4, x)
    assert kind == jkind
    s = max(np.abs(a @ x).max(), 1.0)
    np.testing.assert_allclose(y, jy, rtol=0, atol=1e-12 * s)
    np.testing.assert_allclose(yh, jyh, rtol=0, atol=1e-12 * s)


# ---- solves -----------------------------------------------------------------

@pytest.mark.parametrize("solver", ["cg", "bicg", "bicgstab", "gmres",
                                    "idrs", "minres"])
def test_solvers_match(pools, solver):
    J.both(pools, "p2d20", "auto", 4, f"-i {solver} -tol 1e-10")


@pytest.mark.parametrize("halo", ["gather", "neighbor", "table"])
def test_halo_modes_match(pools, halo):
    J.both(pools, "p2d20", halo, 4, "-i cg -tol 1e-10")


def test_jacobi_matches(pools):
    J.both(pools, "tri100d3", "auto", 4, "-i cg -p jacobi -tol 1e-10",
            b=np.arange(1.0, 101.0))


@pytest.mark.parametrize("p", [4, 3])
def test_nondivisible_size(pools, p):
    t, _ = J.both(pools, "tri173", "auto", p, "-i cg -tol 1e-10")
    assert t["x"].shape == (173,)


def test_x_truncated_to_global_size(pools):
    t, _ = J.both(pools, "p2d13x7", "auto", 4, "-i cg -tol 1e-10")
    assert t["x"].shape == (91,)


@pytest.mark.parametrize("precon", ["ilu", "ssor"])
def test_block_precon_matches(pools, precon):
    J.both(pools, "p2d20", "auto", 4, f"-i cg -p {precon} -tol 1e-10")


def test_redistribute_roundtrip(pools):
    a = R.problem("p2d11x9")
    p_, i_, v_, halo, status, iters, x = pools(4).run(
        R.roundtrip, "p2d11x9", timeout=WAIT)
    assert np.array_equal(p_, a.indptr) and np.array_equal(i_, a.indices)
    np.testing.assert_allclose(v_, a.data)
    assert halo == "gather" and status == 0
    j = J.solve("p2d11x9", "gather", 4, np.ones(99), "-i cg -tol 1e-10")
    assert iters == j["iters"]
    np.testing.assert_allclose(x, j["x"], rtol=0, atol=1e-10)


def test_dia_route_bicg_ilu(pools):
    J.both(pools, "p2d13x11", "route", 4, "-i bicg -p ilu -tol 1e-10")


@pytest.mark.parametrize("sopt", ["-i gs", "-i sor -omega 1.5"])
def test_stationary_match(pools, sopt):
    J.both(pools, "p2d13x11", "route", 4, f"{sopt} -tol 1e-8 -maxiter 5000",
            xtol=1e-8)


def test_sor_omega_clamp_warns(pools):
    """The block-local SOR clamps -omega above 1.5 over several ranks and
    says so (lis_tpu's clamp, carried over as it is)."""
    t = pools(4).run(R.solve, "p2d13x11", "route", np.ones(143),
                     "-i sor -tol 1e-8 -maxiter 5000", timeout=WAIT)
    assert any("clamping to 1.5" in w for w in t["warnings"])
    j = J.solve("p2d13x11", "route", 4, np.ones(143),
                "-i sor -tol 1e-8 -maxiter 5000")
    J.same_solve(t, j, xtol=1e-8)


# ---- devices and meshes -----------------------------------------------------

def test_default_device_places_the_shards():
    """A pool started with no device runs on config.default_device() of
    its caller, and each rank builds and solves there."""
    from lis_tpu_torch import config
    prev = config.set_default_device("cpu")
    try:
        with RankPool(2, timeout=WAIT) as pool:
            out = pool.run(R.devices, "p2d13x7", timeout=WAIT)
    finally:
        config.set_default_device(prev)
    assert out == ("cpu", "cpu", "cpu", "cpu", 0)


def test_nccl_without_cards_raises():
    """nccl with more ranks than visible cards is an error naming the
    remedy, never a fallback to another backend or the CPU."""
    import torch
    from lis_tpu_torch.parallel import ensure_devices, make_mesh
    need = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        RankPool(need, device="cuda")
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        ensure_devices(need, device="cuda")
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="backend='gloo'"):
            make_mesh()                # the default device is the card
    assert ensure_devices(4, device="cpu") >= 4


# ---- the CST route and DD over the comm table (see test_torch_dist_precon.py
# for the other routes and modes) --------------------------------------------

@pytest.mark.parametrize("opt", ["-i bicgstab", "-i cg -p jacobi",
                                 "-i cg -scale 1"])
def test_cst_route(pools, opt):
    J.both(pools, "cst960", "cst", 4, f"{opt} -tol 1e-10")


@pytest.mark.parametrize("solver", ["bicgstab", "bicg"])
def test_switch_df_table(pools, solver):
    J.both(pools, "rand480", "table", 4,
            f"-i {solver} -f switch_df -tol 1e-13 -maxiter 500")
