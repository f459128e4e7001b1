"""``dist_solve`` in both packages, on the CPU, for the distributed
preconditioners (block families, hybrid, SA-AMG with both hierarchies,
I+S, additive Schwarz), the precision modes (single, df, switch_df,
quad, switch over DIA, BES and multi-BES), the scaling modes (-scale
1/2, block scaling and block ILU under -storage bsr), the BES, table and
complex routes, and the ``cli.scaling`` harness:
status and count equal to lis_tpu's on a mesh of the same width (±1
only where tests/test_dist.py allows a band), x to 1e-10 (1e-8 where the
run stops at 1e-8, and at the bound lis_tpu's own test sets for the f32
modes).  The port runs in spawned gloo ranks without jax
(tests/_torch_dist_ranks.py), lis_tpu in this process
(tests/_torch_dist_jax.py)."""

import numpy as np
import pytest

import tests._torch_dist_jax as J
import tests._torch_dist_ranks as R
from tests._torch_dist_jax import WAIT, pools  # noqa: F401 (a fixture)


@pytest.mark.parametrize("opt", [
    "-i bicgstab -p hybrid -hybrid_maxiter 10",
    "-i cg -p sainv -sainv_drop 0.02",
    "-i cg -p bjacobi",
    "-i cg -p ssor -adds true -adds_iter 1",
    "-i cg -p ilut", "-i cg -p iluc"])
def test_precon_families(pools, opt):
    J.both(pools, "p2d20", "route", 4, f"{opt} -tol 1e-10")


def test_is_precon(pools):
    J.both(pools, "tri120d4", "route", 4, "-i bicgstab -p is -tol 1e-10",
            b=np.arange(1.0, 121.0))


def test_saamg_replicated_tail(pools):
    J.both(pools, "p2d24", "route", 4, "-i cg -p saamg -tol 1e-10")


def test_saamg_sharded_hierarchy(pools):
    """Coarse levels above -saamg_shard_rows × p rows are row slabs: the
    mid level holds about nnz/p entries a rank, and the solve is
    lis_tpu's."""
    from lis_tpu.parallel.dist_precon import make_dist_saamg as jmake
    from lis_tpu.runtime.options import SolverOptions as JOptions
    mids = pools(4).run_all(R.saamg_mid, "p2d48", "-saamg_shard_rows 8",
                            timeout=WAIT)
    jm = jmake(J.distribute("p2d48", "route", 4), J.mesh(4),
               JOptions.from_string("-saamg_shard_rows 8"))
    assert len(mids[0]) == len(jm.mids) >= 1
    for lvl, m in enumerate(jm.mids):
        assert all(r[lvl][:2] == (m.n, m.nloc) for r in mids)
        assert sum(r[lvl][2] for r in mids) <= m.a_val.shape[0]
    J.both(pools, "p2d48", "route", 4,
            "-i cg -p saamg -tol 1e-10 -saamg_shard_rows 8")


@pytest.mark.parametrize("prec,xtol,band", [
    ("single", 1e-5, 1), ("df", 1e-9, 0), ("switch_df", 1e-10, 1),
    ("quad", 1e-10, 0), ("switch", 1e-10, 1)])
def test_precision_modes_dia(pools, prec, xtol, band):
    """The DD modes give lis_tpu's count.  The f32 solve and the first
    (f32 or f64) phase of the switch modes sum their dots in another
    order and may end one step apart (tests/test_dist.py holds these
    modes to x alone, with no count)."""
    a = R.problem("p2d20")
    b = a @ np.linspace(1, 2, 400)
    J.both(pools, "p2d20", "route", 4,
            f"-i cg -p jacobi -tol 1e-10 -f {prec}", b=b, xtol=xtol, band=band)


@pytest.mark.parametrize("opt", ["-i bicgstab -p jacobi",
                                 "-i bicgstab -p ilu"])
def test_bes_route(pools, opt):
    a = R.problem("bes1024")
    J.both(pools, "bes1024", "route", 4, f"{opt} -tol 1e-10",
            b=a @ np.ones(1024))


@pytest.mark.parametrize("f,xtol", [("df", 1e-5), ("switch_df", 1e-10)])
def test_bes_extended_precision(pools, f, xtol):
    a = R.problem("bes1024")
    J.both(pools, "bes1024", "route", 4,
            f"-i bicgstab -p jacobi -tol 1e-12 -f {f} -maxiter 3000",
            b=a @ np.linspace(1, 2, 1024), xtol=xtol)


def test_multibes_route(pools):
    a = R.problem("mbes4000")
    J.both(pools, "mbes4000", "route", 4, "-i bicgstab -p jacobi -tol 1e-10",
            b=a @ np.linspace(1, 2, 4000))


def test_multibes_switch_df(pools):
    """The f32 first phase may end a step apart (as in
    test_precision_modes_dia)."""
    a = R.problem("mbes4000")
    J.both(pools, "mbes4000", "route", 4,
            "-i bicgstab -p jacobi -tol 1e-12 -f switch_df -maxiter 4000",
            b=a @ np.linspace(1, 2, 4000), band=1)


@pytest.mark.parametrize("opt", ["-i bicgstab -scale 1", "-i cg -scale 2",
                                 "-i cg -p jacobi -scale 1",
                                 "-i bicgstab -p is"])
def test_scaling_modes(pools, opt):
    """BiCGSTAB on the scaled system may end a step from lis_tpu (its own
    test allows 2, and 8 for -p is, against one device)."""
    a = R.problem("p2d20")
    J.both(pools, "p2d20", "route", 4, f"{opt} -tol 1e-10",
            b=a @ np.linspace(1, 2, 400), band=1)


def test_scale2_padded_size(pools):
    a = R.problem("p2d18")
    J.both(pools, "p2d18", "route", 4, "-i cg -scale 2 -tol 1e-10",
            b=a @ np.linspace(1, 2, 324))


def test_table_halo_solve(pools):
    a = R.problem("table1200")
    J.both(pools, "table1200", "auto", 4, "-i bicgstab -p ilu -tol 1e-10",
            b=a @ np.ones(1200))


def test_table_sparse_links_solve(pools):
    """Unpreconditioned BiCGSTAB on a 1600-row Laplacian (condition about
    1e3): the two packages sum their dots in another order, which moves x
    by about 1e-9 at the same count (the true solution is 1 everywhere;
    tests/test_dist.py holds x to it within 1e-6)."""
    a = R.problem("links1600")
    t, _ = J.both(pools, "links1600", "auto", 4, "-i bicgstab -tol 1e-10",
                   b=a @ np.ones(1600), xtol=2e-9)
    assert np.abs(t["x"] - 1).max() < 1e-6


def test_complex_solve(pools):
    rng = np.random.RandomState(1)
    b = rng.randn(512) + 1j * rng.randn(512)
    t, _ = J.both(pools, "cplx512", "route", 4,
                   "-i bicgstab -p jacobi -tol 1e-10", b=b)
    assert np.iscomplexobj(t["x"])


def test_block_ilu_storage_bsr(pools):
    t, _ = J.both(pools, "p2d20", "route", 4,
                   "-i bicgstab -p ilu -storage bsr -storage_block 2 "
                   "-tol 1e-10")
    assert not t["warnings"]


def test_block_scale_storage_bsr(pools):
    t, _ = J.both(pools, "p2d20", "route", 4,
                   "-i bicgstab -scale 1 -storage bsr -storage_block 2 "
                   "-tol 1e-10")
    assert not t["warnings"]


def test_scaling_cli_strong():
    """cli.scaling's strong mode over 1 and 2 CPU ranks: one line per
    width, with the layout lis_tpu's router picks."""
    import contextlib
    import io
    from lis_tpu_torch.cli import scaling
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = scaling.main(["strong", "16", "16", "4", "1", "2"],
                          device="cpu")
    out = buf.getvalue()
    assert rc == 0, out
    rows = [ln for ln in out.splitlines() if "ndev=" in ln]
    assert len(rows) == 2 and all("[DistDIAMatrix]" in r for r in rows)
