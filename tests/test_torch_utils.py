"""The small modules of the lis.h slice against lis_tpu's, on the CPU:
the BLAS-1 helpers of ``core/vector.py``, the dense helpers of
``core/array.py``, ``ops/spmv.py``, ``merge_matrix``,
``user_precon_name``, checkpoint/resume, ``output_rhistory``, the
profiling helpers and the top-level surface.

Vectors and matrices are made with numpy from a seed and fed to both
packages; results agree to rtol 1e-12 (bit for bit where the arithmetic
is one operation), counts and ids exactly.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lis_tpu
import lis_tpu_torch
from lis_tpu.core import array as JA, vector as JV
from lis_tpu_torch.core import array as TA, vector as TV
from lis_tpu_torch.utils.testmat import poisson2d

RTOL = 1e-12


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def vecs():
    rng = np.random.default_rng(11)
    x, y = rng.standard_normal(50), rng.standard_normal(50) + 2.0
    z = rng.standard_normal(50) + 1j * rng.standard_normal(50)
    return x, y, z


ELEMENTWISE = [
    ("axpy", lambda m, x, y: m.axpy(1.5, x, y)),
    ("xpay", lambda m, x, y: m.xpay(x, -0.5, y)),
    ("axpyz", lambda m, x, y: m.axpyz(2.0, x, y)),
    ("scale", lambda m, x, y: m.scale(3.0, x)),
    ("pmul", lambda m, x, y: m.pmul(x, y)),
    ("pdiv", lambda m, x, y: m.pdiv(x, y)),
    ("set_all", lambda m, x, y: m.set_all(0.25, x)),
    ("abs_", lambda m, x, y: m.abs_(x)),
    ("reciprocal", lambda m, x, y: m.reciprocal(y)),
    ("conjugate", lambda m, x, y: m.conjugate(x)),
    ("shift", lambda m, x, y: m.shift(0.75, x)),
    ("nrmi", lambda m, x, y: m.nrmi(x)),
    ("vsum", lambda m, x, y: m.vsum(x)),
    ("nrm1", lambda m, x, y: m.nrm1(x)),
    ("nrm2", lambda m, x, y: m.nrm2(x)),
    ("dot", lambda m, x, y: m.dot(x, y)),
    ("nhdot", lambda m, x, y: m.nhdot(x, y)),
]


@pytest.mark.parametrize("case", ELEMENTWISE, ids=[c[0] for c in ELEMENTWISE])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_vector_helpers_match_lis_tpu(vecs, case, kind):
    x, y, z = vecs
    if kind == "complex":
        x = z
        y = y.astype(complex)
    _, fn = case
    got = fn(TV, torch.from_numpy(x), torch.from_numpy(y))
    want = fn(JV, jnp.asarray(x), jnp.asarray(y))
    _close(got, want)


def test_gather_scatter(vecs):
    x, _, _ = vecs
    t = torch.from_numpy(x.copy())
    g = TV.gather(t)
    assert isinstance(g, np.ndarray)
    np.testing.assert_array_equal(g, JV.gather(jnp.asarray(x)))
    like = torch.zeros(50, dtype=torch.float32)
    s = TV.scatter(x, like)
    assert s.dtype == torch.float32 and s.device == like.device
    prev = lis_tpu_torch.set_default_device("cpu")
    try:
        np.testing.assert_array_equal(TV.scatter(x).numpy(), x)
    finally:
        lis_tpu_torch.set_default_device(prev)


@pytest.fixture(scope="module")
def dense():
    rng = np.random.default_rng(12)
    a = rng.standard_normal((6, 6)) + 6 * np.eye(6)
    return a, rng.standard_normal(6), rng.standard_normal((6, 6))


@pytest.mark.parametrize("name", ["matvec", "matvech", "matmat", "solve",
                                  "invert"])
def test_array_helpers_match_lis_tpu(dense, name):
    a, x, b = dense
    arg = b if name == "matmat" else x
    args = (a,) if name == "invert" else (a, arg)
    got = getattr(TA, name)(*args)
    want = getattr(JA, name)(*(jnp.asarray(t) for t in args))
    _close(got, want)


@pytest.mark.parametrize("name", ["cgs", "mgs"])
def test_gram_schmidt_matches_lis_tpu(dense, name):
    a, _, _ = dense
    q, r = getattr(TA, name)(a)
    qj, rj = getattr(JA, name)(jnp.asarray(a))
    _close(q, qj)
    _close(r, rj)
    _close(q @ r, a)


def test_qr_eigen_matches_lis_tpu(dense):
    a, _, _ = dense
    s = a + a.T
    ev, it = TA.qr_eigen(s, maxiter=500, tol=1e-12)
    evj, itj = JA.qr_eigen(jnp.asarray(s), maxiter=500, tol=1e-12)
    assert it == int(itj)
    _close(ev, evj, 1e-10)
    np.testing.assert_allclose(np.sort(ev.numpy()),
                               np.linalg.eigvalsh(s), rtol=1e-8)


def test_spmv_and_merge_matrix():
    from lis_tpu.matrix.split import merge_matrix as j_merge, \
        split_matrix as j_split
    from lis_tpu.ops import spmv as JS
    from lis_tpu_torch.matrix.split import merge_matrix, split_matrix
    from lis_tpu_torch.ops import spmv as TS
    from tests.problems import poisson2d as jpoisson2d
    At = poisson2d(5, 7, device="cpu")
    Aj = jpoisson2d(5, 7)
    x = np.random.default_rng(13).standard_normal(35)
    _close(TS.matvec(At, torch.from_numpy(x)), JS.matvec(Aj, jnp.asarray(x)))
    _close(TS.matvech(At, torch.from_numpy(x)),
           JS.matvech(Aj, jnp.asarray(x)))
    _close(lis_tpu_torch.matvec(At, torch.from_numpy(x)),
           lis_tpu.matvec(Aj, jnp.asarray(x)))
    m = merge_matrix(split_matrix(At))
    mj = j_merge(j_split(Aj))
    assert m.format_name == "csr" and m.device.type == "cpu"
    for got, want in zip(m.to_csr_arrays(), mj.to_csr_arrays()):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_user_precon_name():
    from lis_tpu.precon import base as JB
    from lis_tpu_torch.precon import base as TB
    from lis_tpu_torch.runtime.options import PRECON_NAMES
    base = len(PRECON_NAMES)
    pid = TB.user_precon_id("utils_probe", base)
    jpid = JB.user_precon_id("utils_probe", base)
    assert TB.user_precon_name(pid) == JB.user_precon_name(jpid) \
        == "utils_probe"
    assert TB.user_precon_name(-7) is None


# ---- checkpoint ---------------------------------------------------------------

def test_checkpoint_resume_matches_lis_tpu(tmp_path):
    """-maxiter 20 stops CG early; save, load, resume: the resumed count,
    history and x equal lis_tpu's resume of its own checkpoint."""
    from lis_tpu.utils import checkpoint as JC
    from lis_tpu_torch.utils import checkpoint as TC
    from tests.problems import poisson2d as jpoisson2d
    At, Aj = poisson2d(12, 12, device="cpu"), jpoisson2d(12, 12)
    b = np.random.default_rng(14).standard_normal(144)
    opts = "-i cg -p jacobi -tol 1e-10"
    rt = lis_tpu_torch.solve(At, b, options=opts + " -maxiter 20")
    rj = lis_tpu.solve(Aj, b, options=opts + " -maxiter 20")
    assert rt.status == rj.status == lis_tpu_torch.LIS_MAXITER
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    TC.save_checkpoint(pt, rt)
    JC.save_checkpoint(pj, rj)
    x, rh, meta = TC.load_checkpoint(pt)
    xj, rhj, metaj = JC.load_checkpoint(pj)
    assert meta == {**metaj, "resid": meta["resid"]}
    _close(x, xj)
    _close(rh, rhj)
    res = TC.resume_solve(At, b, pt, options=opts)
    resj = JC.resume_solve(Aj, b, pj, options=opts)
    assert res.status == resj.status == lis_tpu_torch.LIS_SUCCESS
    assert res.iters == resj.iters
    assert res.x.device.type == "cpu"
    _close(res.x, resj.x, 1e-10)
    _close(res.rhistory, resj.rhistory, 1e-8)
    assert res.true_resid <= 1e-9
    ft, fj = tmp_path / "rh_t.txt", tmp_path / "rh_j.txt"
    TC.output_rhistory(str(ft), rt)
    JC.output_rhistory(str(fj), rj)
    assert ft.read_text() == fj.read_text()


# ---- profiling ----------------------------------------------------------------

def test_phase_timer_and_sync(capsys):
    from lis_tpu_torch.utils import profiling as P
    t = P.PhaseTimer()
    v = torch.ones(10)
    for _ in range(3):
        with t.phase("work", sync_value={"v": [v]}):
            v = v * 2
    with t.phase("other"):
        pass
    assert t.counts == {"work": 3, "other": 1}
    assert t.times["work"] >= 0.0
    assert P.sync(v) is v
    t.report()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("work") and "(3 calls)" in out[0]


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    """On the CPU the trace holds the host's operations (the card's are
    added where the default device is one)."""
    import json
    from lis_tpu_torch.utils import profiling as P
    A = poisson2d(8, 8, device="cpu")
    prev = lis_tpu_torch.set_default_device("cpu")
    try:
        with P.profile_trace(str(tmp_path / "tr")) as prof:
            r = lis_tpu_torch.solve(A, np.ones(64), options="-i cg -p jacobi")
    finally:
        lis_tpu_torch.set_default_device(prev)
    assert r.status == 0
    path = tmp_path / "tr" / "trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert any(n and n.startswith("aten::") for n in names)
    assert len(prof.key_averages()) > 0


# ---- the top level ------------------------------------------------------------

def test_top_level_covers_lis_tpu():
    assert set(lis_tpu.__all__) <= set(lis_tpu_torch.__all__)
    for name in lis_tpu_torch.__all__:
        assert hasattr(lis_tpu_torch, name), name
    assert lis_tpu_torch.SOLVER_REGISTRY is \
        __import__("lis_tpu_torch.solvers.base",
                   fromlist=["SOLVER_FNS"]).SOLVER_FNS
    assert set(lis_tpu.SOLVER_REGISTRY) == set(lis_tpu_torch.SOLVER_REGISTRY)
    assert lis_tpu_torch.finalize() == lis_tpu.finalize() == 0
    was = lis_tpu_torch.debug_trace_enabled()
    lis_tpu_torch.set_debug_trace(True)
    assert lis_tpu_torch.debug_trace_enabled()
    lis_tpu_torch.set_debug_trace(was)
