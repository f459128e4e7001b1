"""The port's Fortran/C binding shim and its C drivers, on the CPU.

``lis_tpu_torch._native.lisf.build`` compiles the port's copy of the
shim (``_native/lisf_tpu.c``, which embeds CPython and calls
``lis_tpu_torch.interop.fapi``) and the seven drivers of the reference's
Fortran test programs (test1f, test2f, test6f, test7f, test8f, etest1f,
etest4f) into a temporary directory, once for the file.  Each driver runs
with ``LIS_TPU_TORCH_DEVICE=cpu`` (a C caller cannot pass ``device=``) and
is held to the same call sequence made in this process through
``lis_tpu_torch.compat``: printed counts exactly, printed values as
printed, solution and history files to 1e-12.  test2f and etest1f also run
through lis_tpu's own shim, built into the same directory from
``lis_tpu/_native/``, and must agree with it.  Without gcc the file skips.
"""

import os
import re
import shutil
import subprocess
import sys
import sysconfig

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

import lis_tpu_torch.compat as T
from lis_tpu_torch import config
from lis_tpu_torch.io import lis_input_vector

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JNATIVE = os.path.join(_ROOT, "lis_tpu", "_native")


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    """The CPU for the module; the command line that the in-process runs
    record (lis_initialize) is put back after it."""
    prev = config.set_default_device("cpu")
    args = list(config.get_cmd_args())
    yield
    config.set_default_device(prev)
    config._cmd_args = args


def _matrix(n=100, seed=5):
    """A seeded nonsymmetric, diagonally dominant matrix (scipy CSR)."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=0.04, random_state=rng, format="csr")
    a = (a + sp.diags(np.full(n, 4.0)) - 0.3 * a.T).tocsr()
    a.sort_indices()
    return a


def _spd(n=100, seed=6):
    a = _matrix(n, seed)
    return (a + a.T + sp.diags(np.full(n, 8.0))).tocsr()


def _jshim_build(dest):
    """lis_tpu's shim and two of its drivers, compiled from lis_tpu's
    sources into ``dest`` (lis_tpu's own tests build them in its source
    tree; this copy writes nothing there)."""
    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    py = f"python{sysconfig.get_config_var('LDVERSION')}"
    jdir = os.path.join(dest, "lis_tpu")
    os.makedirs(jdir)
    r = subprocess.run(["gcc", "-shared", "-fPIC",
                        os.path.join(_JNATIVE, "lisf_tpu.c"), f"-I{inc}",
                        f"-L{libdir}", f"-l{py}", f"-Wl,-rpath,{libdir}",
                        "-o", os.path.join(jdir, "liblisf_tpu.so")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    out = {}
    for t in ("test2f", "etest1f"):
        exe = os.path.join(jdir, t)
        r = subprocess.run(["gcc", os.path.join(_JNATIVE, "ftest", t + ".c"),
                            "-I" + os.path.join(_JNATIVE, "ftest"),
                            "-L" + jdir, "-llisf_tpu", "-Wl,-rpath," + jdir,
                            "-o", exe], capture_output=True, text=True)
        assert r.returncode == 0, (t, r.stderr)
        out[t] = exe
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Build both shims, then run every driver once, all at the same
    time; {name: (returncode, stdout, stderr, workdir)}."""
    if shutil.which("gcc") is None:
        pytest.skip("no C compiler (gcc)")
    from lis_tpu_torch._native import lisf
    d = tmp_path_factory.mktemp("lisf")
    exes = lisf.build(str(d))
    jexes = _jshim_build(str(d))
    scipy.io.mmwrite(str(d / "a.mtx"), _matrix())
    scipy.io.mmwrite(str(d / "s.mtx"), _spd())
    env = dict(os.environ, LIS_TPU_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    jenv = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=_ROOT,
                OMP_NUM_THREADS="1")
    jobs = {
        "test1f": (exes["test1f"], ["a.mtx", "1", "sol1", "rh1", "-i",
                                    "bicg", "-tol", "1e-12"], env),
        "test2f": (exes["test2f"], ["10", "10", "1", "sol2", "rh2", "-i",
                                    "cg", "-p", "jacobi", "-tol", "1e-10"],
                   env),
        "test6f": (exes["test6f"], ["8", "8"], env),
        "test7f": (exes["test7f"], [], env),
        "test8f": (exes["test8f"], ["50"], env),
        "etest1f": (exes["etest1f"], ["s.mtx", "ev1", "erh1", "-e", "pi",
                                      "-etol", "1e-8"], env),
        "etest4f": (exes["etest4f"], ["50", "-e", "ii", "-emaxiter", "3000",
                                      "-etol", "1e-10"], env),
        "j_test2f": (jexes["test2f"], ["10", "10", "1", "jsol2", "jrh2",
                                       "-i", "cg", "-p", "jacobi", "-tol",
                                       "1e-10"], jenv),
        "j_etest1f": (jexes["etest1f"], ["s.mtx", "jev1", "jerh1", "-e",
                                         "pi", "-etol", "1e-8"], jenv),
    }
    procs = {k: subprocess.Popen([exe, *args], cwd=d, env=e, text=True,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, (exe, args, e) in jobs.items()}
    out = {}
    for k, p in procs.items():
        so, se = p.communicate(timeout=300)
        out[k] = (p.returncode, so, se, d)
    return out, {k: v[1] for k, v in jobs.items()}


def _ok(runs, name):
    rc, so, se, d = runs[0][name]
    assert rc == 0, (name, so, se)
    return so, d


def _int(pattern, text):
    m = re.search(pattern, text)
    assert m, (pattern, text)
    return int(m.group(1))


def _vec(path):
    return lis_input_vector(str(path), device="cpu").numpy()


def _rhist(path):
    return np.array(open(path).read().split(), float)


def _close(got, want, tol=1e-12):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def test_test1f_flow(runs, tmp_path):
    so, d = _ok(runs, "test1f")
    argv = runs[1]["test1f"]
    T.lis_initialize(argv)
    A, b, x = (T.lis_matrix_create(0), T.lis_vector_create(0),
               T.lis_vector_create(0))
    T.lis_matrix_set_type(A, T.LIS_MATRIX_CSR)
    T.lis_input(A, b, x, str(d / "a.mtx"))
    assert T.lis_vector_is_null(b) == T.LIS_TRUE
    T.lis_vector_set_size(b, 0, A.n)
    T.lis_vector_set_all(1.0, b)
    T.lis_vector_set_size(x, 0, A.n)
    s = T.lis_solver_create()
    T.lis_solver_set_option("-print mem", s)
    T.lis_solver_set_optionC(s)
    assert T.lis_solve(A, b, x, s) == T.LIS_SUCCESS
    assert _int(r"bicg: number of iterations = (\d+)", so) \
        == T.lis_solver_get_iter(s)
    _close(_vec(d / "sol1"), T.lis_vector_gather(x))
    T.lis_solver_output_rhistory(s, str(tmp_path / "rh"))
    assert open(d / "rh1").read() == open(tmp_path / "rh").read()


def _test2f_inproc(argv, m, n):
    T.lis_initialize(argv)
    nn = m * n
    A = T.lis_matrix_create(0)
    T.lis_matrix_set_size(A, 0, nn)
    a = sp.kronsum(sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(m, m)),
                   sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)),
                   format="csr")
    a.sort_indices()
    T.lis_matrix_set_csr(a.nnz, a.indptr, a.indices, a.data, A)
    T.lis_matrix_assemble(A)
    u, b, x = (T.lis_vector_create(0) for _ in range(3))
    for v in (u, b, x):
        T.lis_vector_set_size(v, 0, nn)
    T.lis_vector_set_all(1.0, u)
    T.lis_matvec(A, u, b)
    s = T.lis_solver_create()
    T.lis_solver_set_option("-print mem", s)
    T.lis_solver_set_optionC(s)
    T.lis_solve(A, b, x, s)
    return A, s, x


def test_test2f_flow(runs, tmp_path):
    """set_csr from caller-owned buffers, convert, solve; the printed
    count and the files against the in-process compat run and against
    lis_tpu's shim."""
    so, d = _ok(runs, "test2f")
    jso, _ = _ok(runs, "j_test2f")
    assert "matrix size = 100 x 100 (460 nonzero entries)" in so
    A, s, x = _test2f_inproc(runs[1]["test2f"], 10, 10)
    it = _int(r"cg: number of iterations = (\d+)", so)
    assert it == T.lis_solver_get_iter(s) == 15
    assert it == _int(r"cg: number of iterations = (\d+)", jso)
    _close(_vec(d / "sol2"), T.lis_vector_gather(x))
    _close(_vec(d / "sol2"), _vec(d / "jsol2"))
    T.lis_solver_output_rhistory(s, str(tmp_path / "rh"))
    assert open(d / "rh2").read() == open(tmp_path / "rh").read()
    _close(_rhist(d / "rh2"), _rhist(d / "jrh2"), 1e-5)
    # the port's LIS_FMT_MM (2, as in lis.h) writes a MatrixMarket file
    assert open(d / "sol2").readline().startswith("%%MatrixMarket")


def test_test6f_flow(runs):
    """Dense direct solve through lis_array_* on raw column-major
    buffers."""
    so, _ = _ok(runs, "test6f")
    assert "matrix size = 64 x 64 (288 nonzero entries)" in so
    m = n = 8
    nn = m * n
    a = np.zeros(nn * nn)
    for ii in range(nn):
        i, j = divmod(ii, m)
        for jj, ok in ((ii - m, i > 0), (ii + m, i < n - 1),
                       (ii - 1, j > 0), (ii + 1, j < m - 1)):
            if ok:
                a[ii + nn * jj] = -1.0
        a[ii + nn * ii] = 4.0
    u, b, x, w = np.ones(nn), np.zeros(nn), np.zeros(nn), np.zeros(nn * nn)
    T.lis_array_matvec(nn, a, u, b, T.LIS_INS_VALUE)
    T.lis_array_solve(nn, a, b, x, w)
    T.lis_array_xpay(nn, x, -1.0, u)
    want = T.lis_array_nrm2(nn, u) / T.lis_array_nrm2(nn, b)
    line = f"Direct: relative residual    = {want:e}"
    assert line in so and want < 1e-12


def test_test7f_flow(runs):
    so, _ = _ok(runs, "test7f")
    v = T.lis_vector_create(0)
    T.lis_vector_set_size(v, 0, 10)
    T.lis_vector_set_all(2.0, v)
    T.lis_vector_conjugate(v)
    assert f"inner product (v,v) = {T.lis_vector_dot(v, v):f}" in so
    assert f"2-norm of v = {T.lis_vector_nrm2(v):f}" in so
    assert so.splitlines().count("2.000000") == 20


def test_test8f_psd_flow(runs):
    so, _ = _ok(runs, "test8f")
    n = 50
    A = T.lis_matrix_create(0)
    T.lis_matrix_set_size(A, 0, n)
    for i in range(n):
        if i > 0:
            T.lis_matrix_set_value(T.LIS_INS_VALUE, i, i - 1, -1.0, A)
        if i < n - 1:
            T.lis_matrix_set_value(T.LIS_INS_VALUE, i, i + 1, -1.0, A)
        T.lis_matrix_set_value(T.LIS_INS_VALUE, i, i, 2.5, A)
    T.lis_matrix_assemble(A)
    b = T.lis_vector_create(0)
    T.lis_vector_set_size(b, 0, n)
    T.lis_vector_set_all(1.0, b)
    x = T.lis_vector_duplicate(b)
    s = T.lis_solver_create()
    T.lis_solver_set_option("-i bicgstab -p ilu -tol 1e-12", s)
    T.lis_solver_set_matrix(A, s)
    p = T.lis_precon_psd_create(s)
    T.lis_solve_kernel(A, b, x, s, p)
    want = [(T.lis_solver_get_iter(s), T.lis_solver_get_residualnorm(s))]
    for i in range(n):
        T.lis_matrix_psd_set_value(T.LIS_ADD_VALUE, i, i, 2.0, A)
    T.lis_precon_psd_update(s, p)
    T.lis_solve_kernel(A, b, x, s, p)
    want.append((T.lis_solver_get_iter(s), T.lis_solver_get_residualnorm(s)))
    for k, (it, res) in enumerate(want, 1):
        assert f"pass {k}: iters = {it}, resid = {res:e}" in so
        assert res < 1e-11
    assert want[1][0] <= want[0][0]


def _esolve_inproc(argv, A):
    T.lis_initialize(argv)
    x = T.lis_vector_create(0)
    T.lis_vector_set_size(x, 0, A.n)
    T.lis_vector_set_all(1.0, x)
    es = T.lis_esolver_create()
    T.lis_esolver_set_option("-eprint mem", es)
    T.lis_esolver_set_optionC(es)
    st, ev = T.lis_esolve(A, x, es)
    return st, ev, es, x


def test_etest1f_flow(runs, tmp_path):
    so, d = _ok(runs, "etest1f")
    jso, _ = _ok(runs, "j_etest1f")
    A = T.lis_matrix_create(0)
    T.lis_matrix_set_type(A, T.LIS_MATRIX_CSR)
    T.lis_input_matrix(A, str(d / "s.mtx"))
    st, ev, es, x = _esolve_inproc(runs[1]["etest1f"], A)
    assert st == T.LIS_SUCCESS
    it = T.lis_esolver_get_iter(es)
    assert _int(r"pi: number of iterations = (\d+)", so) == it
    assert _int(r"pi: number of iterations = (\d+)", jso) == it
    assert f"pi: eigenvalue           = {ev:e}" in so
    assert f"pi: eigenvalue           = {ev:e}" in jso
    _close(_vec(d / "ev1"), T.lis_vector_gather(x))
    _close(_vec(d / "ev1"), _vec(d / "jev1"), 1e-10)
    T.lis_esolver_output_rhistory(es, str(tmp_path / "rh"))
    assert open(d / "erh1").read() == open(tmp_path / "rh").read()


def test_etest4f_flow(runs):
    so, _ = _ok(runs, "etest4f")
    assert "matrix size = 50 x 50 (148 nonzero entries)" in so
    n = 50
    A = T.lis_matrix_create(0)
    T.lis_matrix_set_size(A, 0, n)
    for i in range(n):
        if i > 0:
            T.lis_matrix_set_value(T.LIS_INS_VALUE, i, i - 1, -1.0, A)
        if i < n - 1:
            T.lis_matrix_set_value(T.LIS_INS_VALUE, i, i + 1, -1.0, A)
        T.lis_matrix_set_value(T.LIS_INS_VALUE, i, i, 2.0, A)
    T.lis_matrix_assemble(A)
    st, ev, es, _ = _esolve_inproc(runs[1]["etest4f"], A)
    assert f"ii: eigenvalue           = {ev:14.7e}" in so
    assert _int(r"ii: number of iterations = (\d+)", so) \
        == T.lis_esolver_get_iter(es)
    assert abs(ev - (2 - 2 * np.cos(np.pi / 51))) < 1e-8


def test_shim_reads_the_device_from_the_environment(runs):
    """Unset, the shim's device is the card: on this CPU-only machine a
    driver that builds a matrix fails through CHKERR, with torch's CUDA
    error, and never falls back to the CPU."""
    if sys.platform != "linux":
        pytest.skip("linux only")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: unset means the card, which works")
    d = runs[0]["test2f"][3]
    env = {k: v for k, v in os.environ.items()
           if k != "LIS_TPU_TORCH_DEVICE"}
    r = subprocess.run([str(d / "test2f"), "4", "4", "1", "s", "r"], cwd=d,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "CHKERR failed" in r.stderr and "CUDA" in r.stderr
