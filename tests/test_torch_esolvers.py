"""The eigensolvers of lis_tpu_torch (esolve) against lis_tpu's, on the CPU.

Each case feeds the same numpy inputs to ``lis_tpu.esolve`` and to
``lis_tpu_torch.esolve`` (poisson2d 10x10 unless said otherwise; both
packages route it to DIA) and holds the port to lis_tpu: the same
status, the same outer iteration count for every pair, eigenvalues to
1e-10 relative and eigenvectors to 1e-8 up to sign or phase.  Where an
eigenvalue is degenerate (0.3985 on this grid is a double eigenvalue) the
eigenvector is any vector of its eigenspace, so the port's is held to
the eigenspace instead: ||Ax − λx|| <= 1e-8·|λ|.

Three cases are not compared by count, each for a reason the test
states:

- PI at the default -etol 1e-12 converges by a factor of 0.92 per step
  and meets that tolerance at its rounding floor: lis_tpu takes 220
  steps, the port 217, their histories parting near 1e-11.  PI is held
  exactly at -etol 1e-8 (etest1's options) below;
- RQI with its default inner BiCG: the shifted systems are indefinite,
  BiCG runs to its 1000 steps without converging, and the path rests on
  rounding from the first step.  A relative 1e-14 change of x0 = ones
  moves lis_tpu's own count between 11 and 16 and its eigenvalue among
  0.162, 0.3985 and 2.406 at -etol 1e-8 (this CPU).  That case is held
  to the math (an eigenpair of A); RQI's device loop is held to lis_tpu
  with the inner MINRES, whose count did not move under the same change
  (4 at -etol 1e-8), and its host loop with the inner GMRES;
- SI's pairs after the first (``test_si_later_pairs_against_the_math``):
  lis_tpu starts them from rounding noise (ROADMAP.md queue 3), the port
  from a seeded random vector, so they are held to scipy's spectrum.
"""

import numpy as np
import pytest
import scipy.linalg as sl
import scipy.sparse as sp

import lis_tpu
import lis_tpu_torch
from lis_tpu.esolvers.base import ESOLVER_FNS as J_FNS
from lis_tpu.esolvers.power import _jit_inner_ok
from lis_tpu_torch.esolvers.base import ESOLVER_FNS as T_FNS
from lis_tpu_torch.esolvers.power import _raw_inner_ok
from lis_tpu_torch.runtime.options import EsolverOptions as TEOptions
from lis_tpu_torch.utils.testmat import poisson2d

STANDARD = ("pi", "ii", "rqi", "cg", "cr", "si", "li", "ai")


def pair_of(a):
    """(lis_tpu CSR, port CSR on the CPU, dense) of a scipy matrix."""
    a = sp.csr_matrix(a)
    a.sort_indices()
    args = (a.indptr, a.indices, a.data, a.shape)
    return (lis_tpu.CSRMatrix.from_csr_arrays(*args),
            lis_tpu_torch.CSRMatrix.from_csr_arrays(*args, device="cpu"),
            a.toarray())


_P2 = {}


def p2(m=10):
    if m not in _P2:
        ptr, idx, val = poisson2d(m, m, device="cpu").to_csr_arrays()
        n = len(ptr) - 1
        _P2[m] = pair_of(sp.csr_matrix((val, idx, ptr), shape=(n, n)))
    return _P2[m]


def run_both(opts, J, T, JB=None, TB=None, x0=None):
    return (lis_tpu.gesolve(J, JB, options=opts, x0=x0),
            lis_tpu_torch.gesolve(T, TB, options=opts, x0=x0))


def assert_vectors(rj, rt, a, b=None, pairs=None):
    """Eigenvectors to 1e-8 up to sign or phase; a vector of a degenerate
    eigenvalue (of the pencil (a, b)) to its eigenspace instead."""
    b = np.eye(a.shape[0]) if b is None else b
    w = sl.eigh(a, b, eigvals_only=True)
    for i in range(len(rt.evalues)) if pairs is None else pairs:
        lam = rt.evalues[i]
        xj, xt = np.asarray(rj.evectors[i]), rt.evectors[i]
        if np.sum(np.abs(w - lam) <= 1e-6 * max(1.0, abs(lam))) > 1:
            res = np.linalg.norm(a @ xt - lam * (b @ xt))
            assert res <= 1e-8 * max(1.0, abs(lam)), (i, lam, res)
            continue
        c = np.vdot(xt, xj)
        phase = c / abs(c)
        np.testing.assert_allclose(phase * xt, xj, rtol=0, atol=1e-8,
                                   err_msg=f"evector {i}")


def assert_same(rj, rt, a=None, b=None, rtol=1e-10, vectors=True):
    """Status, every pair's count, eigenvalues to ``rtol`` relative,
    residuals met alike; eigenvectors as ``assert_vectors``."""
    assert rt.status == rj.status, (rj.status, rt.status)
    assert rt.iters == rj.iters, (rj.iters, rt.iters)
    np.testing.assert_array_equal(rt.iters_all, np.asarray(rj.iters_all))
    np.testing.assert_allclose(rt.evalues, np.asarray(rj.evalues),
                               rtol=rtol, atol=0)
    assert abs(rt.evalue - rj.evalue) <= rtol * abs(rj.evalue)
    assert len(rt.rhistory) == len(np.asarray(rj.rhistory))
    if vectors:
        assert_vectors(rj, rt, a, b)


def test_registry_matches_lis_tpu():
    assert set(T_FNS) == set(J_FNS) == set(STANDARD)


@pytest.mark.parametrize("opts", [
    "-e ii", "-e ii -i cg", "-e ii -i gmres", "-e ii -i cg -p jacobi",
    "-e ii -ef quad", "-e rqi -i minres", "-e pi -i bicgstab -f quad",
    "-e ii -i cgs -ef df", "-e rqi -i tfqmr"])
def test_inner_form_choice_matches_lis_tpu(opts):
    """The device loop and the host loop are chosen by the same rule."""
    jo = lis_tpu.EsolverOptions.from_string(opts)
    assert _raw_inner_ok(TEOptions.from_string(opts)) == _jit_inner_ok(jo)


# etest1 testmat.mtx -e <name> -etol 1e-8 -emaxiter 3000 (the reference
# binary): pi 7.365014 in 143 iterations, ii 0.1620281 in 13, cg in 24,
# cr in 32; lis_tpu and the port give pi in 142 (within 2 of the
# reference's count, as lis_tpu's own reference test allows)
ETEST1 = {"pi": (7.365014, 143), "ii": (0.1620281, 13),
          "cg": (0.1620281, 24), "cr": (0.1620281, 32)}


# RQI's inner solver: MINRES (see the module docstring)
INNER = {"rqi": " -i minres"}


@pytest.mark.parametrize("name", STANDARD)
def test_standard_names_match_lis_tpu(name):
    J, T, a = p2()
    rj, rt = run_both(f"-e {name} -etol 1e-8 -emaxiter 3000"
                      + INNER.get(name, ""), J, T)
    assert rt.status == lis_tpu_torch.LIS_SUCCESS
    assert_same(rj, rt, a)
    if name in ETEST1:
        ev, it = ETEST1[name]
        assert abs(rt.evalue - ev) < 1e-5 * abs(ev)
        assert abs(rt.iters - it) <= 2


@pytest.mark.parametrize("name", [e for e in STANDARD if e != "pi"])
def test_default_tolerance_matches_lis_tpu(name):
    """-etol 1e-12 (the default); PI's count there rests on rounding (see
    the module docstring)."""
    J, T, a = p2()
    rj, rt = run_both(f"-e {name}" + INNER.get(name, ""), J, T)
    assert rt.status == lis_tpu_torch.LIS_SUCCESS
    assert_same(rj, rt, a)


@pytest.mark.parametrize("opts", [
    "-e li -ss 2", "-e li -ss 3", "-e ai -ss 2", "-e ai -ss 3",
    "-e li -ss 2 -rval true", "-e ai -ss 3 -rval true",
    "-e li -ss 2 -m 1", "-e ai -ss 2 -m 1 -etol 1e-9",
    "-e si -ie pi -etol 1e-8 -emaxiter 3000",
    "-e ii -shift 0.5", "-e cg -shift 0.1", "-e cr -shift 0.1",
    "-e si -shift 0.3 -etol 1e-10", "-e pi -emaxiter 50",
    "-e ii -ef quad -etol 1e-8",
    "-e ii -i cg", "-e ii -i gmres -p jacobi", "-e rqi -i gmres",
    "-e ii -i bicgstab -p ssor -etol 1e-10"])
def test_options_match_lis_tpu(opts):
    J, T, a = p2()
    rj, rt = run_both(opts, J, T)
    assert_same(rj, rt, a)


def test_rqi_default_inner_gives_an_eigenpair():
    """-e rqi with its default inner BiCG rests on rounding (module
    docstring): both packages end in SUCCESS, and the port's pair is an
    eigenpair of A."""
    J, T, a = p2()
    rj, rt = run_both("-e rqi -etol 1e-8", J, T)
    assert rj.status == rt.status == lis_tpu_torch.LIS_SUCCESS
    w = np.linalg.eigvalsh(a)
    assert np.abs(w - rt.evalue).min() < 1e-8
    x = rt.evectors[0]
    assert np.linalg.norm(a @ x - rt.evalue * x) < 1e-7


def test_rqi_default_from_ones_on_poisson3d27():
    """-e rqi as users run it (inner BiCG, x0 = ones) on poisson3d27 16³
    in DIA, the operator of chip_smoke.py's phase 14: both packages end in
    SUCCESS on an eigenvalue of the closed-form spectrum 27 − c_i c_j c_k,
    c_m = 1 + 2cos(mπ/17).  Their counts are not compared: they rest on
    rounding (module docstring)."""
    from lis_tpu.utils.testmat import poisson3d27_dia as j_p3
    from lis_tpu_torch.utils.testmat import poisson3d27_dia as t_p3
    c = 1.0 + 2.0 * np.cos(np.arange(1, 17) * np.pi / 17)
    spectrum = (27.0 - c[:, None, None] * c[None, :, None]
                * c[None, None, :]).ravel()
    rj, rt = run_both("-e rqi -etol 1e-8", j_p3(16, 16, 16),
                      t_p3(16, 16, 16, device="cpu"))
    for r in (rj, rt):
        assert r.status == lis_tpu_torch.LIS_SUCCESS
        assert np.abs(spectrum - r.evalue).min() <= 1e-8 * abs(r.evalue)


def test_initial_vector_when_initx_ones_false():
    J, T, a = p2()
    x0 = np.random.default_rng(3).standard_normal(a.shape[0])
    for opts in ("-e ii -initx_ones false -etol 1e-10",
                 "-e cr -initx_ones false",
                 "-e rqi -i minres -initx_ones false -etol 1e-8"):
        rj, rt = run_both(opts, J, T, x0=x0)
        assert_same(rj, rt, a)
    # -initx_ones true (the default) replaces a given x0 by ones
    rj, rt = run_both("-e ii", J, T, x0=x0)
    rt1 = lis_tpu_torch.esolve(T, options="-e ii")
    assert_same(rj, rt, a)
    assert rt.iters == rt1.iters and rt.evalue == rt1.evalue


@pytest.mark.parametrize("ss", [2, 3])
def test_si_later_pairs_against_the_math(ss):
    """SI -ss 2/3: the first pair as lis_tpu's; the later ones are the
    next smallest eigenvalues of A (the reference binary's etest1 -e si
    -ss 3 gives 0.162028, 0.398507, 0.398507), each an eigenpair."""
    J, T, a = p2()
    rj, rt = run_both(f"-e si -ss {ss} -etol 1e-8", J, T)
    assert rt.status == lis_tpu_torch.LIS_SUCCESS
    assert rt.iters_all[0] == rj.iters_all[0]
    assert abs(rt.evalues[0] - rj.evalues[0]) <= 1e-10 * rj.evalues[0]
    assert_vectors(rj, rt, a, pairs=[0])
    w = np.linalg.eigvalsh(a)
    np.testing.assert_allclose(rt.evalues, w[:ss], rtol=1e-7)
    np.testing.assert_allclose(rt.evalues, [0.162028, 0.398507,
                                            0.398507][:ss], atol=1e-6)
    for i in range(1, ss):
        x = rt.evectors[i]
        assert np.linalg.norm(a @ x - rt.evalues[i] * x) < 1e-6
        assert abs(np.dot(x, rt.evectors[0])) < 1e-6


def test_si_inner_pi_second_pair_against_the_math():
    """-ie pi -ss 2: lis_tpu's second pair starts from rounding noise
    and never converges (MAXITER, eigenvalue 0); the port's is the
    largest eigenvalue of A, which ones (the first pair's start) cannot
    reach."""
    J, T, a = p2()
    rj, rt = run_both("-e si -ie pi -ss 2 -etol 1e-8 -emaxiter 3000", J, T)
    assert rj.status == lis_tpu.LIS_MAXITER and rj.evalues[1] == 0.0
    assert rt.status == lis_tpu_torch.LIS_SUCCESS
    assert rt.iters_all[0] == rj.iters_all[0]
    w = np.linalg.eigvalsh(a)
    assert abs(rt.evalues[1] - w[-1]) < 1e-7


def _hermitian():
    """poisson2d 6x6 plus i·K, K real and antisymmetric on the ±1
    diagonals: Hermitian and banded (routed to DIA)."""
    ptr, idx, val = poisson2d(6, 6, device="cpu").to_csr_arrays()
    n = len(ptr) - 1
    k = sp.diags([0.3 * np.ones(n - 1), -0.3 * np.ones(n - 1)], [1, -1])
    a = sp.csr_matrix((val, idx, ptr), shape=(n, n)) + 1j * k
    assert np.allclose(a.toarray(), a.toarray().conj().T)
    return pair_of(a.tocsr())


@pytest.mark.parametrize("opts", ["-e pi -etol 1e-9", "-e ii -etol 1e-10",
                                  "-e ii -i gmres -etol 1e-10"])
def test_hermitian_complex_matches_lis_tpu(opts):
    J, T, a = _hermitian()
    rj, rt = run_both(opts, J, T)
    assert rt.status == lis_tpu_torch.LIS_SUCCESS
    assert rt.evector.is_complex()
    assert_same(rj, rt, a)
    w = np.linalg.eigvalsh(a)
    want = w[-1] if "pi" in opts else w[0]
    assert abs(rt.evalue - want) < 1e-7


def test_result_getters_and_device():
    J, T, a = p2()
    rt = lis_tpu_torch.esolve(T, options="-e li -ss 2")
    assert rt.evector.device.type == "cpu"
    assert rt.get_evalues() is rt.evalues
    assert rt.get_evectors().shape == (2, a.shape[0])
    assert list(rt.get_iters()) == list(rt.iters_all)
    assert len(rt.get_residualnorms()) == 2


def test_inverse_iteration_on_dia_rebuilds_nothing_on_the_host(monkeypatch):
    """II's host loop (-ef quad, and an inner -p) on a DIA shifts on the
    device: no host CSR is read and no matrix is rebuilt through scipy
    inside the outer loop."""
    from lis_tpu_torch.matrix.base import SparseMatrix
    from lis_tpu_torch.matrix.dia import DIAMatrix
    J, T, a = p2()
    D = lis_tpu_torch.auto_storage(T)
    assert D.format_name == "dia"

    def refuse(*args, **kw):
        raise AssertionError("a host rebuild inside the eigensolve")
    monkeypatch.setattr(SparseMatrix, "_rebuilt", refuse)
    monkeypatch.setattr(DIAMatrix, "to_csr_arrays", refuse)
    for opts in ("-e ii -ef quad -shift 0.1 -etol 1e-8",
                 "-e ii -i cg -p jacobi -shift 0.1 -etol 1e-8",
                 "-e rqi -i gmres -etol 1e-10"):
        rt = lis_tpu_torch.esolve(D, options=opts)
        assert rt.status == lis_tpu_torch.LIS_SUCCESS, opts
