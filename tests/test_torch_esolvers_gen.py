"""The generalized eigensolvers of lis_tpu_torch (gesolve, Ax = λBx)
against lis_tpu's and scipy's, on the CPU.

A is poisson2d 8x8 (n = 64) and B = diag(linspace(1, 2, 64)); both go in
as CSR, and both packages route them to DIA.  Each of the eight g-names
(gpi, gii, grqi, gcg, gcr, gli, gai, gsi) gets the same numpy inputs in
both packages and is held to lis_tpu as ``test_torch_esolvers.py`` holds
the standard forms (status, outer counts, eigenvalues to 1e-10 relative,
eigenvectors to 1e-8 up to sign), and its eigenvalue to
``scipy.linalg.eigh(A, B)``: the largest for gpi, gli and gai, the
smallest for the others.  gsi runs one pair: its later pairs deflate
with the Euclidean inner product, whose fixed point is not an
eigenvector of the pencil (lis_tpu ends them in MAXITER as well).
"""

import numpy as np
import pytest
import scipy.linalg as sl
import scipy.sparse as sp

import lis_tpu
import lis_tpu_torch
from tests.test_torch_esolvers import assert_same, p2, pair_of, run_both

GEN = ("gpi", "gii", "grqi", "gcg", "gcr", "gli", "gai", "gsi")
LARGEST = ("gpi", "gli", "gai")

_PENCIL = {}


def pencil():
    """(JA, TA, a, JB, TB, b, w): both packages' A and B, dense copies,
    and scipy's eigenvalues of the pencil, ascending."""
    if not _PENCIL:
        JA, TA, a = p2(8)
        n = a.shape[0]
        JB, TB, b = pair_of(sp.diags(np.linspace(1.0, 2.0, n)).tocsr())
        _PENCIL["p"] = (JA, TA, a, JB, TB, b, sl.eigh(a, b, eigvals_only=True))
    return _PENCIL["p"]


def _scipy_pair(name, w):
    return w[-1] if name in LARGEST else w[0]


@pytest.mark.parametrize("name", GEN)
def test_generalized_names_match_lis_tpu_and_scipy(name):
    JA, TA, a, JB, TB, b, w = pencil()
    # grqi's inner MINRES: with BiCG its path rests on rounding, as -e rqi
    # does (test_torch_esolvers.py)
    opts = f"-e {name}" + (" -i minres -etol 1e-10" if name == "grqi"
                           else "")
    rj, rt = run_both(opts, JA, TA, JB, TB)
    assert rt.status == lis_tpu_torch.LIS_SUCCESS
    assert_same(rj, rt, a, b)
    want = _scipy_pair(name, w)
    assert abs(rt.evalue - want) <= 1e-8 * abs(want), (rt.evalue, want)


@pytest.mark.parametrize("opts", ["-e ii", "-e li -ss 2", "-e ai -ss 2",
                                  "-e cr -shift 0.05",
                                  "-e ii -i gmres -p jacobi -etol 1e-10",
                                  "-e pi -i gmres -etol 1e-8"])
def test_standard_name_with_b_is_generalized(opts):
    """A B turns -e ii into gii (gesolve's name logic), in both packages;
    the inner -p takes the host loop through the driver."""
    JA, TA, a, JB, TB, b, w = pencil()
    rj, rt = run_both(opts, JA, TA, JB, TB)
    assert rt.status == lis_tpu_torch.LIS_SUCCESS
    assert_same(rj, rt, a, b)


def test_gii_answers_the_pencil_not_a():
    """The B of gesolve changes the answer: gii's pair satisfies
    Ax = λBx, and its eigenvalue is not A's smallest."""
    JA, TA, a, JB, TB, b, w = pencil()
    r = lis_tpu_torch.gesolve(TA, TB, options="-e gii -etol 1e-10")
    x = r.evectors[0]
    assert np.linalg.norm(a @ x - r.evalue * (b @ x)) < 1e-9
    assert abs(r.evalue - np.linalg.eigvalsh(a)[0]) > 1e-3


def test_estorage_converts_both_matrices():
    """-estorage 5 (ELL, a ported format): the same answer as the routed
    default, in lis_tpu's counts."""
    JA, TA, a, JB, TB, b, w = pencil()
    rj, rt = run_both("-e gii -estorage 5 -etol 1e-10", JA, TA, JB, TB)
    assert_same(rj, rt, a, b)
    rd = lis_tpu_torch.gesolve(TA, TB, options="-e gii -etol 1e-10")
    assert abs(rt.evalue - rd.evalue) <= 1e-10 * abs(rd.evalue)
    assert abs(rt.evalue - w[0]) <= 1e-8 * w[0]


@pytest.mark.parametrize("sid", [7, 8])
def test_estorage_block_formats_match_lis_tpu(sid):
    """-estorage 7 / 8 (BSR, BSC) convert A and B in both packages and
    give lis_tpu's pair."""
    JA, TA, a, JB, TB, b, w = pencil()
    opts = f"-e gii -estorage {sid} -etol 1e-8"
    rj, rt = run_both(opts, JA, TA, JB, TB)
    assert rt.status == lis_tpu_torch.LIS_SUCCESS
    assert_same(rj, rt, a, b)
    assert abs(rt.evalue - w[0]) <= 1e-8 * w[0]


def test_unknown_esolver_raises():
    JA, TA, a, JB, TB, b, w = pencil()
    opts = lis_tpu_torch.EsolverOptions.from_string("-e ii")
    opts.esolver = "gxx"
    with pytest.raises(NotImplementedError, match="xx"):
        lis_tpu_torch.gesolve(TA, TB, options=opts)
