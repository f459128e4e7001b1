"""The esolve, esolver, gesolve and gesolver command lines of
lis_tpu_torch against lis_tpu's, on the CPU.

Both packages read the same MatrixMarket files (poisson2d 8x8 and
B = diag(linspace(1, 2, 64)), written to ``tmp_path``) and run the same
argument lists.  Held equal: the exit code, the printed lines' labels and
iteration counts, the eigenvalues to 1e-10 relative (a line prints 16
digits, the last of which may differ), the residuals under the same
tolerance, and the evector file (header, length, values to 1e-8 up to
sign).
"""

import re

import numpy as np
import pytest
import scipy.sparse as sp

import lis_tpu_torch
from lis_tpu.cli import esolve as j_esolve, esolver as j_esolver
from lis_tpu.cli import gesolve as j_gesolve, gesolver as j_gesolver
from lis_tpu_torch.cli import esolve as t_esolve, esolver as t_esolver
from lis_tpu_torch.cli import gesolve as t_gesolve, gesolver as t_gesolver
from lis_tpu_torch.utils.testmat import poisson2d

CLIS = {"esolve": (j_esolve.main, t_esolve.main),
        "esolver": (j_esolver.main, t_esolver.main),
        "gesolve": (j_gesolve.main, t_gesolve.main),
        "gesolver": (j_gesolver.main, t_gesolver.main)}

_NUM = re.compile(r"[-+]?\d+\.\d+e[-+]\d+|\d+")


@pytest.fixture
def files(tmp_path):
    A = poisson2d(8, 8, device="cpu")
    n = A.nrows
    b = sp.diags(np.linspace(1.0, 2.0, n)).tocsr()
    B = lis_tpu_torch.CSRMatrix.from_csr_arrays(b.indptr, b.indices, b.data,
                                                b.shape, device="cpu")
    pa, pb = tmp_path / "a.mtx", tmp_path / "b.mtx"
    lis_tpu_torch.write_matrix_market(str(pa), A)
    lis_tpu_torch.write_matrix_market(str(pb), B)
    return tmp_path, str(pa), str(pb)


def run(fn, argv, capsys, **kw):
    rc = fn(list(argv), **kw)
    return rc, capsys.readouterr().out.splitlines()


def compare_lines(lj, lt, tol):
    assert len(lt) == len(lj), (lj, lt)
    for a, b in zip(lj, lt):
        assert _NUM.sub("#", a) == _NUM.sub("#", b), (a, b)
        na = [float(x) for x in _NUM.findall(a)]
        nb = [float(x) for x in _NUM.findall(b)]
        if "iterations" in a:
            assert na == nb, (a, b)
        elif "residual" in a:
            assert na[0] <= tol and nb[0] <= tol, (a, b)
        elif "mode" in a:         # mode k: evalue = ...  resid = ...
            assert na[0] == nb[0] and abs(nb[1] - na[1]) <= 1e-10 * abs(
                na[1]), (a, b)
        else:                     # the eigenvalue
            assert abs(nb[0] - na[0]) <= 1e-10 * abs(na[0]), (a, b)


def read_vec(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[:2], np.array([float(x) for x in lines[2:]])


@pytest.mark.parametrize("cli,args,tol", [
    ("esolve", ["A", "EV", "-e", "ii", "-etol", "1e-10"], 1e-10),
    ("esolve", ["A", "-e", "cg", "-etol", "1e-9"], 1e-9),
    ("esolver", ["A", "EV", "-e", "li", "-ss", "2", "-etol", "1e-10"],
     1e-9),
    ("gesolve", ["A", "B", "EV", "-e", "gii", "-etol", "1e-10"], 1e-10),
    ("gesolve", ["A", "B", "-e", "cr", "-etol", "1e-10"], 1e-10),
    ("gesolver", ["A", "B", "EV", "-e", "ai", "-ss", "2"], 1e-11),
])
def test_cli_matches_lis_tpu(files, capsys, cli, args, tol):
    tmp, pa, pb = files
    jmain, tmain = CLIS[cli]
    sub = {"A": pa, "B": pb}
    argj = [sub.get(a, str(tmp / "ev_j.mtx") if a == "EV" else a)
            for a in args]
    argt = [sub.get(a, str(tmp / "ev_t.mtx") if a == "EV" else a)
            for a in args]
    rcj, lj = run(jmain, argj, capsys)
    rct, lt = run(tmain, argt, capsys, device="cpu")
    assert rcj == rct == 0
    compare_lines(lj, lt, tol)
    if "EV" in args:
        hj, vj = read_vec(tmp / "ev_j.mtx")
        ht, vt = read_vec(tmp / "ev_t.mtx")
        assert hj == ht and len(vt) == len(vj) == 64
        s = np.sign(np.dot(vj, vt))
        np.testing.assert_allclose(s * vt, vj, rtol=0, atol=1e-8)


def test_cli_exit_codes_match_lis_tpu(files, capsys):
    """MAXITER's status is the exit code; a missing argument prints the
    usage and exits 1, in both packages."""
    tmp, pa, pb = files
    for cli, argv, rc in (("esolve", [pa, "-e", "pi", "-emaxiter", "5"],
                           lis_tpu_torch.LIS_MAXITER),
                          ("esolve", [], 1), ("gesolve", [pa, "-e", "ii"], 1),
                          ("gesolver", [pa], 1)):
        jmain, tmain = CLIS[cli]
        rcj, lj = run(jmain, argv, capsys)
        rct, lt = run(tmain, argv, capsys, device="cpu")
        assert rcj == rct == rc, (cli, argv, rcj, rct)
        if rct == 1:
            assert lj == lt and lt[0].startswith("Usage:")
        else:
            compare_lines(lj[:2], lt[:2], 1.0)
