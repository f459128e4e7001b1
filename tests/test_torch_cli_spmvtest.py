"""The spmvtest command line of lis_tpu_torch against lis_tpu's, on the CPU.

Modes 1, 3b and 4 on tiny operators: the port prints the same ``matrix
size`` line and the same set of format rows as lis_tpu (every format of
the list; dns too, the operators being below 20000 rows), and every row's
MFLOPS is positive.  The times themselves are the CPU's and are not
compared.
"""

import re

import numpy as np
import pytest

from lis_tpu.cli import spmvtest as J
from lis_tpu_torch.cli import spmvtest as T
from lis_tpu_torch.io import write_matrix_market
from lis_tpu_torch.utils.testmat import poisson2d, tridiag

ROW = re.compile(r"^format = (\w+)\s*\(\s*(\d+)\), computation = (\S+) sec, "
                 r"\s*(\S+) MFLOPS$")


def _rows(text):
    rows = {}
    for ln in text.splitlines():
        m = ROW.match(ln)
        if m:
            rows[m.group(1).lower()] = (int(m.group(2)), float(m.group(3)),
                                        float(m.group(4)))
    return rows


def _sizes(text):
    return [ln for ln in text.splitlines() if ln.startswith("matrix size")]


def test_mode_3b_matches_lis_tpu(capsys):
    assert T.main(["3b", "4", "4", "3", "5"], device="cpu") == 0
    tout = capsys.readouterr().out
    assert J.main(["3b", "4", "4", "3", "5"]) == 0
    jout = capsys.readouterr().out
    assert "conversion failed" not in tout
    assert _sizes(tout) == _sizes(jout)
    assert len(_sizes(tout)) == 1 and "48 x 48" in _sizes(tout)[0]
    trows, jrows = _rows(tout), _rows(jout)
    assert set(trows) == set(jrows) == set(T.FORMATS)
    assert T.FORMATS == J.FORMATS
    for fmt, (idx, sec, mflops) in trows.items():
        assert idx == jrows[fmt][0] == T.FORMATS.index(fmt) + 1
        assert sec > 0 and mflops > 0 and np.isfinite(mflops)


def test_mode_1_rows(capsys):
    assert T.main(["1", "200", "4"], device="cpu") == 0
    out = capsys.readouterr().out
    assert _sizes(out) == ["matrix size = 200 x 200 (598 nonzero entries)"]
    rows = _rows(out)
    assert set(rows) == set(T.FORMATS)
    assert all(r[2] > 0 for r in rows.values())


def test_mode_4_list_file(tmp_path, capsys):
    paths, want = [], []
    for k, A in enumerate((tridiag(30, device="cpu"),
                           poisson2d(5, 6, device="cpu"))):
        p = tmp_path / f"m{k}.mtx"
        write_matrix_market(str(p), A)
        paths.append(str(p))
        want.append(f"matrix size = 30 x 30 ({A.nnz} nonzero entries)")
    lst = tmp_path / "list.txt"
    lst.write_text("\n".join(paths) + "\n")
    assert T.main(["4", str(lst), "3"], device="cpu") == 0
    out = capsys.readouterr().out
    assert _sizes(out) == want
    assert out.count("===") == 4
    assert len(_rows(out)) == len(T.FORMATS)
    assert sum(1 for ln in out.splitlines() if ROW.match(ln)) \
        == 2 * len(T.FORMATS)


def test_run_sweep_returns_mflops_and_skips_large_dns():
    from lis_tpu_torch.utils.testmat import poisson3d
    A = poisson3d(28, 28, 26, device="cpu")        # n = 20384 > 20000
    got = T.run_sweep(A, 2, formats=["csr", "dns", "dia"])
    assert set(got) == {"csr", "dia"} and min(got.values()) > 0


def test_usage_without_arguments(capsys):
    assert T.main([], device="cpu") == 1
    assert "Usage" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["2", "2b", "3"])
def test_other_grid_modes(mode, capsys):
    args = {"2": ["4", "5", "2"], "2b": ["4", "5", "2"],
            "3": ["3", "3", "3", "2"]}[mode]
    assert T.main([mode, *args], device="cpu") == 0
    rows = _rows(capsys.readouterr().out)
    assert set(rows) == set(T.FORMATS)
