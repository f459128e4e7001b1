"""The Harwell-Boeing, Lis native, PLAIN and binary MatrixMarket I/O
against lis_tpu's.

Every writer's file is byte-equal to lis_tpu's for the same matrix,
vectors and title: MatrixMarket ASCII and binary in both byte orders,
Lis native, Harwell-Boeing (RUA and CUA), and the vectors as MatrixMarket,
PLAIN, Lis ASCII (one and three sections) and Lis binary big and little
endian.  Every reader reads lis_tpu's files to equal arrays, including
Harwell-Boeing's symmetric, Hermitian and pattern types; ``lis_input``
and ``lis_input_vector`` dispatch on the file; ``lsolve`` on an HB or a
Lis file takes the MatrixMarket file's count.
"""

import re

import numpy as np
import pytest
import scipy.sparse as sp

import lis_tpu
import lis_tpu.io as jio
import lis_tpu.cli.lsolve as jlsolve
import lis_tpu_torch
import lis_tpu_torch.io as tio
import lis_tpu_torch.cli.lsolve as tlsolve


def matrix(cplx=False, n=37, seed=0):
    """(scipy CSR, lis_tpu CSR, port CSR): a nonsymmetric sparse matrix
    with a full diagonal."""
    rng = np.random.default_rng(seed)
    a = sp.random(n, n, density=0.15, random_state=rng, format="csr")
    if cplx:
        a = a + 1j * sp.random(n, n, density=0.1, random_state=rng,
                               format="csr")
    a = (a + sp.eye(n) * 5).tocsr()
    a.sort_indices()
    args = (a.indptr, a.indices, a.data, a.shape)
    return (a, lis_tpu.CSRMatrix.from_csr_arrays(*args),
            lis_tpu_torch.CSRMatrix.from_csr_arrays(*args, device="cpu"))


def vector(n, cplx=False, seed=1):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    return v + 1j * rng.standard_normal(n) if cplx else v


def same_arrays(T, J):
    assert T.shape == J.shape
    for g, w in zip(T.to_csr_arrays(), J.to_csr_arrays()):
        w = np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fmt", ["mm", "mmb", "mmb_big", "lis", "hb"])
@pytest.mark.parametrize("vectors", [False, True], ids=["A", "Abx"])
def test_matrix_writers_byte_equal_and_read_back(tmp_path, monkeypatch,
                                                 fmt, vectors):
    a, J, T = matrix()
    b, x = (vector(a.shape[0]), vector(a.shape[0], seed=2)) if vectors \
        else (None, None)
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    if fmt == "mmb_big":
        monkeypatch.setattr(np, "little_endian", False)
        tio.write_matrix_market(pt, T, binary=True, b=b, x=x)
        jio.write_matrix_market(pj, J, binary=True, b=b, x=x)
        monkeypatch.undo()
    else:
        jio.lis_output(pj, J, b, x, fmt=fmt)
        tio.lis_output(pt, T, b, x, fmt=fmt)
    assert read_bytes(pt) == read_bytes(pj)
    # the port reads lis_tpu's file like lis_tpu does, onto the device asked
    Jr, bj, xj = jio.lis_input(pj)
    Tr, bt, xt = tio.lis_input(pj, device="cpu")
    assert Tr.device.type == "cpu"
    same_arrays(Tr, Jr)
    same_arrays(Tr, J)
    for got, want in ((bt, bj), (xt, xj)):
        assert (got is None) == (want is None)
        if got is not None:
            assert got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if vectors and fmt != "hb":
        np.testing.assert_array_equal(bt.numpy(), b)


@pytest.mark.parametrize("fmt", ["mm", "hb", "lis"])
def test_complex_matrix_writers_byte_equal(tmp_path, fmt):
    """Complex values: MatrixMarket and CUA read back; the Lis triplet
    file holds lis_tpu's "(re+imj)" text, which neither package reads."""
    a, J, T = matrix(cplx=True)
    b = vector(a.shape[0], cplx=True)
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    jio.lis_output(pj, J, b=b if fmt == "lis" else None, fmt=fmt)
    tio.lis_output(pt, T, b=b if fmt == "lis" else None, fmt=fmt)
    assert read_bytes(pt) == read_bytes(pj)
    if fmt != "lis":
        same_arrays(tio.lis_input(pj, device="cpu")[0], J)


def test_hb_title_and_key(tmp_path):
    a, J, T = matrix()
    pj, pt = str(tmp_path / "j.rua"), str(tmp_path / "t.rua")
    jio.write_harwell_boeing(pj, J, title="a title", key="KEY1")
    tio.write_harwell_boeing(pt, T, title="a title", key="KEY1")
    assert read_bytes(pt) == read_bytes(pj)


@pytest.mark.parametrize("mxtype", ["RSA", "CSA", "CHA", "PUA", "PSA"])
def test_hb_symmetric_and_pattern_types(tmp_path, mxtype):
    """An RUA/CUA file of the lower triangle retyped: the symmetric and
    Hermitian types mirror it, the pattern types read ones."""
    a, J, _ = matrix(cplx=mxtype[0] == "C")
    low = sp.tril(a + a.T).tocsr()
    low.sort_indices()
    path = str(tmp_path / "m.hb")
    jio.write_harwell_boeing(path, lis_tpu.CSRMatrix.from_csr_arrays(
        low.indptr, low.indices, low.data, low.shape))
    with open(path) as f:
        lines = f.readlines()
    lines[2] = mxtype + lines[2][3:]
    with open(path, "w") as f:
        f.writelines(lines)
    for fmt in ("csr", "csc", "jad"):
        Jm = jio.read_harwell_boeing(path, fmt)
        Tm = tio.read_harwell_boeing(path, fmt, device="cpu")
        assert Tm.format_name == fmt
        same_arrays(Tm, Jm)
    assert Tm.nnz > low.nnz if mxtype[1] == "S" or mxtype == "CHA" \
        else Tm.nnz == low.nnz


@pytest.mark.parametrize("fmt,kw", [
    ("mm", {}), ("plain", {}), ("lis", {}), ("lis", {"nprocs": 3}),
    ("lisb", {}), ("lisl", {"nprocs": 2}), ("lis_complex", {"nprocs": 2}),
    ("lisb_complex", {})])
def test_vector_writers_byte_equal_and_read_back(tmp_path, fmt, kw):
    cplx = fmt.endswith("_complex")
    fmt = fmt.split("_")[0]
    v = vector(41, cplx=cplx, seed=4)
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    jio.lis_output_vector(pj, v, fmt=fmt, **kw)
    tio.lis_output_vector(pt, v, fmt=fmt, **kw)
    assert read_bytes(pt) == read_bytes(pj)
    got = tio.lis_input_vector(pj, device="cpu")
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jio.lis_input_vector(pj)))
    if fmt != "plain":
        np.testing.assert_array_equal(got.numpy(), v)


def test_vector_of_a_lis_matrix_file_and_lis_errors(tmp_path):
    a, J, T = matrix()
    b = vector(a.shape[0], seed=9)
    path = str(tmp_path / "m.lis")
    jio.write_lis_file(path, J, b=b)
    np.testing.assert_array_equal(
        tio.lis_input_vector(path, device="cpu").numpy(), b)
    short = str(tmp_path / "short.lis")
    with open(short, "w") as f:
        f.write("#LIS A vec\n2\n# 0 2\n1.0 2.0\n")
    for read in (jio.read_lis_vector, tio.read_lis_vector):
        with pytest.raises(ValueError, match="PE sections"):
            read(short)
    with open(short, "w") as f:
        f.write("#LIS A vec\n1\n# 0 3\n1.0 2.0\n")
    with pytest.raises(ValueError, match="truncated"):
        tio.read_lis_vector(short)
    jio.lis_output_vector(short, vector(8), fmt="lisb")
    with open(short, "r+b") as f:
        f.truncate(40)
    with pytest.raises(ValueError, match="truncated"):
        tio.read_lis_vector(short)


def test_binary_mm_truncated_and_complex(tmp_path):
    a, J, T = matrix()
    path = str(tmp_path / "m.mtx")
    tio.write_matrix_market(path, T, binary=True, b=vector(37))
    data = read_bytes(path)
    with open(path, "wb") as f:
        f.write(data[:-20])
    with pytest.raises(ValueError, match="truncated"):
        tio.read_matrix_market(path, return_vectors=True, device="cpu")
    with pytest.raises(ValueError, match="real values only"):
        tio.write_matrix_market(path, matrix(cplx=True)[2], binary=True)


def _iterations(out):
    return int(re.search(r"number of iterations = (\d+)", out).group(1))


def test_lsolve_reads_hb_and_lis_files(tmp_path, capsys):
    """lsolve on the same matrix as MatrixMarket, Harwell-Boeing, Lis and
    binary MatrixMarket: the MM file's count, which is lis_tpu's."""
    a, J, T = matrix(n=120, seed=5)
    args = ["1", "-i", "bicgstab", "-p", "ilu", "-tol", "1e-10"]
    counts = {}
    for fmt in ("mm", "hb", "lis", "mmb"):
        path = str(tmp_path / f"a.{fmt}")
        tio.lis_output(path, T, fmt=fmt)
        assert tlsolve.main([path] + args, device="cpu") == 0
        counts[fmt] = _iterations(capsys.readouterr().out)
    assert jlsolve.main([str(tmp_path / "a.mm")] + args) == 0
    want = _iterations(capsys.readouterr().out)
    assert counts == dict.fromkeys(counts, want)
