"""The port's default device.

A matrix built from host arrays lives on ``config.default_device()``,
which is ``cuda`` unless ``set_default_device`` changed it; ``device="cpu"``
asks for the host.  Nothing probes for a card and nothing falls back to
the CPU: without a card, a constructor that was given no device raises
torch's own CUDA error.  ``solve()`` runs where its matrix lives.
"""

import numpy as np
import pytest
import torch

import lis_tpu_torch
from lis_tpu_torch import config
from lis_tpu_torch.interop.state import from_numpy_state
from lis_tpu_torch.matrix.base import TensorFields
from lis_tpu_torch.matrix.cst import CSTMatrix
from lis_tpu_torch.ops.shuffle import plan_shuffle
from tests.test_torch_cst import spd

_ARGS = {}


def _args():
    if not _ARGS:
        a = spd(1 << 14, 3)
        _ARGS["a"] = (a.indptr, a.indices, a.data, a.shape)
    return _ARGS["a"]


def _csr(**kw):
    return lis_tpu_torch.CSRMatrix.from_csr_arrays(*_args(), **kw)


def _cst(**kw):
    return CSTMatrix.from_csr_arrays(*_args(), **kw)


def _converted(**kw):
    return lis_tpu_torch.convert_matrix(_csr(device="cpu"), "cst", **kw)


def _same_format(**kw):
    return lis_tpu_torch.convert_matrix(_csr(device="cpu"), "csr", **kw)


def _jacobi_state(**kw):
    return from_numpy_state("jacobi", {"dinv": np.ones(8)}, **kw)


def _plan_state(**kw):
    idx = np.zeros((128, 128), dtype=np.uint8)
    return from_numpy_state("plan", {"idxs": [idx], "small": None},
                            {"meta": ((128, 1),), "M": 16384}, **kw)


def _plan(**kw):
    perm = np.random.default_rng(0).permutation(1 << 15)
    return plan_shuffle(perm, validate=False, **kw)


MAKERS = [_csr, _cst, _converted, _same_format, _jacobi_state,
          _plan_state, _plan]


def _devices(obj):
    """The device type of every tensor under a tensor dataclass."""
    out = set()

    def walk(v):
        if isinstance(v, torch.Tensor):
            out.add(v.device.type)
        elif isinstance(v, tuple):
            for e in v:
                walk(e)
        elif isinstance(v, TensorFields):
            for e in vars(v).values():
                walk(e)

    walk(obj)
    return out


def test_default_device_is_cuda():
    assert config.default_device() == torch.device("cuda")
    assert lis_tpu_torch.default_device() == torch.device("cuda")
    assert config.resolve_device(None) == torch.device("cuda")
    assert config.resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("build", MAKERS, ids=lambda f: f.__name__)
def test_device_cpu_gives_cpu_tensors(build):
    obj = build(device="cpu")
    assert _devices(obj) == {"cpu"} and obj.device == torch.device("cpu")


@pytest.mark.parametrize("build", MAKERS, ids=lambda f: f.__name__)
def test_no_device_means_the_card(build):
    """Without a card the constructor raises torch's CUDA error (an
    AssertionError from a CPU-only torch, a RuntimeError otherwise) and
    hands back no CPU matrix; with one, every tensor lives on it."""
    if torch.cuda.is_available():
        assert _devices(build()) == {"cuda"}
        return
    with pytest.raises((AssertionError, RuntimeError), match="(?i)cuda"):
        build()


def test_set_default_device_round_trips():
    prev = config.set_default_device("cpu")
    try:
        assert prev == torch.device("cuda")
        assert config.default_device() == torch.device("cpu")
        assert all(_devices(build()) == {"cpu"} for build in MAKERS)
    finally:
        assert config.set_default_device(prev) == torch.device("cpu")
    assert config.default_device() == torch.device("cuda")


@pytest.mark.parametrize("storage", ["-storage cst", "-auto_storage false"])
def test_solve_runs_where_the_matrix_lives(storage):
    """solve() moves numpy b and x0 to A's device and converts the storage
    there: a CPU matrix is solved on the CPU although the default device
    is the card.  True residual <= 1e-9 at -tol 1e-10."""
    n = _args()[3][0]
    r = lis_tpu_torch.solve(_csr(device="cpu"), np.ones(n), x0=np.zeros(n),
                            options=f"-i cg -p jacobi {storage} -tol 1e-10")
    assert r.x.device.type == "cpu"
    assert r.status == lis_tpu_torch.LIS_SUCCESS and r.true_resid <= 1e-9


def test_scaling_rebuild_stays_on_the_matrix_device():
    """A format without its own scaling rebuilds through host CSR arrays
    (SparseMatrix.scale_rows); the rebuilt matrix stays on A's device."""
    A = _csr(device="cpu")
    d = torch.full((A.nrows,), 2.0, dtype=torch.float64)
    for B in (A.scale_rows(d), A.scale_symm(d)):
        assert _devices(B) == {"cpu"}
    x = torch.ones(A.ncols, dtype=torch.float64)
    torch.testing.assert_close(A.scale_rows(d).matvec(x), 2 * A.matvec(x),
                               rtol=1e-14, atol=1e-14)
