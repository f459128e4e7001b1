"""A run of each cell on the CPU at a 12³ grid (the port's plain versions
of its kernels): the result line's keys, the reference agreeing with the
port, the control refused, and ``correct`` false under each fault the
cells can have, planted in the timed path.  ``run.py`` itself refuses to
measure without a CUDA device."""

import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness

MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
SMALL = {"grid": [12, 12, 12]}
SEED = 2 ** 31 + 977


def _run(cell, trace=False, control=False, seed=SEED):
    out, _ = harness.run_cell(cell, seed, 0.3, trace, "cpu",
                              time.perf_counter(), control=control,
                              overrides=SMALL)
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_cpu(cell):
    out = _run(cell)
    assert list(out)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} \
        <= set(out) <= {"correct", "attempted", "failed", "metrics",
                        "device", "breakdown", "checks"}
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert {"setup_s", "solve_s"} <= set(out["metrics"])
    for v in out["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    json.dumps(out)


def test_traced_run_has_per_layer_metrics_and_breakdown():
    out = _run("hpcg27-192.cg-jacobi", trace=True)
    assert {"iters", "iter_ms", "solve_overhead_ms"} <= set(out["metrics"])
    assert "setup_s" not in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_refused(cell):
    out = _run(cell, control=True)
    assert not out["correct"], out["checks"]


def _negate_one(x):
    y = x.clone()
    y[x.numel() // 3] = -y[x.numel() // 3]
    return y


FAULTS = {
    # the solve returns its start, x0 = 0
    "state_unchanged": lambda x, x0: x0.clone(),
    # half of the unknowns left out
    "half_left_out": lambda x, x0: torch.cat(
        [x[: x.numel() // 2], x0[x.numel() // 2:]]),
    # one unknown of the answer altered (its sign) where it is produced
    "answer_altered": lambda x, x0: _negate_one(x),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_in_the_timed_path_is_refused(cell, fault, monkeypatch):
    from lis_tpu_torch.solvers.base import SOLVER_FNS
    for name in ("cg", "cg_quad"):
        orig = SOLVER_FNS[name]

        def broken(A, b, x0, M, spec, _orig=orig, **kw):
            out = _orig(A, b, x0, M, spec, **kw)
            return out._replace(x=FAULTS[fault](out.x, x0))
        monkeypatch.setitem(SOLVER_FNS, name, broken)
    out = _run(cell)
    assert not out["correct"], out["checks"]


def test_run_py_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
