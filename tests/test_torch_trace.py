"""The layer spans and counters of ``lis_tpu_torch/utils/trace.py`` on the
CPU: under ``torch.profiler`` a ``solve`` exports one ``lis.solve`` span
holding one ``lis.krylov`` span, every psolve a ``lis.psolve`` span, and
the launch path writes ``launch.calls`` and ``launch.host_ns``; with no
profiler nothing is recorded and no ``record_function`` is entered.
"""

import json

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

import lis_tpu_torch
from lis_tpu_torch.ops import _cuda
from lis_tpu_torch.utils import trace
from lis_tpu_torch.utils.testmat import poisson3d27


def _spans(prof, tmp_path):
    """[(name, start, end)] of the exported ``lis.*`` spans, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith("lis.")),
                  key=lambda s: s[1])


def _traced_solve(tmp_path, options):
    A = poisson3d27(6, 6, 6, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = lis_tpu_torch.solve(A, np.ones(A.nrows), options=options)
    assert res.status == 0
    return res, _spans(prof, tmp_path)


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def test_profiler_flag_is_set_inside_a_profile():
    """The gate of every span and counter: a torch that stops setting this
    flag would silently record nothing."""
    assert autograd_profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
    assert autograd_profiler._is_profiler_enabled is False


def test_solve_exports_one_solve_span_holding_one_krylov_span(tmp_path):
    res, spans = _traced_solve(tmp_path, "-i cg -p ssor -adds true")
    solves, krylovs = _named(spans, "lis.solve"), _named(spans, "lis.krylov")
    assert len(solves) == 1 and len(krylovs) == 1
    assert _inside(krylovs[0], solves[0])
    # the iterations, and so every psolve, run inside the Krylov span
    for s in _named(spans, "lis.psolve"):
        assert _inside(s, krylovs[0])


def test_additive_schwarz_psolve_spans_nest_over_ssor(tmp_path):
    res, spans = _traced_solve(tmp_path,
                               "-i cg -p ssor -adds true -adds_iter 2")
    psolves = _named(spans, "lis.psolve")
    outer = [s for s in psolves
             if not any(o is not s and _inside(s, o) for o in psolves)]
    # CG applies M once an iteration
    assert res.iters >= 2 and len(outer) == res.iters
    for o in outer:
        inner = [s for s in psolves if s is not o and _inside(s, o)]
        assert len(inner) == 2 + 1          # x = M b, then adds_iter refinements
    assert len(psolves) == 4 * res.iters


@pytest.mark.parametrize("options, per_iter", [
    # folded into the fused DD CG step (core/ddcg.py); the id is the
    # case's established name
    pytest.param("-f quad -i cg -p jacobi", 0,
                 id="-f quad -i cg -p jacobi-2"),
    ("-f quad -i bicg -p jacobi", 4),   # psolve and psolveh once a limb
    ("-i cg -p jacobi", 0),             # folded into the fused CG step
])
def test_psolve_spans_per_iteration(tmp_path, options, per_iter):
    res, spans = _traced_solve(tmp_path, options)
    assert len(_named(spans, "lis.solve")) == 1
    assert len(_named(spans, "lis.krylov")) == 1
    assert res.iters >= 2
    assert len(_named(spans, "lis.psolve")) == per_iter * res.iters


def test_nothing_is_recorded_without_a_profiler(monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(autograd_profiler, "record_function", Counting)
    trace.reset_counters()
    A = poisson3d27(6, 6, 6, device="cpu")
    res = lis_tpu_torch.solve(A, np.ones(A.nrows),
                              options="-i cg -p ssor -adds true")
    assert res.status == 0 and res.iters > 0
    assert entered == []
    assert trace.counters() == {}
    # the replacement is what a span would enter under a profiler
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("lis.x"):
            pass
    assert entered == ["lis.x"]


class _FakeLib:
    def lis_fake(self, *args):
        return 0

    def lis_cuda_error_string(self, rc):
        return b"fake"


class _FakeCudaTensor:
    """What ``check`` reads of a CUDA operand."""
    is_cuda = True
    dtype = torch.float64

    def is_contiguous(self):
        return True

    def is_conj(self):
        return False

    def is_neg(self):
        return False

    def numel(self):
        return 4

    def data_ptr(self):
        return 256


def test_launch_path_counts_only_under_a_profiler(monkeypatch):
    monkeypatch.setattr(_cuda, "_lib", _FakeLib())
    t = _FakeCudaTensor()
    trace.reset_counters()
    _cuda.check(t, "t", torch.float64, 4)
    _cuda.launch("lis_fake", 1, 2)
    assert trace.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        _cuda.check(t, "t", torch.float64, 4)
        _cuda.launch("lis_fake", 1, 2)
        _cuda.launch("lis_fake")
    got = trace.counters()
    assert set(got) == {"launch.calls", "launch.host_ns"}
    assert got["launch.calls"] == 2 and got["launch.host_ns"] > 0
    _cuda.launch("lis_fake")
    assert trace.counters() == got
    trace.reset_counters()
    assert trace.counters() == {}


def test_span_forms_pass_values_and_errors(tmp_path):
    @trace.span("lis.f")
    def f(a, b=1):
        """doc"""
        return a + b

    assert f(1) == 2 and f.__name__ == "f" and f.__doc__ == "doc"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert f(2, b=3) == 5
        with pytest.raises(ValueError):
            with trace.span("lis.g"):
                raise ValueError("inside")
        with trace.span("lis.h") as s:
            assert s.name == "lis.h"
    names = [n for n, _, _ in _spans(prof, tmp_path)]
    assert sorted(names) == ["lis.f", "lis.g", "lis.h"]
    # counters() hands out a copy
    trace.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count("x", 3)
    c = trace.counters()
    c["x"] = 0
    assert trace.counters() == {"x": 3}
    trace.reset_counters()
