"""The trace reductions and the device-trace readers on a synthetic
Chrome trace: busy time, idle gaps and their names, kernel names by
``layers.json``, and readers that find nothing return nothing."""

import pytest

from benchmark import devtrace, harness, roofline

E = ("void (anonymous namespace)::dia_kernel<double, double, false>"
     "(double const*, long const*, double const*, double*, long, long, int)")
M = ("void (anonymous namespace)::dia_kernel<double, false, false>"
     "(double const*, double const*, long const*, double const*)")
H = ("void (anonymous namespace)::relax_kernel<double, double, false, 1>"
     "(double const*, long const*, double const*)")
G3 = ("void (anonymous namespace)::update_kernel<double>(double*, double*, "
      "double const*)")
P = "void (anonymous namespace)::update_kernel<double>(int, double const*)"


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _trace():
    return devtrace.Trace([
        _x(devtrace.WINDOW_SPAN, "user_annotation", 0.0, 100.0),
        _x(E, "kernel", 10.0, 20.0),
        _x(H, "kernel", 25.0, 15.0),          # overlaps E: busy 10..40
        _x(G3, "kernel", 60.0, 10.0),
        _x("Memcpy DtoH", "gpu_memcpy", 90.0, 20.0),   # clipped at 100
        _x("aten::add", "cpu_op", 41.0, 18.0),
        _x("cudaLaunchKernel", "cuda_runtime", 45.0, 5.0),
        _x("aten::item", "cpu_op", 0.0, 9.0),
    ])


def test_busy_and_gaps():
    t = _trace()
    assert t.window_us == 100.0
    assert t.busy_us() == pytest.approx(30 + 10 + 10)
    assert t.idle_gaps() == [(0.0, 10.0), (40.0, 60.0), (70.0, 90.0)]
    names = dict(t.top_idle_gaps())
    # the gap 40..60 has its middle inside aten::add, not the launch
    assert names == pytest.approx({"aten::add": 20e-6, "aten::item": 10e-6,
                                   "host": 20e-6})


def test_kernel_names():
    t = _trace()
    assert t.kernel_of(E)[0] == "dia_spmv"
    assert t.kernel_of(M)[0] == "dd_dia_spmv"
    assert t.kernel_of(H) == ("dia_relax", "precon")
    assert t.kernel_of(G3)[0] == "cg_update"
    assert t.kernel_of(P)[0] == "dd_update"
    assert t.kernel_of("at::native::elementwise_kernel") == (None, None)
    assert t.layer_us("precon") == 15.0
    top = dict(t.top_device_ops())
    assert top["dia_spmv"] == pytest.approx(20e-6)
    assert top["gpu_memcpy"] == pytest.approx(10e-6)


def _run(trace, options="-i cg -p ssor -adds true", iters=10):
    return harness.Run(trace=trace, traced_solves=[{"iters": iters}],
                       options=options, n=1000, nnd=27)


def test_device_readers():
    t = _trace()
    run = _run(t)
    assert harness.reader("idle_share")(run) == pytest.approx(50.0)
    assert harness.reader("launches_per_iter")(run) == pytest.approx(0.3)
    assert harness.reader("psolve_share")(run) == pytest.approx(
        100 * 15 / 55)
    want = 100 * roofline.dia_spmv(1000, 27) / 20e-6
    assert harness.reader("dia_spmv_roofline")(run) == pytest.approx(want)
    # one H launch is no whole psolve (9 launches): nothing to read
    assert harness.reader("dia_relax_roofline")(run) is None


def test_readers_find_nothing_without_a_trace():
    empty = devtrace.Trace([_x(devtrace.WINDOW_SPAN, "user_annotation", 0,
                               10)])
    for name in ("idle_share", "launches_per_iter", "psolve_share",
                 "dia_spmv_roofline", "dia_relax_roofline",
                 "dd_dia_spmv_roofline"):
        assert harness.reader(name)(_run(None)) is None
        assert harness.reader(name)(_run(empty)) is None


def test_ssor_adds_psolve_bound():
    n = 192 ** 3
    bound, launches = roofline.ssor_adds_psolve(n, 27, 2, 1)
    assert launches == 9
    # 2 SSOR psolves of (13+3)+(13+4)+(13+4)+(13+5) and one residual of
    # 27+3: 166 n-vectors of float64 over 3.35 TB/s
    assert bound == pytest.approx(166 * n * 8 / 3.35e12)


def test_span_readers_find_nothing_in_records_without_spans():
    # an entry whose records carry no iterations or spans
    run = harness.Run(solves=[{"wall": 0.5, "status": 0}],
                      traced_solves=[], options="", n=1000, nnd=None,
                      window_s=1.0)
    for name in ("iters", "iter_ms", "solve_overhead_ms"):
        assert harness.reader(name)(run) is None
    assert harness.reader("solve_s")(run) == pytest.approx(1.0)
