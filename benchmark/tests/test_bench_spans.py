"""The readers of the program's spans and counters on a synthetic Chrome
trace: the idle split by ``lis.solve`` / ``lis.krylov`` adds up to
``idle_share``'s idle time and does not move when the device's clock is
offset from the host's, device work is charged to the ``lis.psolve`` span
open at its launch, a launch that pairs with no device operation reads
nothing, and a trace without the program's spans reads nothing."""

import pytest

from benchmark import devtrace, harness, spans

K = "void (anonymous namespace)::dia_kernel<double, double, false>(double)"
H = "void (anonymous namespace)::relax_kernel<double, double, false, 1>()"
ADD = "void at::native::vectorized_elementwise_kernel<2>()"
LAUNCH, COPY = "cudaLaunchKernel", "cudaMemcpyAsync"
NEW = ("iter_idle_us", "call_idle_ms", "psolve_span_share", "launch_host_us")


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _span(name, ts, te):
    return _x(name, "user_annotation", ts, te - ts)


def _op(name, ts, te, skew, host=LAUNCH, cat="kernel"):
    """A device operation, stamped ``skew`` us earlier by the device's
    clock, and the host call that queued it, as it reached the idle device
    at ``ts``."""
    return [_x(name, cat, ts - skew, te - ts), _x(host, "cuda_runtime", ts,
                                                  2.0)]


def _events(spans_on=True, extra=(), skew=0.0):
    ev = [_x(devtrace.WINDOW_SPAN, "user_annotation", 0.0, 1000.0)]
    if spans_on:
        ev += [_span("lis.solve", 100, 500), _span("lis.krylov", 150, 450),
               _span("lis.psolve", 200, 250), _span("lis.psolve", 300, 350),
               _span("lis.psolve", 305, 345),          # nested in the last
               _span("lis.solve", 600, 900), _span("lis.krylov", 650, 850)]
    ev += (_op(K, 120, 140, skew) + _op(K, 160, 210, skew)
           + _op(H, 220, 260, skew)     # launched inside a psolve
           + _op(ADD, 320, 400, skew)   # launched inside the nested psolves
           + _op(K, 460, 480, skew) + _op(K, 660, 840, skew)
           + _op("Memcpy DtoD", 880, 890, skew, COPY, "gpu_memcpy"))
    ev += [_x("aten::add", "cpu_op", 305, 10)]
    return ev + list(extra)


def _run(trace, iters=(3, 2)):
    return harness.Run(trace=trace, options="-i cg -p ssor -adds true",
                       traced_solves=[{"iters": i} for i in iters],
                       n=1000, nnd=27)


def _reset_counters():
    from lis_tpu_torch.utils import trace
    trace.reset_counters()


def test_idle_split_adds_up_to_the_idle_share():
    t = devtrace.Trace(_events())
    run = _run(t)
    krylov, call, between, calls = spans.idle_split(t)
    # gaps: 0-120, 140-160, 210-220, 260-320, 400-460, 480-660, 840-880,
    # 890-1000 against solves 100-500 and 600-900, iterations 150-450 and
    # 650-850
    assert (krylov, call, between, calls) == pytest.approx((150, 150, 300, 2))
    iter_idle = harness.reader("iter_idle_us")(run)
    call_idle = harness.reader("call_idle_ms")(run)
    assert iter_idle == pytest.approx(150 / 5)
    assert call_idle == pytest.approx(150 / 2 * 1e-3)
    idle = t.window_us * harness.reader("idle_share")(run) / 100
    assert iter_idle * 5 + call_idle * 1e3 * calls + between == \
        pytest.approx(idle)


def test_psolve_span_share_charges_work_to_the_span_open_at_launch():
    t = devtrace.Trace(_events())
    # H (40 us) and the add (80 us) of 400 us of device time
    assert spans.device_us_launched_in(t, spans.PSOLVE) == pytest.approx(
        (120, 400))
    assert harness.reader("psolve_span_share")(_run(t)) == pytest.approx(30)


@pytest.mark.parametrize("extra", [
    [_x(LAUNCH, "cuda_runtime", 500, 2.0)],        # a launch with no operation
    [_x(K, "kernel", 950, 10.0)],                  # an operation with no launch
])
def test_psolve_span_share_reads_nothing_where_counts_differ(extra):
    t = devtrace.Trace(_events(extra=extra))
    assert len(spans.launches(t)) != len(t.device)
    assert harness.reader("psolve_span_share")(_run(t)) is None


@pytest.mark.parametrize("skew", [30.0, -40.0])
def test_a_device_clock_offset_moves_no_span_reading(skew):
    """Device operations stamped by an offset clock (seen up to 2 ms on an
    H100) are read on the host's clock through their launches: only the
    window's edges, here outside every call, see the offset."""
    t0, t = devtrace.Trace(_events()), devtrace.Trace(_events(skew=skew))
    k0, c0, b0, n0 = spans.idle_split(t0)
    k, c, b, n = spans.idle_split(t)
    assert (k, c, n) == pytest.approx((k0, c0, n0))
    assert k + c + b == pytest.approx(t.window_us - t.busy_us())
    assert spans.device_us_launched_in(t, spans.PSOLVE) == pytest.approx(
        spans.device_us_launched_in(t0, spans.PSOLVE))
    # the gaps laid on the device's own clock would have moved idle time
    # across the calls' edges
    gaps = t.idle_gaps()
    in_solve = spans.intersect(gaps, spans.intervals(t, spans.SOLVE))
    in_loop = spans.intersect(gaps, spans.intervals(t, spans.KRYLOV))
    plain = [sum(e - s for s, e in ivs) for ivs in (in_loop, in_solve)]
    assert (plain[0], plain[1] - plain[0]) != pytest.approx((k, c))


def test_launch_host_us_reads_the_programs_counters():
    from torch.profiler import ProfilerActivity, profile

    from lis_tpu_torch.utils import trace
    t = devtrace.Trace(_events())
    _reset_counters()
    assert harness.reader("launch_host_us")(_run(t)) is None
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count("launch.host_ns", 12_000)
        trace.count("launch.calls", 3)
    assert harness.reader("launch_host_us")(_run(t)) == pytest.approx(4.0)
    # untraced runs read no per-layer metric
    assert harness.reader("launch_host_us")(_run(None)) is None
    _reset_counters()


def test_launch_host_us_reads_nothing_from_a_program_without_counters(
        monkeypatch):
    from lis_tpu_torch.utils import trace
    monkeypatch.delattr(trace, "counters")
    t = devtrace.Trace(_events())
    assert harness.reader("launch_host_us")(_run(t)) is None


@pytest.mark.parametrize("name", NEW)
def test_new_readers_find_nothing_without_the_programs_spans(name):
    _reset_counters()
    bare = devtrace.Trace(_events(spans_on=False))
    assert spans.idle_split(bare) is None
    assert harness.reader(name)(_run(bare)) is None
    assert harness.reader(name)(_run(None)) is None
