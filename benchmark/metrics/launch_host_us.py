"""launch_host_us: host time inside the kernel wrappers' ``check`` and
``launch`` (``ops/_cuda.py``) per launch of the port's kernels, in us:
the program's counters ``launch.host_ns`` over ``launch.calls``
(``lis_tpu_torch.utils.trace.counters()``), which count only while a
profiler records, that is in the traced window."""

import importlib


def read(run):
    if run.trace is None:
        return None
    try:
        trace = importlib.import_module("lis_tpu_torch.utils.trace")
    except ImportError:
        return None
    counters = getattr(trace, "counters", None)
    got = counters() if callable(counters) else {}
    calls = got.get("launch.calls", 0)
    if not calls:
        return None
    return got.get("launch.host_ns", 0) / calls * 1e-3
