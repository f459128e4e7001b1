"""Per-function debug trace.

Reference: the LIS_DEBUG_FUNC_IN/OUT macros (include/lis.h:286-292) call
lis_debug_trace_func (src/system/lis_error.c:67), printing an
indent-nested "IN : name" / "OUT: name" stream when the library is built
--enable-debug.  Here the equivalent is runtime-switchable: enable with
``lis_tpu_torch.utils.trace.set_debug_trace(True)`` or the environment
variable ``LIS_TPU_DEBUG=1``; the ``@traced`` decorator is free when
disabled (one bool check).  Port of ``lis_tpu/utils/trace.py``.

Layer spans and counters for ``torch.profiler``: ``span(name)`` marks a
region (``with span("lis.krylov"):``) or a function (``@span(...)``) with
``torch.profiler.record_function``, so the region lands in the profiler's
own trace as a ``user_annotation`` event, on the clock of the device
operations it launched; ``count(name, n)`` adds to a counter that
``counters()`` reads.  Both act only while a ``torch.profiler`` records
(``torch.autograd.profiler._is_profiler_enabled``, read at every call):
otherwise a span costs that one read and records nothing, and no counter
is written.  The program's spans: ``lis.solve`` (the whole of
``solvers/driver.py::solve``), ``lis.krylov`` (its execute section, the
part ``SolveResult.itime`` times) and ``lis.psolve`` (every
preconditioner's ``psolve`` and ``psolveh``, through ``psolve_span``);
its counters: ``launch.calls`` and ``launch.host_ns`` (host time inside
``ops/_cuda.py``'s ``check`` and ``launch``).
"""

from __future__ import annotations

import functools
import os
import sys

from torch.autograd import profiler as _profiler

_enabled = os.environ.get("LIS_TPU_DEBUG", "") not in ("", "0")
_depth = 0
_stream = sys.stderr


def set_debug_trace(on: bool, stream=None):
    """Toggle per-function enter/exit tracing (lis_error.c:67 analogue)."""
    global _enabled, _stream
    _enabled = bool(on)
    if stream is not None:
        _stream = stream


def debug_trace_enabled() -> bool:
    """True when LIS_DEBUG_FUNC-style call tracing is on (set_debug_trace /
    LIS_TPU_DEBUG env)."""
    return _enabled


def traced(fn):
    """Decorate an API entry point with IN/OUT trace lines."""
    name = f"{fn.__module__.split('.')[-1]}.{fn.__qualname__}"

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        global _depth
        if not _enabled:
            return fn(*args, **kwargs)
        print(f"{'  ' * _depth}IN : {name}", file=_stream)
        _depth += 1
        try:
            return fn(*args, **kwargs)
        finally:
            _depth -= 1
            print(f"{'  ' * _depth}OUT: {name}", file=_stream)

    return wrapper


# ---- spans and counters for torch.profiler ---------------------------------

_counters: dict[str, int] = {}


class span:
    """A ``record_function`` region named ``name`` while a profiler
    records, nothing otherwise.  As a context manager each ``with`` takes a
    new object (``with span("lis.krylov"): ...``); as a decorator
    (``@span("lis.psolve")``) it wraps every call of the function."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        rf, self._rf = self._rf, None
        if rf is not None:
            rf.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapper


# every preconditioner's psolve and psolveh
psolve_span = span("lis.psolve")


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler records."""
    if _profiler._is_profiler_enabled:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict:
    """A copy of the counters: {name: int}."""
    return dict(_counters)


def reset_counters() -> None:
    _counters.clear()
