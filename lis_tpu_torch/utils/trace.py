"""Per-function debug trace.

Reference: the LIS_DEBUG_FUNC_IN/OUT macros (include/lis.h:286-292) call
lis_debug_trace_func (src/system/lis_error.c:67), printing an
indent-nested "IN : name" / "OUT: name" stream when the library is built
--enable-debug.  Here the equivalent is runtime-switchable: enable with
``lis_tpu_torch.utils.trace.set_debug_trace(True)`` or the environment
variable ``LIS_TPU_DEBUG=1``; the ``@traced`` decorator is free when
disabled (one bool check).  Port of ``lis_tpu/utils/trace.py``.
"""

from __future__ import annotations

import functools
import os
import sys

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
