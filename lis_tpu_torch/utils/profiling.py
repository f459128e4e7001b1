"""Tracing / profiling utilities (the reference's aux subsystem).

Port of ``lis_tpu/utils/profiling.py``.  Reference: per-function debug
tracing (LIS_DEBUG_FUNC_IN/OUT, include/lis.h:286-292 →
lis_debug_trace_func src/system/lis_error.c:67), solver phase timers
(time/itime/ptime/p_c_time/p_i_time, lis.h:747-751), and the spmvtest
comm-vs-comp split.

Here: a PhaseTimer whose phases can wait for a tensor's device to finish
(``sync``), and ``profile_trace``, a ``torch.profiler`` window over CPU
and CUDA activity that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from collections import defaultdict

import torch

_trace_enabled = os.environ.get("LIS_TPU_DEBUG_TRACE") == "1"


def set_trace(on: bool):
    global _trace_enabled
    _trace_enabled = on


def traced(fn):
    """Per-function enter/exit trace (LIS_DEBUG_FUNC_IN/OUT analogue)."""
    @functools.wraps(fn)
    def wrapper(*a, **kw):
        if _trace_enabled:
            print(f"IN  : {fn.__module__}.{fn.__qualname__}")
        try:
            return fn(*a, **kw)
        finally:
            if _trace_enabled:
                print(f"OUT : {fn.__module__}.{fn.__qualname__}")
    return wrapper


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def sync(x):
    """Wait until the devices of the tensors in ``x`` (a tensor, or a
    list, tuple or dict of them) have finished their queued work; returns
    ``x``."""
    for dev in {t.device for t in _tensors(x)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return x


class PhaseTimer:
    """Accumulating phase timers (itime/ptime/p_c_time... analogue).

    >>> t = PhaseTimer()
    >>> with t.phase("precon"):
    ...     M = create_precon(...)
    >>> t.report()
    """

    def __init__(self):
        self.times = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_value=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_value is not None:
                sync(sync_value)
            self.times[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self, file=None):
        for name, t in sorted(self.times.items(), key=lambda kv: -kv[1]):
            print(f"{name:24s}: {t:.6e} s ({self.counts[name]} calls)",
                  file=file)


_TRACE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "lis_tpu_torch", "trace")


@contextlib.contextmanager
def profile_trace(logdir: str = _TRACE_DIR):
    """Capture a ``torch.profiler`` trace around a region and write it to
    ``logdir/trace.json`` as a Chrome trace (the gprof analogue; the
    default directory is ``build/lis_tpu_torch/trace`` at the repository
    root).  It records the host's activity, and the card's where the
    default device is one.  Yields the profiler, whose ``key_averages()``
    and ``events()`` the caller may read after the region."""
    from torch.profiler import ProfilerActivity, profile
    from lis_tpu_torch.config import default_device
    acts = [ProfilerActivity.CPU]
    if default_device().type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
