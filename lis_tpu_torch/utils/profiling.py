"""Profiling utilities (the reference's aux subsystem).

Port of ``lis_tpu/utils/profiling.py``.  Reference: solver phase timers
(time/itime/ptime/p_c_time/p_i_time, lis.h:747-751) and the spmvtest
comm-vs-comp split.  The per-function IN/OUT trace
(LIS_DEBUG_FUNC_IN/OUT) is ``utils/trace.py``'s ``@traced``.

Here: a PhaseTimer whose phases can wait for a tensor's device to finish
(``sync``), and ``profile_trace``, a ``torch.profiler`` window over CPU
and CUDA activity that writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


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
    default device is one, and the program's layer spans
    (``utils/trace.py``: ``lis.solve``, ``lis.krylov``, ``lis.psolve``)
    with them.  Yields the profiler, whose ``key_averages()`` and
    ``events()`` the caller may read after the region."""
    from torch.profiler import ProfilerActivity, profile
    from lis_tpu_torch.config import default_device
    acts = [ProfilerActivity.CPU]
    if default_device().type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
