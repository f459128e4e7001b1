"""The device trace of a window, taken with ``torch.profiler`` from the
benchmark's own files, and the reductions the readers use.

``capture(fn)`` runs ``fn`` inside a profiler over CPU and CUDA activity
and a ``bench.window`` span, writes the Chrome trace to a temporary
directory (under ``TMPDIR``), reads it back and deletes it.  ``Trace``
holds the window's bounds, the device operations (kernels, copies, sets)
and the host events, in microseconds.  Kernels are named by the patterns
of ``layers.json``.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from collections import defaultdict

WINDOW_SPAN = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_HERE = os.path.dirname(os.path.abspath(__file__))


def load_kernel_table():
    """[(kernel, layer, compiled pattern)] in ``layers.json``'s order."""
    with open(os.path.join(_HERE, "layers.json")) as f:
        table = json.load(f)["kernels"]
    return [(k["kernel"], k["layer"], re.compile(k["pattern"])) for k in table]


def capture(fn):
    """(fn(), Trace of its run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return out, Trace(events)


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces and
    arguments, at most 60 characters."""
    name = re.sub(r"^void ", "", name)
    name = name.split("(")[0] if not name.startswith("(") else name
    name = name.replace("(anonymous namespace)::", "")
    return name[:60]


class Trace:
    def __init__(self, events):
        self.table = load_kernel_table()
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("name") == WINDOW_SPAN
                 and e.get("cat") in ("user_annotation", "cpu_op")]
        if spans:
            w = spans[0]
            self.start, self.end = float(w["ts"]), float(w["ts"]) + float(
                w["dur"])
        else:
            self.start = self.end = 0.0
        self.device = []      # (name, cat, start, end), clipped to window
        self.host = []        # (name, start, end)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat")
            ts, te = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if cat in DEVICE_CATS:
                ts, te = max(ts, self.start), min(te, self.end)
                if te > ts:
                    self.device.append((e.get("name", ""), cat, ts, te))
            elif cat in HOST_CATS and e.get("name") != WINDOW_SPAN:
                self.host.append((e.get("name", ""), ts, te))
        self.device.sort(key=lambda d: d[2])
        self._named = {}

    @property
    def window_us(self) -> float:
        return self.end - self.start

    def busy_us(self) -> float:
        """Length of the union of the device operations' intervals."""
        busy, cur_s, cur_e = 0.0, None, None
        for _, _, s, e in self.device:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def kernel_of(self, name: str):
        """(kernel, layer) of a kernel's symbol by ``layers.json``, or
        (None, None)."""
        if name not in self._named:
            self._named[name] = next(((k, lay) for k, lay, p in self.table
                                      if p.search(name)), (None, None))
        return self._named[name]

    def kernels(self):
        """[(symbol, duration us)] of every kernel in the window."""
        return [(n, e - s) for n, cat, s, e in self.device if cat == "kernel"]

    def kernel_times(self, kernel: str):
        """Durations (us) of every launch of ``kernel`` (a name of
        ``layers.json``)."""
        return [d for n, d in self.kernels() if self.kernel_of(n)[0] == kernel]

    def layer_us(self, layer: str) -> float:
        return sum(d for n, d in self.kernels()
                   if self.kernel_of(n)[1] == layer)

    def device_us(self) -> float:
        return sum(e - s for _, _, s, e in self.device)

    def top_device_ops(self, k: int = 10):
        """The k device operations (by kernel name, else short symbol)
        that took the most time: [[name, seconds]]."""
        tot = defaultdict(float)
        for n, cat, s, e in self.device:
            kern = self.kernel_of(n)[0] if cat == "kernel" else None
            tot[kern or (_short(n) if cat == "kernel" else cat)] += e - s
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n, us * 1e-6] for n, us in top]

    def idle_gaps(self):
        """[(start, end)] of the window's stretches with no device
        operation."""
        gaps, t = [], self.start
        for _, _, s, e in self.device:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.end > t:
            gaps.append((t, self.end))
        return gaps

    def top_idle_gaps(self, k: int = 10):
        """Idle time by what the host was doing: each gap is named by the
        innermost host event around its middle ("host" where none is),
        [[name, seconds]] for the k names with the most idle time."""
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        tot = defaultdict(float)
        for s, e in self.idle_gaps():
            mid = 0.5 * (s + e)
            hi = bisect.bisect_right(starts, mid)
            best = None
            # events are short; look back over the few that began before
            for name, hs, he in reversed(host[max(0, hi - 256):hi]):
                if he > mid and (best is None or he - hs < best[1]):
                    best = (name, he - hs)
            tot[best[0] if best else "host"] += e - s
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[n, us * 1e-6] for n, us in top]
