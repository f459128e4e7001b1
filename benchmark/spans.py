"""Reductions of the program's own spans over a ``devtrace.Trace``.

While a ``torch.profiler`` records, ``lis_tpu_torch`` marks three layers
with ``record_function`` spans (``user_annotation`` events, kept in
``Trace.host``): ``lis.solve`` (a whole ``solve`` call), ``lis.krylov``
(its iterations, inside ``lis.solve``) and ``lis.psolve`` (every
preconditioner application).  The spans are on the host's clock; device
operations are put on it by pairing each with the host call that launched
it, in order, which holds on one stream where the counts agree.  A program
without the spans, or a trace whose launches cannot be paired, leaves
every reduction here with nothing to read: each returns None.
"""

from __future__ import annotations

import bisect
import re

SOLVE, KRYLOV, PSOLVE = "lis.solve", "lis.krylov", "lis.psolve"
# host calls that put one operation on the device's queue
LAUNCH = re.compile(r"^(cudaLaunch\w*Kernel|cuLaunch\w*Kernel|cudaMemcpy"
                    r"|cudaMemset)")


def intervals(trace, name: str):
    """[(start, end)] of the union of the spans named ``name``, clipped to
    the window, in order; nested or touching spans merge."""
    spans = sorted((max(s, trace.start), min(e, trace.end))
                   for n, s, e in trace.host if n == name)
    out = []
    for s, e in spans:
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def intersect(a, b):
    """The intersection of two ordered lists of disjoint intervals, as
    such a list."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def covered(ivs, starts, s: float, e: float) -> float:
    """Length of [s, e] covered by the ordered disjoint intervals ``ivs``
    (``starts``: their starts)."""
    total = 0.0
    for a, b in ivs[max(0, bisect.bisect_right(starts, s) - 1):]:
        if a >= e:
            break
        total += max(0.0, min(b, e) - max(a, s))
    return total


def launches(trace):
    """Start times of the window's host calls that queue one device
    operation each, in order."""
    return sorted(s for n, s, _ in trace.host
                  if trace.start <= s <= trace.end and LAUNCH.match(n))


def paired_launches(trace):
    """The host start of the launch of each of ``trace.device``, paired in
    order (one stream), or None where the counts differ."""
    starts = launches(trace)
    return starts if starts and len(starts) == len(trace.device) else None


def host_idle_gaps(trace):
    """The window's device-idle gaps (``Trace.idle_gaps``, same lengths)
    on the host's clock, or None where launches and operations cannot be
    paired.  The trace stamps device operations and host events by two
    clocks, which were seen up to 2 ms apart on an H100.  An operation that
    ends a gap started as soon as its launch reached the idle device, so
    the gap moves by that operation's launch less its start; the gap after
    the last operation moves as the gap before it did."""
    starts = paired_launches(trace)
    if starts is None:
        return None
    gaps, t, d = [], trace.start, 0.0
    for i, (_, _, s, e) in enumerate(trace.device):
        if s > t:
            d = starts[i] - s
            gaps.append((t + d, s + d))
        t = max(t, e)
    if trace.end > t:
        gaps.append((t + d, trace.end + d))
    return gaps


def idle_split(trace):
    """Device-idle time (us) of the window in three parts, by the host's
    clock (``host_idle_gaps``): inside ``lis.krylov``, inside ``lis.solve``
    but outside ``lis.krylov``, and outside every ``lis.solve`` (between
    calls), with the number of calls (merged ``lis.solve`` spans):
    (krylov, call, between, calls).  None where the window has no
    ``lis.solve`` span or its gaps cannot be put on the host's clock."""
    if trace is None or not trace.device:
        return None
    solves = intervals(trace, SOLVE)
    gaps = host_idle_gaps(trace)
    if not solves or gaps is None:
        return None
    loops = intersect(solves, intervals(trace, KRYLOV))
    s_starts, l_starts = [a for a, _ in solves], [a for a, _ in loops]
    idle = in_solve = in_loop = 0.0
    for s, e in gaps:
        idle += e - s
        in_solve += covered(solves, s_starts, s, e)
        in_loop += covered(loops, l_starts, s, e)
    return in_loop, in_solve - in_loop, idle - in_solve, len(solves)


def device_us_launched_in(trace, name: str):
    """(device time of the operations launched while a span ``name`` was
    open, all device time), in us, or None where launches and operations
    cannot be paired or no span ``name`` exists."""
    if trace is None or not trace.device:
        return None
    spans, starts = intervals(trace, name), paired_launches(trace)
    if not spans or starts is None:
        return None
    span_starts = [a for a, _ in spans]

    def open_at(t):
        i = bisect.bisect_right(span_starts, t) - 1
        return i >= 0 and t <= spans[i][1]

    inside = sum(e - s for t, (_, _, s, e) in zip(starts, trace.device)
                 if open_at(t))
    return inside, trace.device_us()
