"""One run of one cell: set-up, the timed window, the traced window, the
comparison and the result line.

Everything particular to a cell is found by name.  The configuration
(``configs/``) names its operator, ``operators/<operator>.py``, which
makes the program's operator from the configuration and gives the plain
reference's.  The traffic mix (``traffic/<traffic>.json``) names its
entry, ``entries/<entry>.py``: what the caller holds across calls, the
call the window makes, and the numbers the reference checks, which
``limits/<cell>.json`` bounds.  Each metric is ``metrics/<name>.py``.

Set-up (``setup_s``: process start to the first timed call): import the
port, build the program's operator on the device, make the pool of
right-hand sides, let the entry prepare what the caller holds, and make
one warm-up call, which loads (or, in a fresh checkout, builds) the
kernel library.

The window: one caller in a closed loop makes the entry's call on the
pool's right-hand sides in turn until ``seconds`` have passed; the call
running then finishes and counts.  With ``trace`` a second, traced window
of ``TRACE_SECONDS`` follows for the device metrics.  Then the program's
state is freed and the reference judges the window's answers.
"""

from __future__ import annotations

import gc
import json
import os
import random
import subprocess
import time

import torch

from benchmark import devtrace, inputs, loader
from benchmark.reference import compare

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TRACE_SECONDS = 3.0


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(name: str, man: dict) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r}; have "
                   f"{[w['name'] for w in man['workloads']]}")


def cell_files(cell: dict, man: dict):
    """(config, traffic, limits) of a cell, found by its names."""
    entry = next(c for c in man["configs"] if c["name"] == cell["config"])
    return (_load_json(ROOT, entry["file"]),
            _load_json(HERE, "traffic", cell["traffic"] + ".json"),
            _load_json(HERE, "limits", cell["name"] + ".json"))


def metrics_of(cell_name: str, man: dict, trace: bool) -> list:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones."""
    return [m for m in man["per_layer" if trace else "end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def reader(name: str):
    """``read(run)`` of ``metrics/<name>.py``."""
    return loader.load("metrics", name).read


def power_limit_w():
    """The card's power limit by nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


class Run:
    """What a run measured; the metric readers read it."""

    def __init__(self, **kw):
        self.trace = None
        self.traced_solves = []
        self.__dict__.update(kw)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def options_of(config: dict, traffic: dict, control: bool) -> str:
    """The option string of a call: the traffic's options, then the
    configuration's and its ``tol``, then, for the control, the
    configuration's ``control``."""
    parts = [traffic["options"], config.get("options", "")]
    if "tol" in config:
        parts.append(f"-tol {config['tol']!r}")
    if control:
        parts.append(config["control"])
    return " ".join(" ".join(parts).split())


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False, overrides=None):
    """(the result line of one run as a dict, set-up's steps as seconds
    since the process started).  ``t_start`` is the
    ``time.perf_counter()`` of the process's start; ``overrides`` replaces
    keys of the configuration (tests only: a small grid)."""
    import lis_tpu_torch  # noqa: F401  (the import counts in set-up)

    parts = {"import": time.perf_counter() - t_start}
    device = torch.device(device)
    man = manifest()
    cell = find_cell(name, man)
    config, traffic, limits = cell_files(cell, man)
    config = dict(config, **(overrides or {}))
    operator = loader.load("operators", config["operator"])
    entry = loader.load("entries", traffic["entry"])
    options = options_of(config, traffic, control)

    # ---- set-up ------------------------------------------------------------
    A, info = operator.program(config, device)
    _sync(device)
    parts["operator"] = time.perf_counter() - t_start
    ref_op = operator.reference(config, device)
    pool = inputs.rhs_pool(ref_op, seed, traffic["pool"], device)
    # the window takes the pool in an order drawn from the seed; the first
    # ``samples`` of that order are the answers the reference judges
    order = list(range(len(pool)))
    random.Random(seed).shuffle(order)
    picked = sorted(order[:traffic["samples"]])
    xbuf = {j: torch.empty_like(pool[j]) for j in picked}
    _sync(device)
    parts["pool"] = time.perf_counter() - t_start
    last_iters = {}
    done = 0                  # calls so far, both windows
    ctx = entry.prepare(A, options, traffic)
    _sync(device)
    parts["prepare"] = time.perf_counter() - t_start
    entry.call(ctx, pool[0])
    _sync(device)
    parts["warm_up"] = time.perf_counter() - t_start
    cuda = device.type == "cuda"
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else None
    bench_bytes = sum(t.numel() * t.element_size()
                      for t in pool + list(xbuf.values()))

    def window(length):
        nonlocal done
        recs = []
        t0 = t = time.perf_counter()
        while True:
            j = order[done % len(order)]
            ts = time.perf_counter()
            rec = entry.call(ctx, pool[j])
            t = time.perf_counter()
            x = rec.pop("x")
            if j in xbuf:
                xbuf[j].copy_(x)
                last_iters[j] = rec.get("iters")
            del x
            recs.append(dict(rec, index=j, wall=t - ts))
            done += 1
            if t - t0 >= length:
                return recs, t - t0

    # ---- the timed window --------------------------------------------------
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    solves, window_s = window(seconds)
    _sync(device)
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else None
    run = Run(cell=cell, config=config, traffic=traffic, options=options,
              n=info["n"], nnd=info.get("nnd"), setup_s=setup_s,
              solves=solves, window_s=window_s,
              peak_window_bytes=peak_window, bench_bytes=bench_bytes)
    if trace:
        (run.traced_solves, _), run.trace = devtrace.capture(
            lambda: window(min(seconds, TRACE_SECONDS)))
    peak_all = max(peak_setup, torch.cuda.max_memory_allocated(device)) \
        if cuda else None

    # ---- the comparison, with the program's state freed ---------------------
    del A, ctx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    everything = solves + run.traced_solves
    sample = [(j, xbuf[j], last_iters[j]) for j in picked if j in last_iters]
    numbers = entry.numbers(everything, sample, ref_op, traffic, options,
                            limits, seed, device)
    correct, checks = compare.judge(numbers, limits,
                                    bool(everything) and bool(sample))

    metrics = {}
    for m in metrics_of(name, man, trace):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak_all}
    out = {"correct": correct, "attempted": len(everything),
           "failed": sum(s.get("status", 0) != 0 for s in everything),
           "metrics": metrics, "device": dev}
    if cuda:
        dev["power_limit_w"] = power_limit_w()
    if trace:
        t = run.trace
        dev["busy_s"] = t.busy_us() * 1e-6
        dev["window_s"] = t.window_us * 1e-6
        out["breakdown"] = {"device_ops": t.top_device_ops(),
                            "idle_gaps": t.top_idle_gaps()}
    out["checks"] = checks
    return out, parts
