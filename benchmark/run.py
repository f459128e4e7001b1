"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``--control`` runs the cell's control (the
configuration's ``control`` options: the program in the next lower
precision), which the comparison must refuse; the benchmark's own runs
never pass it.

Exits with 2, printing no result, where no CUDA device is present or there
are fewer than the cell asks for; with 3 where jax, jaxlib, flax or lis_tpu
is loaded once the window has closed.  Otherwise the last lines on
standard error are the compared numbers beside their limits, and the last
line on standard output is the result as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "lis_tpu")


def process_start() -> float:
    """``time.perf_counter()`` at this process's start (Linux's
    /proc/self/stat, to 10 ms), or now where that cannot be read."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    return now - max(age, 0.0)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from benchmark import harness

    cell = harness.find_cell(args.workload, harness.manifest())
    if not torch.cuda.is_available():
        print("run.py: torch.cuda.is_available() is false: the benchmark "
              "needs a CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: {torch.cuda.device_count()} CUDA devices, the cell "
              f"asks for {cell['chips']}", file=sys.stderr)
        return 2
    out, parts = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda", t_start,
                           control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: loaded in the process that measured: {bad}",
              file=sys.stderr)
        return 3
    print("set-up steps, s since the process started: "
          + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()),
          file=sys.stderr)
    for name, (value, limit) in out["checks"].items():
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    # the checkout's root, not this folder, is where modules are found
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
