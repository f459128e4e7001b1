"""The runner that the timing tools of this folder share: it times one
checkout of the repository beside others, on one CUDA device.

A tool calls ``main(__file__, worker, __doc__)``.  ``--root NAME=DIR``
names another checkout (an unpacked ``git archive`` of an earlier commit)
to time beside this one.  Every checkout runs in a process of its own
(the tool again, with the hidden ``--worker DIR``, which calls
``worker(DIR)``), and the list is walked forwards and then backwards
(a b b a), so that two versions are compared inside one call and each is
measured twice.  The card's nvidia-smi name and power limit head the
output, then the last line of each worker's output, or FAILED and the end
of its output.  Exits non-zero when a worker failed.

The tools run as scripts, so this module is imported from their folder,
never through ``lis_tpu_torch``: a worker must import the package of the
checkout it times.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(script: str, worker, doc: str) -> None:
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--root", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--worker", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or "nvidia-smi: no output", flush=True)
    jobs = []                   # (name, root)
    for spec in args.root:
        name, _, root = spec.partition("=")
        jobs.append((name, os.path.abspath(root)))
    jobs.append(("this", _ROOT))
    failed = 0
    for name, root in jobs + jobs[::-1]:
        r = subprocess.run([sys.executable, os.path.abspath(script),
                            "--worker", root], capture_output=True,
                           text=True)
        last = (r.stdout.strip().splitlines() or [""])[-1]
        print(f"{name}: {last if r.returncode == 0 else 'FAILED'}",
              flush=True)
        if r.returncode != 0:
            failed += 1
            print((r.stdout + r.stderr)[-6000:], flush=True)
    sys.exit(1 if failed else 0)
