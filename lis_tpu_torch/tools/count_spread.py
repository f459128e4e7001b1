#!/usr/bin/env python3
"""How far a solve's iteration count moves under a rounding-sized change
of its right-hand side, on the CPU or on the card.

Usage:
    python3 lis_tpu_torch/tools/count_spread.py [--grid N] [--runs K]
        [--nonsym] [--device cpu|cuda] OPTIONS...

Each OPTIONS string (e.g. "-i bicgstab -p is -tol 1e-10") is solved on
poisson3d27 N³ (default 64; ``--nonsym``: its nonsymmetric variant with
the lower diagonals × 0.7, the upper × 1.3 and 28 on the diagonal, as in
chip_smoke.py's phases 10 and 11) for b = 1 and for K − 1 copies of b
with each entry changed by a relative 1e-14 (numpy seed 0).  It prints
the counts and statuses, one line per option string.  The card sums in
another order than the CPU, so a check that holds the card's count to
the CPU's ±1 is only meaningful where this spread is at most 1.

On another device than the CPU it also solves b = 1 on the CPU and
prints where the two residual histories part: the first iteration
whose relative residuals differ by more than a relative 1e-3, and their
relative difference at iterations 1, 2, 4, 8, ...
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--nonsym", action="store_true")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("options", nargs="+")
    args = ap.parse_args(argv)

    import torch
    import lis_tpu_torch
    from lis_tpu_torch.utils import testmat
    g = args.grid
    A = testmat.poisson3d27_dia(g, g, g, device="cpu")
    if args.nonsym:
        scale = torch.tensor([0.7 if o < 0 else (1.3 if o > 0 else 28 / 26)
                              for o in A.offsets], dtype=torch.float64)
        A = dataclasses.replace(A, value=A.value * scale[:, None])
    Ad = A.to(args.device)
    rng = np.random.default_rng(0)
    for opts in args.options:
        counts, statuses = [], []
        for k in range(args.runs):
            b = np.ones(A.nrows)
            if k:
                b = b * (1 + 1e-14 * rng.standard_normal(A.nrows))
            bd = torch.from_numpy(b).to(args.device)
            r = lis_tpu_torch.solve(Ad, bd, options=opts)
            counts.append(r.iters)
            statuses.append(r.status)
            if k == 0 and args.device != "cpu":
                _part(r.rhistory, lis_tpu_torch.solve(
                    A, torch.from_numpy(b), options=opts).rhistory)
        print(f"{g}^3{' nonsym' if args.nonsym else ''} {args.device} "
              f"{opts}: counts {counts}, statuses {statuses}, spread "
              f"{max(counts) - min(counts)}", flush=True)


def _part(hd, hc) -> None:
    """Print where the device's residual history ``hd`` leaves the CPU's
    ``hc``."""
    m = min(len(hd), len(hc))
    rel = np.abs(hd[:m] - hc[:m]) / np.maximum(np.abs(hc[:m]), 1e-300)
    off = np.nonzero(rel > 1e-3)[0]
    steps = [i for i in (2 ** j for j in range(12)) if i < m]
    print(f"  b = 1: {len(hd) - 1} iterations here, {len(hc) - 1} on the "
          f"CPU; histories part (rel > 1e-3) at iteration "
          f"{int(off[0]) if len(off) else None}; rel diff "
          + ", ".join(f"{i}: {rel[i]:.1e}" for i in steps), flush=True)


if __name__ == "__main__":
    main()
