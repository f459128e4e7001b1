"""On the card (``gpu`` tier): faults planted in the SA-AMG V-cycle of
``hpcg27-192.cg-saamg``, at the cell's own size, fail the cell's limits.

A V-cycle that is wrong but still a usable preconditioner lets CG return
x to the tolerance, so x_err and resid pass it; only the iteration count
(``iters_max``, ``iters_mean``) can catch it, and a fault that leaves the
count as it is (``UNSEEN``) meets the configuration's guarantee in the
same iterations: no number of the window's answers tells it.  Each fault is planted in the held
preconditioner's module for the solves of a few right-hand sides of
three seeds, and judged by the cell's own entry and limits.  Skips
without a CUDA device.

    python -m pytest benchmark/tests/test_bench_vcycle_faults.py -q -p no:cacheprovider
    python benchmark/tests/test_bench_vcycle_faults.py   # prints each reading
"""

import contextlib
import json
import os
import sys

import pytest
import torch

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from benchmark import harness, inputs, loader  # noqa: E402
from benchmark.reference import compare  # noqa: E402

CELL = "hpcg27-192.cg-saamg"
SEEDS = (2 ** 31 + 4001, 2 ** 31 + 4002, 2 ** 31 + 4003)
RHS = 4                   # right-hand sides a seed


def _plant(fault: str, saamg):
    """{module attribute: replacement} for ``fault`` in
    ``lis_tpu_torch.precon.saamg``."""
    cls = saamg.SAAMGPrecon
    pre, post = cls._presmooth, cls._postsmooth
    prolong, restrict = saamg.lattice_prolong, saamg.lattice_restrict
    series = saamg.sweep_series

    def deepest(self):
        return [lv for lv in self.levels if lv.transfer is not None][-1]

    if fault == "coarse_product_skipped":
        return saamg, {"_coarse": lambda Ainv, b: torch.zeros_like(b)}
    if fault == "finest_postsmooth_skipped":
        return cls, {"_postsmooth": lambda self, lv, x, b: (
            x if lv is self.levels[0] else post(self, lv, x, b))}
    if fault == "finest_smoothing_skipped":
        return cls, {
            "_presmooth": lambda self, lv, b: (
                torch.zeros_like(b) if lv is self.levels[0]
                else pre(self, lv, b)),
            "_postsmooth": lambda self, lv, x, b: (
                x if lv is self.levels[0] else post(self, lv, x, b))}
    if fault == "second_level_smoothing_skipped":
        return cls, {
            "_presmooth": lambda self, lv, b: (
                torch.zeros_like(b) if lv is self.levels[1]
                else pre(self, lv, b)),
            "_postsmooth": lambda self, lv, x, b: (
                x if lv is self.levels[1] else post(self, lv, x, b))}
    if fault == "one_sweep_not_two":
        return saamg, {"sweep_series": lambda T, b, nsweeps, **kw: series(
            T, b, 1, **kw)}
    if fault == "prolong_J_left_out":
        return saamg, {"lattice_prolong": lambda tr, ec, x: x}
    if fault == "restrict_L_left_out_deepest":
        state = {}

        def restrict_(tr, r):
            rc = restrict(tr, r)
            return torch.zeros_like(rc) if tr is state["deepest"] else rc
        return saamg, {"lattice_restrict": restrict_,
                       "_state": state, "_deepest": deepest}
    if fault == "prolong_J_left_out_deepest":
        state = {}

        def prolong_(tr, ec, x):
            return x if tr is state["deepest"] else prolong(tr, ec, x)
        return saamg, {"lattice_prolong": prolong_,
                       "_state": state, "_deepest": deepest}
    raise KeyError(fault)


# faults the cell's limits refuse, and faults that leave the count as it
# is or nearly (PERF.md gives their readings): read, not asserted
FAULTS = ("finest_smoothing_skipped", "second_level_smoothing_skipped",
          "prolong_J_left_out", "finest_postsmooth_skipped")
UNSEEN = ("coarse_product_skipped", "one_sweep_not_two",
          "prolong_J_left_out_deepest", "restrict_L_left_out_deepest")


@contextlib.contextmanager
def planted(fault, M):
    from lis_tpu_torch.precon import saamg
    if fault is None:
        yield
        return
    target, repl = _plant(fault, saamg)
    state = repl.pop("_state", None)
    pick = repl.pop("_deepest", None)
    if state is not None:
        state["deepest"] = pick(M).transfer
    old = {k: getattr(target, k) for k in repl}
    try:
        for k, v in repl.items():
            setattr(target, k, v)
        yield
    finally:
        for k, v in old.items():
            setattr(target, k, v)


class Setup:
    """The cell's operator and held preconditioner, built once;
    ``Setup("cpu", {"grid": [24, 24, 24]})`` plants the same faults on the
    CPU at a small grid, where the counts are not the cell's."""

    def __init__(self, device="cuda", overrides=None):
        man = harness.manifest()
        cell = harness.find_cell(CELL, man)
        self.config, self.traffic, self.limits = harness.cell_files(cell,
                                                                    man)
        self.config = dict(self.config, **(overrides or {}))
        op = loader.load("operators", self.config["operator"])
        self.entry = loader.load("entries", self.traffic["entry"])
        self.options = harness.options_of(self.config, self.traffic, False)
        self.device = torch.device(device)
        A, _ = op.program(self.config, self.device)
        self.ref = op.reference(self.config, self.device)
        self.ctx = self.entry.prepare(A, self.options, self.traffic)
        self.entry.call(self.ctx, self.ref.matvec(torch.ones(
            self.ref.n, dtype=torch.float64, device=self.device)))

    def reading(self, fault, seed, rhs=RHS):
        """``correct`` and the numbers of the cell's comparison beside
        their limits, over ``rhs`` solves of ``seed`` with ``fault``."""
        recs, sample = [], []
        with planted(fault, self.ctx["M"]):
            for k in range(rhs):
                b = self.ref.matvec(inputs.exact_solution(
                    self.ref.n, seed, k, self.device))
                rec = self.entry.call(self.ctx, b)
                sample.append((k, rec.pop("x"), rec["iters"]))
                recs.append(rec)
        nums = self.entry.numbers(recs, sample, self.ref, self.traffic,
                                  self.options, self.limits, seed,
                                  self.device)
        return compare.judge(nums, self.limits, True)


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (gpu tier)")
    return Setup()


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
def test_sound_vcycle_is_correct(setup, seed):
    correct, checks = setup.reading(None, seed)
    assert correct, checks


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("fault", FAULTS)
def test_vcycle_fault_is_refused(setup, fault, seed):
    correct, checks = setup.reading(fault, seed)
    assert not correct, checks


if __name__ == "__main__":
    # python benchmark/tests/test_bench_vcycle_faults.py [rhs a seed]
    rhs = int(sys.argv[1]) if len(sys.argv) > 1 else RHS
    s = Setup()
    for fault in (None,) + UNSEEN + FAULTS:
        for seed in SEEDS:
            correct, checks = s.reading(
                fault, seed, RHS if fault == FAULTS[0] else rhs)
            print(json.dumps({"fault": fault, "seed": seed,
                              "correct": correct, "checks": checks}),
                  flush=True)
