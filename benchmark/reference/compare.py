"""The comparison that decides ``correct``: each number that the cell's
entry (``entries/<name>.py``) worked out against the plain reference,
held to its limit in ``limits/<cell>.json``.  A number the limits file
does not name is not compared; a run with no answers to judge, or a
number that is NaN, is not correct."""

from __future__ import annotations


def option_value(options: str, flag: str, default: float) -> float:
    """The last value given to ``flag`` in an option string."""
    toks = options.split()
    vals = [toks[i + 1] for i, t in enumerate(toks[:-1]) if t == flag]
    return float(vals[-1]) if vals else default


def judge(numbers: dict, limits: dict, judged: bool):
    """(correct, checks) with checks {name: [number, limit]};
    ``judged``: the run had answers for the entry to judge."""
    checks = {k: [numbers[k], limits[k]] for k in limits if k in numbers}
    # a NaN compares false, so it fails its limit
    correct = judged and all(v <= lim for v, lim in checks.values())
    return correct, checks
