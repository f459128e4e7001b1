"""Eigensolver registry.

Port of ``lis_tpu/esolvers/base.py``: each eigensolver registers a
function ``fn(A, B, x0, opts) -> EsolveResult`` under its standard name
(pi, ii, rqi, cg, cr, si, li, ai); the generalized forms (gpi, gii, ...)
are the same functions given a B.
"""

from __future__ import annotations

from typing import Callable

ESOLVER_FNS: dict[str, Callable] = {}


def register_esolver(name: str):
    def deco(fn):
        ESOLVER_FNS[name] = fn
        return fn
    return deco
