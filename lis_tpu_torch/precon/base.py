"""Preconditioner interface and registry.

Port of ``lis_tpu/precon/base.py`` (reference: src/precon/lis_precon.c —
creation registry at :58-93, applied through lis_psolve / lis_psolveh).
A preconditioner is a frozen dataclass of tensors with ``psolve`` /
``psolveh`` and ``.to(device, dtype)``; creation runs on the matrix's
device.  User preconditioners register like the reference's
lis_precon_register (lis_precon.c:411).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from lis_tpu_torch.matrix.base import TensorFields
from lis_tpu_torch.utils.trace import psolve_span, traced

PRECON_REGISTRY: dict[str, Callable] = {}

# user-registered preconditioners get stable numeric ids above the
# built-in table (LIS_PRECON_TYPE_USERDEF = LIS_PRECON_TYPE_LEN,
# include/lis.h:250) so get_precon/get_preconname round-trip
_USER_PRECON_IDS: dict[str, int] = {}


def user_precon_id(name: str, base: int) -> int:
    if name not in _USER_PRECON_IDS:
        _USER_PRECON_IDS[name] = base + len(_USER_PRECON_IDS)
    return _USER_PRECON_IDS[name]


def user_precon_name(pid: int):
    """The name registered under numeric id ``pid``, or None."""
    for n, i in _USER_PRECON_IDS.items():
        if i == pid:
            return n
    return None


def register_precon(name: str):
    """Register a creation function ``create(A, opts) -> precon``."""
    def deco(fn):
        PRECON_REGISTRY[name] = fn
        return fn
    return deco


@traced
def create_precon(name: str, A, opts) -> "object":
    return PRECON_REGISTRY[name](A, opts)


@dataclasses.dataclass(frozen=True, eq=False)
class NonePrecon(TensorFields):
    """psolve = copy (reference: precon type 0)."""

    @psolve_span
    def psolve(self, r):
        return r

    @psolve_span
    def psolveh(self, r):
        return r
