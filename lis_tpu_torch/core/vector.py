"""BLAS-1 vector operations used by the solvers.

Port of ``lis_tpu/core/vector.py`` (reference src/vector/lis_vector_ops.c):
vectors are torch tensors and every reduction returns a 0-d tensor on the
vector's device, so a solver loop never waits for the device unless it
reads a value on the host.  There is no ``axis_name``: the distributed
layer is ported last (ROADMAP.md queue 1 item 13).
"""

from __future__ import annotations

import torch


def xpay(x, alpha, y):
    """x + alpha*y (lis_vector_xpay: y := x + alpha*y)."""
    return x + alpha * y


def dot(x, y):
    """<x, y> with conjugation of x for complex (lis_vector_dot)."""
    return torch.vdot(x, y) if x.is_complex() else torch.dot(x, y)


def nrm2(x):
    if x.is_complex():
        return torch.sqrt(torch.vdot(x, x).real)
    return torch.sqrt(torch.dot(x, x))


def nrm1(x):
    return torch.sum(torch.abs(x))
