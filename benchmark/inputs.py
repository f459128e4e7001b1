"""The right-hand sides of a cell, made on the device from ``--seed``.

- ``exact_solution``: x* for entry ``index`` of the pool: integers drawn
  uniformly from [-2^20, 2^20], as float64.  With an operator of whole
  coefficients, b = A·x* is then exact in float64, so x* is the exact
  solution of the system that is solved.
- ``rhs_pool``: b = A·x* for each index, formed by the plain reference
  operator's own product.
"""

from __future__ import annotations

import torch

XSTAR_BOUND = 1 << 20


def _generator(seed: int, index: int, device) -> torch.Generator:
    """A generator on ``device`` for pool entry ``index`` of run ``seed``
    (any whole number; folded to 63 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed & ((1 << 62) - 1)) * 1009 + index) & ((1 << 63) - 1))
    return g


def exact_solution(n: int, seed: int, index: int, device) -> torch.Tensor:
    g = _generator(seed, index, device)
    return torch.randint(-XSTAR_BOUND, XSTAR_BOUND + 1, (n,), generator=g,
                         device=device, dtype=torch.int64).to(torch.float64)


def rhs_pool(op, seed: int, size: int, device):
    """The pool's right-hand sides, one (n,) float64 tensor each, for the
    plain operator ``op``."""
    return [op.matvec(exact_solution(op.n, seed, k, device))
            for k in range(size)]
