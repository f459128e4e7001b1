"""Jacobi: z = r / diag(A)."""


def make(spec: dict, op):
    d = op.diagonal()
    return lambda r: r / d
