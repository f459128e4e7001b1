"""Language bindings and ecosystem interop.

Port of ``lis_tpu/interop``:

- ``scipy_compat``: scipy.sparse.linalg-compatible solver entry points
  (cg/bicg/bicgstab/cgs/gmres/minres) plus from_scipy/to_scipy/
  aslinearoperator converters — the Python-ecosystem analogue of the
  reference's Fortran bindings (src/fortran/lisf_init.c etc.).
- ``fapi``: the handle-based procedural API mirroring the lisf_ Fortran
  call surface (used by the gfortran-ABI shim in _native/lisf_tpu.c).
- ``state``: rebuild port objects from another implementation's arrays.
"""

from lis_tpu_torch.interop.scipy_compat import (
    aslinearoperator, bicg, bicgstab, cg, cgs, from_scipy, gmres, minres,
    to_scipy,
)

__all__ = [
    "aslinearoperator", "bicg", "bicgstab", "cg", "cgs", "from_scipy",
    "gmres", "minres", "to_scipy",
]
