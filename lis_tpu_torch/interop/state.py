"""Rebuild port objects from another implementation's arrays.

``from_numpy_state(kind, arrays, statics)`` builds a ``CSRMatrix``,
``COOMatrix``, ``CSCMatrix``, ``MSRMatrix``, ``ELLMatrix``, ``JADMatrix``,
``DNSMatrix``, ``DIAMatrix``, ``BSRMatrix``, ``BSCMatrix``, ``VBRMatrix``
(with its nested ``fast``), ``BESMatrix``, ``MultiBESMatrix`` (its
``parts`` a sequence of ``("bes", arrays, statics)`` triples),
``CSTMatrix`` (with its nested ``ShufflePlan``, ``rem`` and ``at``),
``ShufflePlan`` or ``JacobiPrecon`` from numpy arrays — for instance the
leaves of the matching lis_tpu object — so one exact grid can be fed to
both packages, independently of the port's own grid construction.  The
object lives on ``device`` (None: the default device, the card).

``arrays`` maps each tensor field to a numpy array (or, for a tuple
field such as ``ShufflePlan.idxs``, a sequence of arrays); a nested
object is given as a ``(kind, arrays, statics)`` triple, or None.
``statics`` maps each static field to its value.  A DIA matrix is given
by ``value`` — lis_tpu's tuple of (n,) diagonals, or the (nnd, n) array —
and the statics nrows, ncols, nnz and offsets.
"""

from __future__ import annotations

import numpy as np
import torch

from lis_tpu_torch.config import resolve_device
from lis_tpu_torch.matrix.bes import BESMatrix, MultiBESMatrix
from lis_tpu_torch.matrix.bsc import BSCMatrix
from lis_tpu_torch.matrix.bsr import BSRMatrix
from lis_tpu_torch.matrix.coo import COOMatrix
from lis_tpu_torch.matrix.csc import CSCMatrix
from lis_tpu_torch.matrix.csr import CSRMatrix
from lis_tpu_torch.matrix.cst import CSTMatrix
from lis_tpu_torch.matrix.dia import DIAMatrix
from lis_tpu_torch.matrix.dns import DNSMatrix
from lis_tpu_torch.matrix.ell import ELLMatrix
from lis_tpu_torch.matrix.jad import JADMatrix
from lis_tpu_torch.matrix.msr import MSRMatrix
from lis_tpu_torch.matrix.vbr import VBRMatrix
from lis_tpu_torch.ops.shuffle import ShufflePlan
from lis_tpu_torch.precon.jacobi import JacobiPrecon

_KINDS = {"csr": CSRMatrix, "coo": COOMatrix, "csc": CSCMatrix,
          "msr": MSRMatrix, "ell": ELLMatrix, "jad": JADMatrix,
          "dns": DNSMatrix, "dia": DIAMatrix, "cst": CSTMatrix,
          "bsr": BSRMatrix, "bsc": BSCMatrix, "vbr": VBRMatrix,
          "bes": BESMatrix, "mbes": MultiBESMatrix,
          "plan": ShufflePlan, "jacobi": JacobiPrecon}


def _tensor(a):
    return torch.from_numpy(np.array(a))      # a writable copy


def _nested(value):
    return isinstance(value, tuple) and len(value) == 3 \
        and isinstance(value[0], str)


def _field(value):
    if value is None:
        return None
    if _nested(value):
        return from_numpy_state(*value, device="cpu")
    if isinstance(value, (list, tuple)):
        return tuple(_field(a) if _nested(a) else _tensor(a) for a in value)
    return _tensor(value)


def from_numpy_state(kind: str, arrays: dict, statics: dict | None = None,
                     device=None):
    if kind not in _KINDS:
        raise ValueError(f"unknown kind {kind!r}; have {sorted(_KINDS)}")
    if kind == "dia":
        st = statics or {}
        value = arrays["value"]
        if isinstance(value, (list, tuple)):        # lis_tpu's leaves
            value = np.stack([np.asarray(d) for d in value]) if value \
                else np.zeros((0, st["nrows"]))
        return DIAMatrix.from_diagonals(
            np.array(value), st["offsets"], (st["nrows"], st["ncols"]),
            st["nnz"], device=device)
    kw = {k: _field(a) for k, a in arrays.items()}
    if kind == "plan":
        statics = dict(statics or {})
        statics["meta"] = tuple(tuple(int(e) for e in m)
                                for m in statics.get("meta", ()))
    return _KINDS[kind](**kw, **(statics or {})).to(resolve_device(device))
