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

The distributed kinds ``dist_csr``, ``dist_table_csr``, ``dist_dia``,
``dist_cst``, ``dist_bes`` and ``dist_hybrid`` take the leaves of the
matching lis_tpu ``parallel.dist`` object, every shard stacked, and the
rank's ``mesh``: the result is that rank's shard (``dist_state``), so one
lis_tpu distribution feeds both packages.
"""

from __future__ import annotations

import dataclasses

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
                     device=None, mesh=None):
    if kind in _DIST_KINDS:
        if mesh is None:
            raise ValueError(f"{kind} is one rank's shard: give its mesh")
        return dist_state(kind, arrays, statics or {}, mesh)
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


# ---- the distributed kinds --------------------------------------------------

_DIST_KINDS = ("dist_csr", "dist_table_csr", "dist_dia", "dist_cst",
               "dist_bes", "dist_hybrid")


def _part(a, k: int, p: int):
    """Part k of p of a leaf stacked along its first axis (lis_tpu's
    leaves carry the shard axis leading and flattened); nested
    (kind, arrays, statics) triples of a format are cut leaf by leaf."""
    if a is None:
        return None
    if _nested(a):
        return (a[0], {n: _part(v, k, p) for n, v in a[1].items()}, a[2])
    if isinstance(a, (list, tuple)):
        return [_part(v, k, p) for v in a]
    a = np.asarray(a)
    m = a.shape[0] // p
    return a[k * m:(k + 1) * m]


def _local_csr(rows, cols, vals, n: int, device):
    import scipy.sparse as sp
    m = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    m.sort_indices()
    return CSRMatrix.from_csr_arrays(m.indptr, m.indices, m.data, (n, n),
                                     device=device)


def dist_state(kind: str, arrays: dict, statics: dict, mesh):
    """This rank's shard of a lis_tpu distributed matrix: ``arrays`` are
    lis_tpu's leaves as numpy arrays, every rank's part stacked along the
    first axis (rank k takes part k of ``nprocs``; a tuple field such as
    ``value`` of dist_dia or ``exports`` a sequence), a nested
    distributed part (the remainder of dist_bes, the parts of dist_hybrid)
    a (kind, arrays, statics) triple; ``statics`` lis_tpu's (nlocal, gn,
    gn_pad, nprocs, hw, dists, ...).  The shard lives on the mesh's
    device."""
    from lis_tpu_torch.parallel import dist as D
    p, k, dev = int(statics["nprocs"]), mesh.rank, mesh.device
    if p != mesh.size:
        raise ValueError(f"{kind}: {p} shards, a mesh of {mesh.size} ranks")
    nl, gn = int(statics["nlocal"]), int(statics["gn"])

    def part(name):
        return _part(arrays[name], k, p)

    def t(name, dtype=None):
        return D._t(part(name), dev, dtype)
    if kind == "dist_dia":
        val = torch.from_numpy(np.stack(part("value")))
        return D._dia_shard(mesh, val, statics["offsets"], gn,
                            int(statics["hw"]))
    if kind == "dist_csr":
        return D._csr_shard(mesh, part("value"), part("index"),
                            part("row_ids"), nl, gn, statics["halo"],
                            int(statics["hw"]))
    if kind == "dist_hybrid":
        return D.DistHybridMatrix(dia=dist_state(*arrays["dia"], mesh),
                                  rem=dist_state(*arrays["rem"], mesh))
    if kind == "dist_bes":
        slab = torch.from_numpy(np.ascontiguousarray(part("slab")))
        R, W = int(statics["R"]), int(statics["W"])
        blk = BESMatrix(slab=slab, rem=None, nrows=nl, ncols=nl + W - R,
                        nnz=int(torch.count_nonzero(slab)), R=R, W=W, c0=0,
                        stride=R).to(dev)
        rem = None if arrays.get("rem") is None else \
            dist_state(*arrays["rem"], mesh)
        return D.DistBESMatrix(blk=blk, rem=rem, mesh=mesh, nlocal=nl,
                               gn=gn, gn_pad=p * nl, nprocs=p, R=R, W=W,
                               c0=int(statics["c0"]))
    table = dict(mesh=mesh, nlocal=nl, gn=gn, gn_pad=p * nl, nprocs=p,
                 dists=tuple(int(d) for d in statics["dists"]),
                 exp_lens=tuple(int(e) for e in statics["exp_lens"]),
                 G=int(statics["G"]),
                 ghost_gids=t("ghost_gids", np.int64),
                 exports=tuple(D._t(e, dev, np.int64)
                               for e in part("exports")))
    if kind == "dist_table_csr":
        return D.DistTableCSRMatrix(
            value=t("value"), lidx=t("lidx", np.int64),
            row_ids=t("row_ids", np.int64), value_b=t("value_b"),
            lidx_b=t("lidx_b", np.int64),
            row_ids_b=t("row_ids_b", np.int64), **table)
    if kind == "dist_cst":
        # lis_tpu keeps each grid's spill beside it (rem_*, art_*); the
        # port's CSTMatrix holds it as its CSR remainder
        def grid(name, spill):
            g = from_numpy_state(*part(name), device=dev)
            r, c, v = (part(s) for s in spill)
            return dataclasses.replace(g, rem=_local_csr(r, c, v, nl, dev))
        at = grid("at_cst", ("art_rows", "art_lidx", "art_val"))
        cst = dataclasses.replace(
            grid("cst", ("rem_rows", "rem_lidx", "rem_val")), at=at)
        return D.DistCSTMatrix(
            cst=cst, bnd_val=t("bnd_val"), bnd_lidx=t("bnd_lidx", np.int64),
            bnd_rows=t("bnd_rows", np.int64), **table)
    raise ValueError(f"unknown kind {kind!r}; have {_DIST_KINDS}")
