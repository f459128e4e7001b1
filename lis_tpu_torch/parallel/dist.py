"""Distributed matrices, vectors and the distributed solve.

Port of ``lis_tpu/parallel/dist.py``.  The reference distributes by a 1-D
block-row partition with a comm table for the halo exchange
(lis_matrix_g2l_csr src/matrix/lis_matrix_mpi.c:222, lis_commtable_create
:594-828, lis_send_recv :834-955, the transpose-reduce lis_reduce :959) and
an MPI_Allreduce in every dot and norm.  lis_tpu runs that over a JAX mesh
inside ``shard_map``; the port runs one process per rank
(``parallel/mesh.py``), and every object here is ONE rank's shard:

- rows are block-partitioned, every rank padded to ``nlocal`` =
  ceil(gn / p) rows (the padding at the end of the last rank), exactly as
  lis_tpu pads, so the block-local preconditioners factor lis_tpu's
  blocks and every rank runs the same loop on vectors of one length;
- the halos, as in lis_tpu:

  * ``DistDIAMatrix`` and ``DistCSRMatrix(halo='neighbor')``: the two
    ring-neighbour slabs of width hw (lis_tpu's ring: rank 0's left
    neighbour is the last rank; the zero padding of the DIA values and
    the masks of the CSR halo cancel the wrapped slabs);
  * ``DistTableCSRMatrix`` and ``DistCSTMatrix``: the comm table of
    export lists per shard distance (``_table_plan``), boundary-
    proportional traffic;
  * ``DistCSRMatrix(halo='gather')``: all-gather of x (explicit opt-in);
  * ``DistBESMatrix``: the window run of x from up to three shifted
    shards;

  each matvec posts its exchange, computes the interior product while it
  flies, waits, then adds the boundary (the reference's USE_OVERLAP,
  lis_matvec.c:119-124);
- transposed products send the ghost columns' partial sums back to their
  owners (lis_reduce), or reduce-scatter them (gather halo);
- reductions go through the vector ops' ``axis_name`` (the ``Mesh``).

``distribute_*`` take the GLOBAL matrix on every rank, as lis_tpu's take
it in its one process, and keep only the rank's own shard on the mesh's
device.  ``dist_solve`` runs the port's solver registry unchanged with
``spec.axis_name`` set to the mesh and returns x whole (length gn) on
every rank.  Kernels on this path: E and the rectangular F (DIA), A-D and
#1 (CST), Q and R (BES), G1-G4 (CG), M-P (the DD operators), and those of
the block-local preconditioners.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from lis_tpu_torch.core.ddreal import (DD, DDDiaOperator, DDF64Operator,
                                       _split_limbs, dd_ell_spmv,
                                       quick_two_sum, two_sum)
from lis_tpu_torch.matrix.base import (TensorFields, conj, host, scatter_add,
                                       static)
from lis_tpu_torch.matrix.bes import BESMatrix
from lis_tpu_torch.matrix.csr import CSRMatrix
from lis_tpu_torch.matrix.cst import CSTMatrix, _next_pow2
from lis_tpu_torch.matrix.dia import dia_spmv, dia_spmvh
from lis_tpu_torch.parallel.mesh import Mesh


def _static(default):
    """A static dataclass field with a default."""
    return dataclasses.field(default=default, metadata={"static": True})


def _t(a, dev, dtype=None):
    """A host array (or a tensor) as a contiguous tensor on ``dev``."""
    if isinstance(a, torch.Tensor):
        return a.to(dev).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)


class _DistBase(TensorFields):
    """Shared metadata of one rank's shard (every subclass is a frozen
    dataclass with the static fields mesh, nlocal, gn, gn_pad, nprocs)."""

    @property
    def nrows(self):
        return self.gn

    @property
    def ncols(self):
        return self.gn

    @property
    def k0(self) -> int:
        """The first global row of this rank."""
        return self.mesh.rank * self.nlocal

    def _keep(self, rows, cols, vals):
        """Global triplets of real entries (padding and zeros dropped)."""
        ok = (vals != 0) & (rows < self.gn) & (cols >= 0) & (cols < self.gn)
        return rows[ok], cols[ok], vals[ok]


# ---- gather / neighbour halo CSR --------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class DistCSRMatrix(_DistBase):
    """Block-row sharded CSR with the ``gather`` or ``neighbor`` halo
    (lis_tpu ``DistCSRMatrix``).  ``index`` holds global columns; under
    ``neighbor`` the entries are split at build time into interior (own
    columns, ``lidx``) and boundary (slab positions ``sidx`` in
    [left slab | right slab], hw each)."""
    value: torch.Tensor       # own entries, CSR order
    index: torch.Tensor       # int64 global columns
    row_ids: torch.Tensor     # int64 local rows
    mesh: Mesh = static()
    nlocal: int = static()
    gn: int = static()
    gn_pad: int = static()
    nprocs: int = static()
    halo: str = _static("gather")
    hw: int = _static(0)
    ivalue: torch.Tensor = None   # neighbor: interior entries
    ilidx: torch.Tensor = None
    irows: torch.Tensor = None
    bvalue: torch.Tensor = None   # neighbor: boundary entries
    bsidx: torch.Tensor = None
    brows: torch.Tensor = None

    def matvec(self, x):
        nl = self.nlocal
        if self.halo == "neighbor":
            hw = self.hw
            pend = self.mesh.shift([(x[-hw:], -1), (x[:hw], 1)])
            y = scatter_add(nl, self.irows,
                         self.ivalue * x.index_select(0, self.ilidx))
            left, right = pend.wait()
            slabs = torch.cat([left, right])
            return y + scatter_add(
                nl, self.brows, self.bvalue * slabs.index_select(0,
                                                                 self.bsidx))
        xg = self.mesh.all_gather(x)
        return scatter_add(nl, self.row_ids,
                        self.value * xg.index_select(0, self.index))

    def matvech(self, x):
        prod = conj(self.value) * x.index_select(0, self.row_ids)
        return self.mesh.reduce_scatter(
            scatter_add(self.gn_pad, self.index, prod))

    def get_diagonal(self):
        isd = self.index == self.row_ids + self.k0
        return scatter_add(self.nlocal, self.row_ids,
                        torch.where(isd, self.value,
                                    torch.zeros_like(self.value)))

    def _triplets(self):
        return self._keep(host(self.row_ids) + self.k0, host(self.index),
                          host(self.value))


def _local_rows(ptr, k0, k1):
    """Entry range and row ids of the global rows [k0, k1) of CSR ``ptr``."""
    e0, e1 = int(ptr[k0]), int(ptr[k1])
    rows = np.repeat(np.arange(k1 - k0, dtype=np.int64),
                     np.diff(ptr[k0:k1 + 1]))
    return e0, e1, rows


def distribute_csr(A, mesh: Mesh, halo: str = "auto",
                   nlocal: int | None = None):
    """Partition a matrix block-row over the mesh (the assemble step, host
    side like the reference's lis_matrix_assemble).  ``halo='auto'`` takes
    the neighbour slabs for a band within one shard and the comm table
    otherwise; ``'gather'`` is the explicit all-gather.  ``nlocal``
    overrides the rows per rank (to match another sharded object)."""
    ptr, index, value = A.to_csr_arrays()
    ptr = np.asarray(ptr, dtype=np.int64)
    index = np.asarray(index, dtype=np.int64)
    value = np.asarray(value)
    gn, p = A.nrows, mesh.size
    if nlocal is None:
        nlocal = -(-gn // p)
    rows_all = np.repeat(np.arange(gn, dtype=np.int64), np.diff(ptr))
    bw = int(np.abs(index - rows_all).max()) if len(rows_all) else 0
    if halo == "auto":
        halo = "neighbor" if 0 < bw <= nlocal else "table"
    if halo == "table":
        return distribute_csr_table(A, mesh, nlocal=nlocal)
    hw = min(max(bw, 1), nlocal) if halo == "neighbor" else 0
    k0 = mesh.rank * nlocal
    k1 = min(k0 + nlocal, gn)
    if k1 > k0:
        e0, e1, lrow = _local_rows(ptr, k0, k1)
    else:
        e0 = e1 = 0
        lrow = np.zeros(0, np.int64)
    return _csr_shard(mesh, value[e0:e1], index[e0:e1], lrow, nlocal, gn,
                      halo, hw)


def _csr_shard(mesh, val, idx, lrow, nlocal, gn, halo, hw):
    """A DistCSRMatrix of this rank's entries (global columns ``idx``,
    local rows ``lrow``), split for the neighbour halo."""
    dev, p = mesh.device, mesh.size
    idx = np.asarray(idx, dtype=np.int64)
    lrow = np.asarray(lrow, dtype=np.int64)
    kw = {}
    if halo == "neighbor":
        lidx = idx - mesh.rank * nlocal
        inside = (lidx >= 0) & (lidx < nlocal)
        sidx = np.where(lidx < 0, lidx + hw, lidx - nlocal + hw)
        kw = dict(ivalue=_t(val[inside], dev), ilidx=_t(lidx[inside], dev),
                  irows=_t(lrow[inside], dev),
                  bvalue=_t(val[~inside], dev),
                  bsidx=_t(np.clip(sidx[~inside], 0, 2 * hw - 1), dev),
                  brows=_t(lrow[~inside], dev))
    return DistCSRMatrix(value=_t(val, dev), index=_t(idx, dev),
                         row_ids=_t(lrow, dev), mesh=mesh, nlocal=nlocal,
                         gn=gn, gn_pad=p * nlocal, nprocs=p, halo=halo,
                         hw=hw, **kw)


# ---- comm-table halo --------------------------------------------------------

def _table_plan(ptr, index, gn, p, nlocal):
    """Comm-table plan + g2l renumbering (lis_commtable_create analogue,
    host side; lis_tpu ``_table_plan``, copied): returns (rows, shard_of,
    lidx_np, exports, dists, exp_lens, ghost_gids, G), exports and
    ghost_gids for every shard (each rank keeps its own row)."""
    ptr = np.asarray(ptr)
    index = np.asarray(index).astype(np.int64)
    rows = np.repeat(np.arange(gn, dtype=np.int64), np.diff(ptr))
    shard_of = rows // nlocal
    owner = np.minimum(index // nlocal, p - 1)

    # need[k][j]: sorted unique global ids shard k imports from owner j
    need = [dict() for _ in range(p)]
    for k in range(p):
        sel = shard_of == k
        cols = index[sel]
        own = owner[sel]
        gh = own != k
        if gh.any():
            for j in np.unique(own[gh]):
                need[k][int(j)] = np.unique(cols[gh & (own == j)])

    dists = sorted({(j - k) % p for k in range(p) for j in need[k]})
    exp_lens = []
    exports = []
    ghost_base = [dict() for _ in range(p)]   # (k, d) -> tail offset
    G = 0
    for d in dists:
        Ed = max((len(need[(i - d) % p].get(i, ()))
                  for i in range(p)), default=0)
        Ed = max(Ed, 1)
        exp = np.full((p, Ed), nlocal, dtype=np.int32)   # pad -> dump slot
        for i in range(p):                                # i = owner/sender
            k = (i - d) % p                               # receiver
            gids = need[k].get(i)
            if gids is not None:
                exp[i, : len(gids)] = (gids - i * nlocal).astype(np.int32)
            ghost_base[k][d] = nlocal + G
        exports.append(exp)
        exp_lens.append(Ed)
        G += Ed

    # g2l renumbering: ghost slot = base(k, d) + position in import list
    lidx_np = np.empty(len(index), dtype=np.int32)
    for k in range(p):
        sel = np.nonzero(shard_of == k)[0]
        cols = index[sel]
        own = owner[sel]
        loc = (cols - k * nlocal).astype(np.int32)
        for j, gids in need[k].items():
            d = (j - k) % p
            m = own == j
            pos = np.searchsorted(gids, cols[m])
            loc[m] = (ghost_base[k][d] + pos).astype(np.int32)
        lidx_np[sel] = loc

    ghost_gids = np.full((p, G), gn, dtype=np.int32)
    for k in range(p):
        for d in dists:
            j = (k + d) % p
            gids = need[k].get(j)
            if gids is not None:
                b = ghost_base[k][d] - nlocal
                ghost_gids[k, b: b + len(gids)] = gids
    return (rows, shard_of, lidx_np, exports, dists, exp_lens,
            ghost_gids, G)


class _TableHalo:
    """The comm-table exchange shared by the table-CSR and CST shards."""

    def _start_exchange(self, x):
        """Per-distance export pack + shift (the lis_send_recv analogue),
        posted before the interior product."""
        nl = self.nlocal
        return self.mesh.shift(
            [(x.index_select(0, e.clamp(max=nl - 1)), d)
             for d, e in zip(self.dists, self.exports)])

    def _ghosts(self, pend):
        got = pend.wait()
        return torch.cat(got) if got else None

    def _return_ghosts(self, y, tail):
        """lis_reduce: route the ghost columns' partials back to their
        owners and add them (``y`` has a dump slot at nlocal)."""
        parts, off = [], 0
        for d, Ed in zip(self.dists, self.exp_lens):
            parts.append((tail[off:off + Ed], -d))
            off += Ed
        backs = self.mesh.shift(parts).wait()
        for e, back in zip(self.exports, backs):
            y = y.index_add(0, e, back)
        return y[: self.nlocal]

    @property
    def comm_elems(self) -> int:
        """Per-rank vector elements moved per matvec (the comm volume
        ``cli/scaling.py`` reports; an all-gather moves gn_pad)."""
        return int(sum(self.exp_lens))

    def _triplets(self):
        """Global triplets of the rank's entries: g2l columns resolved
        through the ghost ids."""
        r, c, v = self._local_g2l()
        gg = host(self.ghost_gids).astype(np.int64)
        gcol = np.where(c < self.nlocal, c + self.k0,
                        gg[np.clip(c - self.nlocal, 0, max(self.G - 1, 0))]
                        if self.G else c + self.k0)
        return self._keep(r + self.k0, gcol, v)


@dataclasses.dataclass(frozen=True, eq=False)
class DistTableCSRMatrix(_TableHalo, _DistBase):
    """Block-row sharded CSR with the comm-table halo (lis_tpu
    ``DistTableCSRMatrix``): interior entries index own x (``lidx``),
    boundary entries the ghost tail (``lidx_b``, slots [0, G)),
    ``exports[d]`` the own x ids each distance sends (nlocal: padding)."""
    value: torch.Tensor
    lidx: torch.Tensor
    row_ids: torch.Tensor
    value_b: torch.Tensor
    lidx_b: torch.Tensor
    row_ids_b: torch.Tensor
    ghost_gids: torch.Tensor  # (G,) global id per ghost slot (gn: none)
    exports: tuple            # per distance: (Ed,) int64 local x ids
    mesh: Mesh = static()
    nlocal: int = static()
    gn: int = static()
    gn_pad: int = static()
    nprocs: int = static()
    dists: tuple = _static(())
    exp_lens: tuple = _static(())
    G: int = _static(0)

    halo = "table"

    def matvec(self, x):
        pend = self._start_exchange(x)
        y = scatter_add(self.nlocal, self.row_ids,
                     self.value * x.index_select(0, self.lidx))
        gh = self._ghosts(pend)
        if gh is None:
            return y
        return y + scatter_add(self.nlocal, self.row_ids_b,
                            self.value_b * gh.index_select(0, self.lidx_b))

    def matvech(self, x):
        y = scatter_add(self.nlocal + 1, self.lidx,
                     conj(self.value) * x.index_select(0, self.row_ids))
        if not self.dists:
            return y[: self.nlocal]
        tail = scatter_add(self.G, self.lidx_b,
                        conj(self.value_b) * x.index_select(0,
                                                             self.row_ids_b))
        return self._return_ghosts(y, tail)

    def get_diagonal(self):
        isd = self.lidx == self.row_ids
        return scatter_add(self.nlocal, self.row_ids,
                        torch.where(isd, self.value,
                                    torch.zeros_like(self.value)))

    def _local_g2l(self):
        """(rows, g2l cols, vals) of this rank: interior then boundary."""
        return (np.concatenate([host(self.row_ids), host(self.row_ids_b)]),
                np.concatenate([host(self.lidx),
                                host(self.lidx_b) + self.nlocal]),
                np.concatenate([host(self.value), host(self.value_b)]))



def _own_plan(ptr, index, gn, mesh, nlocal):
    """This rank's slice of ``_table_plan``: (lrow, lidx, value range,
    exports, dists, exp_lens, ghost_gids, G)."""
    p, k = mesh.size, mesh.rank
    (rows, shard_of, lidx_np, exports, dists, exp_lens, ghost_gids,
     G) = _table_plan(ptr, index, gn, p, nlocal)
    sel = np.nonzero(shard_of == k)[0]
    lrow = rows[sel] - k * nlocal
    return (sel, lrow, lidx_np[sel].astype(np.int64),
            [e[k].astype(np.int64) for e in exports],
            tuple(int(d) for d in dists),
            tuple(int(e) for e in exp_lens), ghost_gids[k], int(G))


def distribute_csr_table(A, mesh: Mesh,
                         nlocal: int | None = None) -> DistTableCSRMatrix:
    """The comm-table sharded layout (g2l renumbering + export/import
    plan, host side: the reference's lis_commtable_create)."""
    ptr, index, value = A.to_csr_arrays()
    gn, p = A.nrows, mesh.size
    if nlocal is None:
        nlocal = -(-gn // p)
    value = np.asarray(value)
    sel, lrow, lidx, exports, dists, exp_lens, gg, G = _own_plan(
        ptr, index, gn, mesh, nlocal)
    val = value[sel]
    inside = lidx < nlocal
    dev = mesh.device
    return DistTableCSRMatrix(
        value=_t(val[inside], dev), lidx=_t(lidx[inside], dev),
        row_ids=_t(lrow[inside], dev), value_b=_t(val[~inside], dev),
        lidx_b=_t(lidx[~inside] - nlocal, dev),
        row_ids_b=_t(lrow[~inside], dev),
        ghost_gids=_t(gg.astype(np.int64), dev),
        exports=tuple(_t(e, dev) for e in exports), mesh=mesh,
        nlocal=nlocal, gn=gn, gn_pad=p * nlocal, nprocs=p, dists=dists,
        exp_lens=exp_lens, G=G)


# ---- comm-table halo + per-rank CST -----------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class DistCSTMatrix(_TableHalo, _DistBase):
    """Block-row sharded locality-free matrix (lis_tpu ``DistCSTMatrix``):
    the comm-table halo with each rank's interior block (own columns,
    nlocal x nlocal) as a ``CSTMatrix`` (kernels A-D per product, its
    transpose grid for matvech, its own CSR spill) and the boundary
    entries as a gather segment over the ghost tail.  lis_tpu stacks every
    shard's grid into one padded plan for ``shard_map``; here each rank
    holds its own, with lis_tpu's forced Kp and n_pad."""
    cst: CSTMatrix
    bnd_val: torch.Tensor
    bnd_lidx: torch.Tensor    # ghost-tail ids (< G)
    bnd_rows: torch.Tensor
    ghost_gids: torch.Tensor
    exports: tuple
    mesh: Mesh = static()
    nlocal: int = static()
    gn: int = static()
    gn_pad: int = static()
    nprocs: int = static()
    dists: tuple = _static(())
    exp_lens: tuple = _static(())
    G: int = _static(0)

    halo = "table"

    def matvec(self, x):
        # comm first, the interior CST product while it flies (USE_OVERLAP)
        pend = self._start_exchange(x)
        y = self.cst.matvec(x)
        gh = self._ghosts(pend)
        if gh is None or self.bnd_val.numel() == 0:
            return y
        return y + scatter_add(self.nlocal, self.bnd_rows,
                            self.bnd_val * gh.index_select(0, self.bnd_lidx))

    def matvech(self, x):
        z = self.cst.matvech(x)
        y = torch.cat([z, z.new_zeros(1)])
        if not self.dists:
            return y[: self.nlocal]
        tail = scatter_add(self.G, self.bnd_lidx,
                        conj(self.bnd_val) * x.index_select(0,
                                                             self.bnd_rows))
        return self._return_ghosts(y, tail)

    def get_diagonal(self):
        return self.cst.get_diagonal()

    def _local_g2l(self):
        cp, ci, cv = self.cst.to_csr_arrays()
        r = np.repeat(np.arange(self.nlocal, dtype=np.int64), np.diff(cp))
        return (np.concatenate([r, host(self.bnd_rows)]),
                np.concatenate([np.asarray(ci, np.int64),
                                host(self.bnd_lidx) + self.nlocal]),
                np.concatenate([np.asarray(cv), host(self.bnd_val)]))

    def scale_rows(self, d):
        """D A on the device: the interior grid scales itself (its
        transpose grid by lane shuffles, kernel #1), the boundary by the
        rows' factors."""
        return dataclasses.replace(
            self, cst=self.cst.scale_rows(d),
            bnd_val=self.bnd_val * d.index_select(0, self.bnd_rows)
            .to(self.bnd_val.dtype))

    def scale_symm(self, ds):
        """D A D on the device: the ghost columns' factors come over the
        comm-table halo."""
        gh = self._ghosts(self._start_exchange(ds))
        bv = self.bnd_val * ds.index_select(0, self.bnd_rows).to(
            self.bnd_val.dtype)
        if gh is not None and self.bnd_val.numel():
            bv = bv * gh.index_select(0, self.bnd_lidx).to(bv.dtype)
        return dataclasses.replace(self, cst=self.cst.scale_symm(ds),
                                   bnd_val=bv)


def distribute_csr_cst(A, mesh: Mesh,
                       nlocal: int | None = None) -> DistCSTMatrix:
    """Comm-table halo + per-rank CST compute (see DistCSTMatrix); Kp from
    the global mean row length and n_pad = next_pow2(max(nlocal, 2^14))
    on every rank, as lis_tpu forces them."""
    ptr, index, value = A.to_csr_arrays()
    gn, p = A.nrows, mesh.size
    if nlocal is None:
        nlocal = -(-gn // p)
    value = np.asarray(value)
    sel, lrow, lidx, exports, dists, exp_lens, gg, G = _own_plan(
        ptr, index, gn, mesh, nlocal)
    val = value[sel]
    inside = lidx < nlocal
    n_pad = _next_pow2(max(nlocal, 128 * 128))
    Kp = CSTMatrix._pick_kp(len(value) / max(gn, 1))
    blk = sp.coo_matrix((val[inside], (lrow[inside], lidx[inside])),
                        shape=(nlocal, nlocal)).tocsr()
    blk.sort_indices()
    dev = mesh.device
    cst = CSTMatrix.from_csr_arrays(blk.indptr, blk.indices, blk.data,
                                    (nlocal, nlocal), transpose=True, Kp=Kp,
                                    n_pad=n_pad, device=dev)
    return DistCSTMatrix(
        cst=cst, bnd_val=_t(val[~inside], dev),
        bnd_lidx=_t(lidx[~inside] - nlocal, dev),
        bnd_rows=_t(lrow[~inside], dev),
        ghost_gids=_t(gg.astype(np.int64), dev),
        exports=tuple(_t(e, dev) for e in exports), mesh=mesh,
        nlocal=nlocal, gn=gn, gn_pad=p * nlocal, nprocs=p, dists=dists,
        exp_lens=exp_lens, G=G)


# ---- DIA over ring halos ----------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class DistDIAMatrix(_DistBase):
    """Block-row sharded DIA (lis_tpu ``DistDIAMatrix``): the rank's
    (nnd, nlocal) diagonals, and the two ring-neighbour slabs of width hw
    = max |offset|.

    matvec: the slabs are posted, kernel E runs the interior product on
    own x (terms reaching outside dropped, as lis_tpu's zero padding
    does), then E runs again on the first and last hw rows over [left
    slab | zeros] and [zeros | right slab] and those corrections are
    added.  matvech: the rectangular kernel F gives the column sums over
    [left | own | right] (nlocal + 2 hw), and the halo parts go back to
    their owners and are added (lis_reduce).  lis_tpu instead exchanges
    per-diagonal value slabs and x slabs every call (dist.py:1288-1313).
    One rank needs no halo."""
    value: torch.Tensor       # (nnd, nlocal)
    off: torch.Tensor         # (nnd,) int64 offsets
    off_ext: torch.Tensor     # (nnd,) int64 offsets + hw
    first: torch.Tensor       # (nnd, hw) value[:, :hw]
    last: torch.Tensor        # (nnd, hw) value[:, -hw:]
    mesh: Mesh = static()
    offsets: tuple = static()
    nlocal: int = static()
    gn: int = static()
    gn_pad: int = static()
    nprocs: int = static()
    hw: int = static()

    def matvec(self, x):
        nl, hw = self.nlocal, self.hw
        if self.nprocs == 1:
            return dia_spmv(self.value, self.off, self.offsets, x, nl)
        pend = self.mesh.shift([(x[-hw:], -1), (x[:hw], 1)])
        y = dia_spmv(self.value, self.off, self.offsets, x, nl)
        left, right = pend.wait()
        zero = x.new_zeros(hw)
        ext = tuple(o + hw for o in self.offsets)
        y[:hw] += dia_spmv(self.first, self.off_ext, ext,
                           torch.cat([left, zero]), 2 * hw)
        y[nl - hw:] += dia_spmv(self.last, self.off, self.offsets,
                                torch.cat([zero, right]), 2 * hw)
        return y

    def matvech(self, x):
        nl, hw = self.nlocal, self.hw
        if self.nprocs == 1:
            return dia_spmvh(self.value, self.off, self.offsets, x)
        ext = tuple(o + hw for o in self.offsets)
        ye = dia_spmvh(self.value, self.off_ext, ext, x, nl + 2 * hw)
        # columns left of this rank belong to the left neighbour's last hw
        # rows, those right of it to the right neighbour's first hw
        from_right, from_left = self.mesh.shift(
            [(ye[:hw], 1), (ye[nl + hw:], -1)]).wait()
        y = ye[hw:hw + nl].clone()
        y[:hw] += from_left
        y[nl - hw:] += from_right
        return y

    def get_diagonal(self):
        if 0 not in self.offsets:
            return self.value.new_zeros(self.nlocal)
        return self.value[self.offsets.index(0)].clone()

    def _triplets(self):
        v = host(self.value)
        i = np.arange(self.nlocal, dtype=np.int64)
        rows = np.concatenate([i + self.k0 for _ in self.offsets]) \
            if self.offsets else i[:0]
        cols = np.concatenate([i + self.k0 + o for o in self.offsets]) \
            if self.offsets else i[:0]
        return self._keep(rows, cols, v.reshape(-1))

    def scale_rows(self, d):
        """D A on the device (the diagonals times the rows' factors)."""
        return self._scaled(self.value * d.to(self.value.dtype))

    def scale_symm(self, ds):
        """D A D on the device: value[k, i] · ds[i] · ds[i + off_k], the
        column factors from ds's halo."""
        nl, hw = self.nlocal, self.hw
        if self.nprocs == 1:
            left = right = ds.new_zeros(hw)
        else:
            left, right = self.mesh.shift([(ds[-hw:], -1),
                                           (ds[:hw], 1)]).wait()
        de = torch.cat([left, ds, right])
        cols = torch.stack([de[hw + o: hw + o + nl] for o in self.offsets])
        return self._scaled(self.value * ds.to(self.value.dtype)
                            * cols.to(self.value.dtype))

    def _scaled(self, value):
        hw = self.hw
        return dataclasses.replace(self, value=value.contiguous(),
                                   first=value[:, :hw].contiguous(),
                                   last=value[:, -hw:].contiguous())


def distribute_dia(A, mesh: Mesh) -> DistDIAMatrix:
    """Partition a matrix into sharded DIA (the distributed fast path for
    banded operators); A is converted to DIA if it is not, and only this
    rank's rows are moved to the mesh's device."""
    from lis_tpu_torch.matrix.convert import convert_matrix
    D = A if getattr(A, "format_name", None) == "dia" \
        else convert_matrix(A, "dia", device="cpu")
    gn, p = D.nrows, mesh.size
    nlocal = -(-gn // p)
    offsets = tuple(int(o) for o in D.offsets)
    hw = max((abs(o) for o in offsets), default=1) or 1
    if hw > nlocal:
        raise ValueError(f"bandwidth {hw} exceeds shard size {nlocal}; "
                         "use distribute_csr with halo='gather'")
    k0 = mesh.rank * nlocal
    k1 = min(k0 + nlocal, gn)
    val = torch.zeros((len(offsets), nlocal), dtype=D.value.dtype,
                      device=mesh.device)
    if k1 > k0:
        val[:, : k1 - k0] = D.value[:, k0:k1].to(mesh.device)
    return _dia_shard(mesh, val, offsets, gn, hw)


def _dia_shard(mesh, val, offsets, gn, hw) -> DistDIAMatrix:
    """A DistDIAMatrix of this rank's (nnd, nlocal) diagonals."""
    val = val.to(mesh.device).contiguous()
    off = torch.tensor(offsets, dtype=torch.int64, device=mesh.device)
    nlocal = val.shape[1]
    return DistDIAMatrix(value=val, off=off, off_ext=off + hw,
                         first=val[:, :hw].contiguous(),
                         last=val[:, -hw:].contiguous(), mesh=mesh,
                         offsets=tuple(offsets), nlocal=nlocal, gn=gn,
                         gn_pad=mesh.size * nlocal, nprocs=mesh.size, hw=hw)


# ---- hybrid, BES, multi-BES -------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class DistHybridMatrix(_DistBase):
    """Sharded HDI: dominant diagonals as a DistDIAMatrix + the remainder
    over the comm table (lis_tpu ``DistHybridMatrix``)."""
    dia: DistDIAMatrix
    rem: object

    def matvec(self, x):
        return self.dia.matvec(x) + self.rem.matvec(x)

    def matvech(self, x):
        return self.dia.matvech(x) + self.rem.matvech(x)

    def get_diagonal(self):
        return self.dia.get_diagonal() + self.rem.get_diagonal()

    def _triplets(self):
        return tuple(np.concatenate(t) for t in zip(self.dia._triplets(),
                                                     self.rem._triplets()))

    @property
    def mesh(self):
        return self.dia.mesh

    @property
    def nlocal(self):
        return self.dia.nlocal

    @property
    def gn(self):
        return self.dia.gn

    @property
    def gn_pad(self):
        return self.dia.gn_pad

    @property
    def nprocs(self):
        return self.dia.nprocs


@dataclasses.dataclass(frozen=True, eq=False)
class DistBESMatrix(_DistBase):
    """Block-row sharded BES (lis_tpu ``DistBESMatrix``).  Rank k's tiles
    read the x run [k·nlocal + c0, + L), L = nlocal + W − R; with c0 =
    shift·nlocal + c0r it lies in shards k+shift .. k+shift+2, from which
    only the needed pieces are shifted in (lis_tpu moves the three whole
    shards).  ``blk`` is the rank's slab as a BESMatrix over the run
    (c0 = 0, ncols = L): kernel Q for matvec, kernel R for the run's
    column sums in matvech, whose pieces go back to their owners."""
    blk: BESMatrix
    rem: object               # DistTableCSRMatrix or None
    mesh: Mesh = static()
    nlocal: int = static()
    gn: int = static()
    gn_pad: int = static()
    nprocs: int = static()
    R: int = static()
    W: int = static()
    c0: int = static()

    def _pieces(self):
        """(shard offset j, [a, b) within that shard) of the run."""
        nl = self.nlocal
        L = nl + self.W - self.R
        c0r = self.c0 % nl
        out = []
        for j in range(3):
            a, b = max(c0r - j * nl, 0), min(c0r + L - j * nl, nl)
            if b > a:
                out.append((j, a, b))
        return out

    def matvec(self, x):
        shift = self.c0 // self.nlocal
        run = torch.cat(self.mesh.shift(
            [(x[a:b], shift + j) for j, a, b in self._pieces()]).wait())
        y = self.blk.matvec(run)
        return y if self.rem is None else y + self.rem.matvec(x)

    def matvech(self, x):
        nl = self.nlocal
        shift, c0r = divmod(self.c0, nl)
        part = self.blk.matvech(x)
        pieces = self._pieces()
        backs = self.mesh.shift(
            [(part[j * nl + a - c0r: j * nl + b - c0r], -(shift + j))
             for j, a, b in pieces]).wait()
        y = part.new_zeros(nl)
        for (j, a, b), back in zip(pieces, backs):
            y[a:b] += back
        return y if self.rem is None else y + self.rem.matvech(x)

    def get_diagonal(self):
        slab = self.blk.slab
        R, W = self.R, self.W
        r = torch.arange(R, device=slab.device)
        w = r - self.c0
        ok = (w >= 0) & (w < W)
        d = torch.where(ok, slab[:, w.clamp(0, W - 1), r],
                        torch.zeros((), dtype=slab.dtype,
                                    device=slab.device)).reshape(-1)
        return d if self.rem is None else d + self.rem.get_diagonal()

    def _triplets(self):
        s = host(self.blk.slab)
        t, w, r = np.nonzero(s)
        rows = t * self.R + r + self.k0
        cols = t * self.R + self.c0 + w + self.k0
        out = self._keep(rows, cols, s[t, w, r])
        if self.rem is None:
            return out
        return tuple(np.concatenate(z) for z in zip(out,
                                                     self.rem._triplets()))


def distribute_bes(A, mesh: Mesh) -> DistBESMatrix:
    """Shard a BESMatrix (or build one from A) block-row over the mesh; the
    window overhang W − R must fit within one shard."""
    from lis_tpu_torch.matrix.convert import convert_matrix
    B = A if getattr(A, "format_name", None) == "bes" \
        else convert_matrix(A, "bes", device="cpu")
    p = mesh.size
    T, W, R = B.slab.shape
    tlocal = -(-T // p)
    nlocal = tlocal * R
    if W - R > nlocal:
        raise ValueError(f"bes window width {W} exceeds shard rows "
                         f"{nlocal}+R; use distribute_csr")
    t0 = mesh.rank * tlocal
    slab = torch.zeros((tlocal, W, R), dtype=B.slab.dtype)
    have = B.slab[t0:min(t0 + tlocal, T)].cpu()
    slab[: have.shape[0]] = have
    L = nlocal + W - R
    blk = BESMatrix(slab=slab, rem=None, nrows=nlocal, ncols=L,
                    nnz=int(torch.count_nonzero(slab)), R=R, W=W, c0=0,
                    stride=R).to(mesh.device)
    rem = None if B.rem is None else distribute_csr(
        B.rem, mesh, halo="table", nlocal=nlocal)
    return DistBESMatrix(blk=blk, rem=rem, mesh=mesh, nlocal=nlocal,
                         gn=B.nrows, gn_pad=p * nlocal, nprocs=p, R=R, W=W,
                         c0=B.c0)


@dataclasses.dataclass(frozen=True, eq=False)
class DistMultiBESMatrix(_DistBase):
    """Sharded multi-window BES: one DistBESMatrix per affine band plus
    the remainder over the comm table (lis_tpu ``DistMultiBESMatrix``)."""
    parts: tuple
    rem: object
    mesh: Mesh = static()
    gn: int = static()
    gn_pad: int = static()
    nlocal: int = static()
    nprocs: int = static()

    def _sum(self, f):
        y = f(self.parts[0])
        for q in self.parts[1:]:
            y = y + f(q)
        return y if self.rem is None else y + f(self.rem)

    def matvec(self, x):
        return self._sum(lambda q: q.matvec(x))

    def matvech(self, x):
        return self._sum(lambda q: q.matvech(x))

    def get_diagonal(self):
        return self._sum(lambda q: q.get_diagonal())

    def _triplets(self):
        parts = list(self.parts) + ([self.rem] if self.rem is not None
                                    else [])
        return tuple(np.concatenate(z)
                     for z in zip(*[q._triplets() for q in parts]))


# ---- the router, (un)distribution and vectors -------------------------------

def distribute_matrix(A, mesh: Mesh, halo: str = "auto"):
    """lis_tpu's layout choice, branch by branch: banded operators become
    sharded DIA, quasi-banded ones DIA + a comm-table remainder, general
    banded sparsity sharded BES slabs (one or several windows) unless the
    per-rank CST grid is the better rate, locality-free sparsity at scale
    the per-rank CST, everything else the CSR of ``distribute_csr``."""
    from lis_tpu_torch.matrix.bes import multi_bes_from_csr
    from lis_tpu_torch.matrix.convert import diag_profile, is_banded
    from lis_tpu_torch.matrix.hybrid import HybridMatrix
    nlocal = -(-A.nrows // mesh.size)
    offs, _ = diag_profile(A)
    bw = int(np.abs(offs).max()) if offs is not None and len(offs) else 0
    if is_banded(A) and 0 < bw <= nlocal:
        return distribute_dia(A, mesh)
    ptr, idx, val = A.to_csr_arrays()
    H = HybridMatrix.try_split(ptr, idx, val, A.shape, device="cpu")
    if H is not None:
        hbw = max((abs(o) for o in H.dia.offsets), default=0)
        if 0 < hbw <= nlocal:
            return DistHybridMatrix(
                dia=distribute_dia(H.dia, mesh),
                rem=distribute_csr(H.rem, mesh, halo="table"))
    cst_ok = False
    if halo == "auto" and A.nnz >= (1 << 18):
        blowup, rfrac = CSTMatrix.profile(ptr, idx, A.shape)
        cst_ok = blowup <= 6.0 and rfrac <= 0.02
    try:
        bes = multi_bes_from_csr(ptr, idx, val, A.shape, max_bytes=4 << 30,
                                 compact=False)
        rem_frac = (bes.rem.nnz / max(bes.nnz, 1)
                    if bes.rem is not None else 0.0)
        if (bes.fill_blowup <= 256 and rem_frac <= 0.1
                and (bes.fill_blowup <= 16 or not cst_ok)):
            if isinstance(bes, BESMatrix):
                return distribute_bes(bes, mesh)
            parts = [distribute_bes(q, mesh) for q in bes.parts]
            rem = (None if bes.rem is None
                   else distribute_csr(bes.rem, mesh, halo="table",
                                       nlocal=parts[0].nlocal))
            return DistMultiBESMatrix(tuple(parts), rem, mesh=mesh,
                                      gn=bes.nrows,
                                      gn_pad=parts[0].gn_pad,
                                      nlocal=parts[0].nlocal,
                                      nprocs=parts[0].nprocs)
    except ValueError:
        # a window wider than a shard, or a matrix with no entry
        pass
    if cst_ok:
        return distribute_csr_cst(A, mesh)
    return distribute_csr(A, mesh, halo=halo)


def _global_scipy(A) -> sp.csr_matrix:
    """The global matrix collected from every rank's shard (a collective:
    every rank must call it)."""
    got = A.mesh.all_gather_object(A._triplets())
    rows = np.concatenate([g[0] for g in got])
    cols = np.concatenate([g[1] for g in got])
    vals = np.concatenate([g[2] for g in got])
    m = sp.coo_matrix((vals, (rows, cols)), shape=(A.gn, A.gn)).tocsr()
    m.sum_duplicates()
    m.sort_indices()
    return m


def undistribute_csr(A, device=None) -> CSRMatrix:
    """Collect a sharded matrix back into a global CSRMatrix on every rank
    (the inverse of the distributors; the reference's lis_matrix_merge
    direction).  A collective: every rank must call it.  The result lives
    on ``device`` (None: the mesh's)."""
    m = _global_scipy(A)
    return CSRMatrix.from_csr_arrays(m.indptr, m.indices, m.data,
                                     (A.gn, A.gn),
                                     device=device or A.mesh.device)


def redistribute_csr(A, mesh: Mesh, halo: str = "auto"):
    """Re-partition a distributed matrix onto ``mesh`` (the analogue of
    lis_matrix_redistribute_csr, src/matrix/lis_matrix_mpi.c:1007): the
    shards are collected and partitioned again."""
    return distribute_csr(undistribute_csr(A, device="cpu"), mesh, halo=halo)


def distribute_vector(v, mesh: Mesh, gn_pad: int) -> torch.Tensor:
    """This rank's block of ``v`` zero-padded to gn_pad (the lis_vector
    block-row partition), on the mesh's device."""
    nl = gn_pad // mesh.size
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(v))
    t = t.reshape(-1)
    lo = mesh.rank * nl
    out = torch.zeros(nl, dtype=t.dtype, device=mesh.device)
    have = t[lo:min(lo + nl, t.shape[0])]
    out[: have.shape[0]] = have.to(mesh.device)
    return out


def _rebuilt(A, g: CSRMatrix, mesh: Mesh):
    """A host-scaled global matrix distributed as A was (lis_tpu: a
    DistCSRMatrix keeps its halo, anything else goes through the
    router)."""
    if isinstance(A, DistCSRMatrix):
        return distribute_csr(g, mesh, halo=A.halo)
    return distribute_matrix(g, mesh)


# ---- the DD operators -------------------------------------------------------

class DistTableDDOperator:
    """DD (limb-pair) matvec over the comm-table halo (lis_tpu
    ``DistTableDDOperator``; the reference's _mp exchanges,
    include/lis_mpi.h:45-46): each distance's export slab carries both
    limbs in one shift, and the rank's ELL over the ghost-extended vector
    runs kernel N.  matvech runs N over the transpose's ELL (nlocal + G
    rows) and returns the ghost partials to their owners, added with an
    error-free transform."""

    def __init__(self, index, value, value_lo, index_t, value_t, value_t_lo,
                 src):
        self.index, self.value, self.value_lo = index, value, value_lo
        self.index_t, self.value_t = index_t, value_t
        self.value_t_lo = value_t_lo
        self.src = src            # the table-halo shard (exports, mesh)
        self.nlocal, self.gn, self.gn_pad = src.nlocal, src.gn, src.gn_pad
        self.mesh, self.nprocs = src.mesh, src.nprocs

    @property
    def nrows(self):
        return self.gn

    def _exchange_dd(self, x: DD) -> DD:
        nl = self.nlocal
        got = self.mesh.shift(
            [(torch.stack([x.hi.index_select(0, e.clamp(max=nl - 1)),
                           x.lo.index_select(0, e.clamp(max=nl - 1))]), d)
             for d, e in zip(self.src.dists, self.src.exports)]).wait()
        return DD(torch.cat([x.hi] + [g[0] for g in got]),
                  torch.cat([x.lo] + [g[1] for g in got]))

    def matvec(self, x: DD) -> DD:
        return dd_ell_spmv(self.index, self.value, self._exchange_dd(x),
                           self.value_lo)

    def matvech(self, x: DD) -> DD:
        z = dd_ell_spmv(self.index_t, self.value_t, x, self.value_t_lo)
        nl = self.nlocal
        yh, yl = z.hi[:nl], z.lo[:nl]
        parts, off = [], nl
        for d, Ed in zip(self.src.dists, self.src.exp_lens):
            parts.append((torch.stack([z.hi[off:off + Ed],
                                       z.lo[off:off + Ed]]), -d))
            off += Ed
        backs = self.mesh.shift(parts).wait()
        for e, back in zip(self.src.exports, backs):
            # export ids are unique within a distance: densify and add
            # with an error-free transform (exact DD accumulation)
            safe = e.clamp(max=nl - 1)
            live = (e < nl).to(back.dtype)
            bh = yh.new_zeros(nl).index_copy(0, safe, back[0] * live)
            bl = yh.new_zeros(nl).index_copy(0, safe, back[1] * live)
            sh_, se = two_sum(yh, bh)
            yl = yl + bl + se
            yh = sh_
        yh, yl = quick_two_sum(yh, yl)
        return DD(yh, yl)

    @classmethod
    def from_matrix(cls, A, limb=None) -> "DistTableDDOperator":
        """From a table-halo shard (DistTableCSRMatrix or DistCSTMatrix):
        its local block in g2l numbering as ELL, common width over the
        ranks (one all-reduce MAX), like lis_tpu's stacked ELL."""
        from lis_tpu_torch.core.ddreal import _ell_arrays
        r, c, v = A._local_g2l()
        nl, ncl = A.nlocal, A.nlocal + A.G
        a = sp.coo_matrix((v, (r, c)), shape=(nl, ncl)).tocsr()
        a.sort_indices()
        at = a.T.tocsr()
        at.sort_indices()
        w = torch.tensor([int(np.diff(a.indptr).max(initial=0)),
                          int(np.diff(at.indptr).max(initial=0))])
        w = A.mesh.all_reduce(w.to(A.mesh.device), "max").cpu()
        dev = A.mesh.device

        def ell(m, rows, width):
            ei, ev = _ell_arrays(m.indptr, m.indices, m.data, rows)
            ei = np.pad(ei, ((0, 0), (0, width - ei.shape[1])))
            ev = np.pad(ev, ((0, 0), (0, width - ev.shape[1])))
            hi, lo = _split_limbs(torch.from_numpy(ev), limb)
            return (torch.from_numpy(ei).to(dev), hi.to(dev).contiguous(),
                    None if lo is None else lo.to(dev).contiguous())
        ei, ev, evl = ell(a, nl, max(int(w[0]), 1))
        ti, tv, tvl = ell(at, ncl, max(int(w[1]), 1))
        return cls(ei, ev, evl, ti, tv, tvl, A)


class DistDIADDOperator:
    """DD matvec over a sharded DIA operator (lis_tpu
    ``DistDIADDOperator``): x's limbs ride the ring halos; matvec is
    kernel M over the rank's nlocal x (nlocal + 2 hw) operator (offsets +
    hw, x = [left | own | right]), matvech kernel M's transpose over the
    square operator of the halo-extended values (nlocal + 2 hw rows,
    the neighbours' edge rows exchanged once at build time, where lis_tpu
    exchanges them every call), of which the middle nlocal rows are kept:
    lis_tpu's sums, term by term."""

    def __init__(self, fwd: DDDiaOperator, ext: DDDiaOperator, src):
        self.fwd, self.ext, self.src = fwd, ext, src
        self.nlocal, self.gn, self.gn_pad = src.nlocal, src.gn, src.gn_pad
        self.mesh, self.nprocs, self.hw = src.mesh, src.nprocs, src.hw

    @property
    def nrows(self):
        return self.gn

    def _exchange(self, x: DD) -> DD:
        hw = self.hw
        lh, rh, ll, rl = self.mesh.shift(
            [(x.hi[-hw:], -1), (x.hi[:hw], 1),
             (x.lo[-hw:], -1), (x.lo[:hw], 1)]).wait()
        return DD(torch.cat([lh, x.hi, rh]), torch.cat([ll, x.lo, rl]))

    def matvec(self, x: DD) -> DD:
        return self.fwd.matvec(self._exchange(x))

    def matvech(self, x: DD) -> DD:
        hw, nl = self.hw, self.nlocal
        z = self.ext.matvech(self._exchange(x))
        return DD(z.hi[hw:hw + nl].contiguous(), z.lo[hw:hw + nl].contiguous())


def make_dist_dd_operator(A: DistDIAMatrix, limb=None) -> DistDIADDOperator:
    """The DD operator of a sharded DIA: limbs of ``limb`` (None: f64
    pairs with zero second limbs, as lis_tpu's)."""
    hw, nl = A.hw, A.nlocal
    v = A.value
    if limb is not None:
        hi, lo = _split_limbs(v, limb)
    else:
        hi, lo = v, torch.zeros_like(v)
    hi, lo = hi.contiguous(), lo.contiguous()
    lh, rh, ll, rl = A.mesh.shift(
        [(hi[:, -hw:], -1), (hi[:, :hw], 1),
         (lo[:, -hw:], -1), (lo[:, :hw], 1)]).wait()
    ext_offsets = tuple(o + hw for o in A.offsets)
    fwd = DDDiaOperator(hi, A.off_ext, ext_offsets, nl, nl + 2 * hw, lo)
    ext = DDDiaOperator(torch.cat([lh, hi, rh], 1).contiguous(), A.off,
                        A.offsets, nl + 2 * hw, nl + 2 * hw,
                        torch.cat([ll, lo, rl], 1).contiguous())
    return DistDIADDOperator(fwd, ext, A)


def _dd_operator(A, limb):
    """lis_tpu dist_solve's DD operator choice (dist.py:1092-1105)."""
    if isinstance(A, (DistBESMatrix, DistMultiBESMatrix)):
        # the slab product accumulates in f64 and splits back to the limbs
        # (lis_tpu DistBESDDOperator)
        return DDF64Operator(A.to(dtype=torch.float64))
    if isinstance(A, DistDIAMatrix):
        return make_dist_dd_operator(A, limb=limb)
    if isinstance(A, (DistTableCSRMatrix, DistCSTMatrix)):
        return DistTableDDOperator.from_matrix(A, limb=limb)
    raise NotImplementedError(
        "distributed DD precision needs a DIA-, BES-, table- or "
        "cst-sharded matrix (distribute_matrix picks one)")


# ---- the distributed solve --------------------------------------------------

def make_dist_jacobi(A):
    """Jacobi preconditioner over the rank's rows (1 where the diagonal is
    0 or the row is padding)."""
    from lis_tpu_torch.precon.jacobi import JacobiPrecon
    d = A.get_diagonal()
    nz = d != 0
    one = torch.ones_like(d)
    return JacobiPrecon(dinv=torch.where(nz, 1.0 / torch.where(nz, d, one),
                                         one))


def _dist_true_resid(A, b, x) -> float:
    """‖b − Ax‖₂ / ‖b‖₂ over the mesh: one matvec and one all-reduce of
    the two squared norms (lis_solver.c:910-924)."""
    r = b - A.matvec(x.to(b.dtype))
    sq = torch.stack([torch.sum(torch.abs(r) ** 2),
                      torch.sum(torch.abs(b) ** 2)])
    nr, nb = A.mesh.all_reduce(sq).tolist()
    return float(np.sqrt(nr) / np.sqrt(1.0 if nb == 0 else nb))


def _make_precon(A, mesh, opts):
    from lis_tpu_torch.parallel import dist_precon as dp
    from lis_tpu_torch.precon.base import NonePrecon
    if opts.precon == "none":
        M = NonePrecon()
    elif opts.precon == "jacobi":
        M = make_dist_jacobi(A)
    elif opts.precon in ("ilu", "ilut", "iluc", "ssor", "sainv", "is",
                         "bjacobi"):
        # block-Jacobi application of the local preconditioners: the
        # reference's own MPI semantics (local-rows ILU/SSOR/...)
        M = dp.make_dist_block_precon(
            A, mesh, opts, name="jacobi" if opts.precon == "bjacobi" else None)
    elif opts.precon == "hybrid":
        M = dp.make_dist_hybrid(A, mesh, opts)
    elif opts.precon == "saamg":
        M = dp.make_dist_saamg(A, mesh, opts)
    else:
        raise NotImplementedError(
            f"distributed preconditioner {opts.precon!r} (supported: none, "
            "jacobi, bjacobi, ilu, ilut, iluc, ssor, sainv, is, hybrid, "
            "saamg, or pass one that applies to the rank's rows)")
    if opts.adds:
        # additive Schwarz with the DISTRIBUTED residual matvec (the
        # reference's lis_psolve_adds uses the global lis_matvec under
        # MPI, lis_precon_ads.c:116)
        from lis_tpu_torch.precon.ads import AdditiveSchwarzPrecon
        M = AdditiveSchwarzPrecon(A=A, inner=M,
                                  iters=int(getattr(opts, "adds_iter", 1)))
    return M


def _solver_aux(A, mesh, opts):
    """lis_tpu's host-side solver set-up under a mesh: the IDR(s) shadow
    space sliced to the rank's rows, or the block-local (D/ω + L) plans
    of GS and SOR."""
    if opts.solver in ("idrs", "idr1"):
        from lis_tpu_torch.solvers.idrs import shadow_space
        s = opts.irestart if opts.solver == "idrs" else 1
        P = np.pad(shadow_space(s, A.gn), ((0, 0), (0, A.gn_pad - A.gn)))
        lo = mesh.rank * A.nlocal
        return torch.from_numpy(P[:, lo:lo + A.nlocal].copy()).to(
            mesh.device)
    if opts.solver in ("gs", "sor"):
        from lis_tpu_torch.parallel.dist_precon import local_diag_block
        from lis_tpu_torch.solvers.stationary import _lower_plan
        w = 1.0 if opts.solver == "gs" else opts.omega
        if opts.solver == "sor" and w > 1.5 and A.nprocs > 1:
            # block-local sweeps have a tighter SOR stability bound than
            # the exact sweep the serial default -omega 1.9 assumes: lis_tpu
            # clamps, and so does the port (a known weakness of the
            # block-local plan, carried over as it is)
            warnings.warn(
                f"distributed SOR with -omega {w:g} over {A.nprocs} shards "
                "uses block-local sweeps and can diverge; clamping to 1.5 "
                "(pass -omega <= 1.5 explicitly to silence)",
                RuntimeWarning, stacklevel=3)
            w = 1.5
        return _lower_plan(local_diag_block(A), w)
    return None


def dist_solve(A, b, mesh: Mesh, options=None, M=None, x0=None,
               **overrides):
    """Distributed lis_solve on this rank: the port's solver registry run
    with ``spec.axis_name`` = ``mesh``.  ``A`` is this rank's shard
    (``distribute_*``), ``b`` and ``x0`` global vectors (length gn) or
    None.  Every rank must call it with the same options.  Returns a
    SolveResult whose x is the whole solution (length gn) on every rank."""
    from lis_tpu_torch import config as C
    from lis_tpu_torch.runtime.options import SolverOptions
    from lis_tpu_torch.solvers.base import SOLVER_FNS
    from lis_tpu_torch.solvers.driver import (SolveResult, _bscale_operator,
                                              _block_matvec, _cast32,
                                              _check_ported, _make_spec)

    opts = options if isinstance(options, SolverOptions) else \
        SolverOptions.from_string(options, **overrides)
    _check_ported(opts)
    spec = _make_spec(opts)._replace(axis_name=mesh, live_print=False)
    t0 = C.wtime()

    # ---- block-Jacobi scaling (-scale 1 -storage bsr): the reference's
    # BSR branch (lis_solve_kernel :659-691) under MPI, on the host global
    # operator and b before distribution (set-up cost, as in lis_tpu)
    bscale = opts.scale == 1 and opts.storage == 7 and opts.precon != "is"
    b_host = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) \
        else np.asarray(b)
    if bscale:
        g = undistribute_csr(A, device="cpu")
        gs, binv = _bscale_operator(g, opts.storage_block or 2)
        b_host = _block_matvec(binv, torch.from_numpy(
            np.ascontiguousarray(b_host[: A.gn]))).numpy()
        A = _rebuilt(A, gs, mesh)

    b = distribute_vector(b_host, mesh, A.gn_pad)
    x0 = torch.zeros_like(b) if x0 is None else distribute_vector(
        x0, mesh, A.gn_pad).to(b.dtype)
    A_orig, b_orig = A, b

    if getattr(opts, "reorder", "none") != "none":
        warnings.warn(
            "-reorder is a pre-distribution transform: apply "
            "matrix.reorder.rcm_permutation/permute_symmetric BEFORE "
            "distribute_matrix (ignored here)", RuntimeWarning, stacklevel=2)
    if opts.storage and not (opts.storage == 7
                             and (opts.precon == "ilu" or bscale)):
        warnings.warn(
            "-storage is ignored under dist_solve: the sharded layout is "
            "chosen by distribute_matrix (exceptions: '-storage bsr -p "
            "ilu' selects the per-shard BLOCK ILU factorization, "
            "'-storage bsr -scale 1' the block-Jacobi scaling, like "
            "the reference's per-rank BSR conversion)",
            RuntimeWarning, stacklevel=2)

    # ---- scaling (lis_solve_kernel :613-721, distributed), with the
    # CG+Jacobi upgrade and the forced Jacobi scaling of -p is -------------
    scale = 0 if bscale else opts.scale
    if scale == 1 and opts.solver == "cg" and opts.precon == "jacobi":
        scale = 2
    if opts.precon == "is" and scale == 0 and not bscale:
        scale = 1
    dscale = None
    if scale:
        d = A.get_diagonal()
        nz = d != 0
        one = torch.ones_like(d)
        if scale == 1:
            fac = torch.where(nz, 1.0 / torch.where(nz, d, one), one)
        else:
            fac = torch.where(nz, 1.0 / torch.sqrt(torch.abs(
                torch.where(nz, d, one))), one)
            # padding rows scale by 1, so x0 / dscale stays finite there
            dscale = fac
        if isinstance(A, (DistCSTMatrix, DistDIAMatrix)):
            A = A.scale_rows(fac) if scale == 1 else A.scale_symm(fac)
        else:
            g = _global_scipy(A)
            fg = A.mesh.all_gather(fac).cpu().numpy()[: A.gn]
            rows = np.repeat(np.arange(A.gn), np.diff(g.indptr))
            v = g.data * fg[rows]
            if scale == 2:
                v = v * fg[g.indices]
            gsc = CSRMatrix.from_csr_arrays(g.indptr, g.indices, v,
                                            (A.gn, A.gn), device="cpu")
            A = _rebuilt(A, gsc, mesh)
        b = b * fac.to(b.dtype)
        if dscale is not None:
            x0 = x0 / dscale.to(x0.dtype)

    if M is None:
        M = _make_precon(A, mesh, opts)
    aux = _solver_aux(A, mesh, opts)
    ptime = C.wtime() - t0

    def execute(A_, b_, x0_, M_, aux_, spec_):
        kw = {} if aux_ is None else {"aux": aux_}
        return SOLVER_FNS[spec_.solver](A_, b_, x0_, M_, spec_, **kw)

    extra_iters = 0
    f32 = torch.float32
    t_i = C.wtime()
    if opts.precision == "single":
        out = execute(A.to(dtype=f32), _cast32(b), _cast32(x0),
                      M.to(dtype=f32),
                      None if aux is None else aux.to(dtype=f32), spec)
    elif opts.precision in ("df", "switch_df", "quad", "switch"):
        qname = opts.solver + "_quad"
        if qname not in SOLVER_FNS:
            raise NotImplementedError(f"no quad variant of {opts.solver!r}")
        if b.is_complex():
            raise NotImplementedError(
                f"-f {opts.precision} does not support complex operands "
                "(the reference's quad precision is real-only)")
        limb = f32 if opts.precision in ("df", "switch_df") else None
        A_dd = _dd_operator(A, limb)
        b_dd = b
        if limb is not None:
            b32 = _cast32(b)
            b_dd = DD(b32, (b - b32.to(b.dtype)).to(f32))
            A, b, x0, M = A.to(dtype=f32), b32, _cast32(x0), M.to(dtype=f32)
            aux = None if aux is None else aux.to(dtype=f32)
        if opts.precision in ("switch", "switch_df"):
            sw_tol = (opts.switch_tol if opts.precision == "switch"
                      else max(opts.switch_tol, 1.0e-6))
            sw_maxiter = (opts.switch_maxiter if opts.switch_maxiter > 0
                          else opts.maxiter)
            out1 = execute(A, b, x0, M, aux,
                           spec._replace(tol=sw_tol, maxiter=sw_maxiter))
            x0 = out1.x
            extra_iters = int(out1.iters)
        out = execute(A_dd, b_dd, x0, M, aux, spec._replace(solver=qname))
    elif opts.precision == "double":
        out = execute(A, b, x0, M, aux, spec)
    else:
        raise NotImplementedError(
            f"distributed -f {opts.precision}: supported are double, "
            "single, df, switch_df, quad, switch")
    x = out.x.to(b_orig.dtype)
    if dscale is not None:
        x = x * dscale.to(x.dtype)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    itime = C.wtime() - t_i

    iters = int(out.iters) + extra_iters
    tr = _dist_true_resid(A_orig, b_orig, x)
    xg = mesh.all_gather(x)[: A_orig.gn]
    return SolveResult(x=xg, status=int(out.status), iters=iters,
                       resid=float(out.resid), true_resid=tr,
                       rhistory=out.rhistory[: iters + 1].cpu().numpy(),
                       time=C.wtime() - t0, itime=itime, ptime=ptime,
                       options=opts)
