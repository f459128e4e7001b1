"""Weak/strong-scaling harness for the distributed SpMV.

Port of ``lis_tpu/cli/scaling.py``.  The reference measures multi-rank
behaviour by re-running spmvtest/test2 under ``mpirun -np N``
(test/test.sh); here one pool of spawned ranks (``parallel.RankPool``,
as many as the widest mesh) runs each width N on its first N ranks, on
``device`` (None: the default device, the card; one card per rank over
nccl, or ``-backend gloo`` to let the ranks share one card or run on the
CPU).

Usage:
  python -m lis_tpu_torch.cli.scaling weak   m n iter [nprocs ...]
  python -m lis_tpu_torch.cli.scaling strong m n iter [nprocs ...]
         [-problem poisson|random] [-layout cst] [-backend gloo|nccl]

weak:   m·n rows PER RANK (the global size grows with the mesh);
strong: m·n rows split over the mesh.
-problem poisson (default): the 2-D 5-point Poisson matrix, banded: the
        sharded DIA over ring halos.  random: 8 uniformly random entries a
        row (locality-free): the router's comm-table or CST layout;
        ``-layout cst`` forces the per-rank CST.
Each line gives the time of one matvec (timed on rank 0 as the
difference of two loop lengths, the best of three), MFLOPS (2·nnz per
matvec), the efficiency against the first width, and the vector bytes a
rank moves per matvec.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch


def _problem(kind: str, m: int, n: int):
    import scipy.sparse as sp
    from lis_tpu_torch.matrix.csr import CSRMatrix
    if kind == "random":
        rng = np.random.default_rng(0)
        nn, k = m * n, 8
        rr = np.repeat(np.arange(nn), k)
        cc = rng.integers(0, nn, size=nn * k)
        a = sp.coo_matrix((rng.standard_normal(nn * k), (rr, cc)),
                          shape=(nn, nn)).tocsr()
    else:
        t = lambda k: sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
        a = (sp.kron(sp.eye(n), t(m)) + sp.kron(t(n), sp.eye(m))).tocsr()
    a.sum_duplicates()
    a.sort_indices()
    return CSRMatrix.from_csr_arrays(a.indptr, a.indices, a.data, a.shape,
                                     device="cpu")


def _sync(mesh):
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def bench_rank(mesh, kind, m, n, iters, layout, nd):
    """Rank side, over the first ``nd`` ranks of the pool: distribute,
    time ``iters`` matvecs, return (seconds a matvec, nnz, layout name,
    vector elements moved a matvec, element bytes); None on the other
    ranks."""
    from lis_tpu_torch.parallel import dist as D
    mesh = mesh.first(nd)
    if mesh is None:
        return None
    A0 = _problem(kind, m, n)
    Ad = D.distribute_csr_cst(A0, mesh) if layout == "cst" \
        else D.distribute_matrix(A0, mesh)
    x = D.distribute_vector(np.ones(A0.nrows), mesh, Ad.gn_pad)

    def run(k):
        v = x
        mesh.barrier()
        _sync(mesh)
        t0 = time.perf_counter()
        for _ in range(k):
            v = Ad.matvec(v) * 0.25
        _sync(mesh)
        return time.perf_counter() - t0

    la, lb = max(1, iters // 10), iters + max(1, iters // 10)
    run(la)
    ta = min(run(la) for _ in range(3))
    tb = min(run(lb) for _ in range(3))
    t = max((tb - ta) / (lb - la), 1e-12)
    if getattr(Ad, "hw", 0):
        comm = 2 * Ad.hw                       # two x slabs
    elif hasattr(Ad, "comm_elems"):
        comm = Ad.comm_elems
    elif getattr(Ad, "halo", "") == "gather":
        comm = Ad.gn_pad
    else:
        comm = 0
    nnz = int(A0.to_csr_arrays()[0][-1])
    return t, nnz, type(Ad).__name__, comm, x.element_size()


def main(argv=None, device=None) -> int:
    from lis_tpu_torch.config import resolve_device
    from lis_tpu_torch.parallel.mesh import RankPool, ensure_devices
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {"-problem": "poisson", "-layout": None, "-backend": None}
    for key in list(opts):
        if key in argv:
            i = argv.index(key)
            opts[key] = argv[i + 1]
            del argv[i: i + 2]
    if len(argv) < 4 or argv[0] not in ("weak", "strong"):
        print(__doc__)
        return 1
    mode, m, n, iters = argv[0], int(argv[1]), int(argv[2]), int(argv[3])
    dev = resolve_device(device)
    widths = [int(a) for a in argv[4:]]
    try:
        total = ensure_devices(max(widths) if widths else 1, device=dev,
                               backend=opts["-backend"])
    except RuntimeError as e:
        print(e)
        return 1
    if not widths:
        widths = [d for d in (1, 2, 4, 8) if d <= total]
    kind = opts["-problem"]
    pname = ("uniformly random 8 nnz/row (locality-free)"
             if kind == "random" else "2-D 5-pt Poisson")
    print(f"{mode} scaling, {pname}, base grid {m}x{n}, {iters} iterations, "
          f"{dev}")
    base = None
    with RankPool(max(widths), device=dev, backend=opts["-backend"]) as pool:
        for nd in widths:
            rows_n = n * nd if mode == "weak" else n
            t, nnz, name, comm, esz = pool.run(
                bench_rank, kind, m, rows_n, iters, opts["-layout"], nd)
            mflops = 2.0 * nnz / t / 1e6
            if base is None:
                base = (mflops, nd)
            eff = mflops / (base[0] * nd / base[1])
            print(f"  ndev={nd:3d}  n={m * rows_n:9d}  {t * 1e6:10.1f} "
                  f"us/matvec  {mflops:10.1f} MFLOPS  efficiency {eff:5.2f}"
                  f"  comm {comm * esz / 1e3:.1f} KB/dev/mv  [{name}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
