"""The process mesh: ranks over ``torch.distributed``, and their launcher.

Port of ``lis_tpu/parallel/mesh.py``.  lis_tpu runs one program over a 1-D
``jax.sharding.Mesh`` (axis ``AXIS``), and the body of each ``shard_map``
sees its local shard.  The port runs as the reference Lis does under
``mpirun``: one process per rank, each running the same solver loop on its
local tensors, with collectives in place of lis_tpu's ``lax`` primitives:

==========================================  ================================
lis_tpu (inside ``shard_map``)              ``Mesh`` (per rank)
==========================================  ================================
``psum`` / ``pmax``                         ``all_reduce`` (SUM / MAX)
``all_gather(tiled=True)``                  ``all_gather``
``psum_scatter(tiled=True)``                ``reduce_scatter``
``ppermute`` by a distance d                ``shift``: send to (k − d) mod p,
                                            receive from (k + d) mod p
``axis_index``                              ``rank``
==========================================  ================================

Backends.  The backend follows the device: card tensors use ``nccl``, CPU
tensors ``gloo``.  NCCL refuses two ranks on one card, so ranks that share
one card must name ``backend="gloo"``; gloo has no send or receive (and no
gather) for CUDA tensors, so such a mesh stages every collective through
pinned host buffers: a device-to-host copy, the collective on the host, a
copy back.  That configuration is for testing on one card, not a way to
deploy.  Nothing here asks ``torch.cuda.is_available()`` and nothing falls
back: a card-backed ``nccl`` mesh with fewer cards than ranks raises,
naming the remedy.

``launch(fn, nprocs)`` spawns the ranks (``torch.multiprocessing``, start
method ``spawn``), sets up the group on a free ``tcp://localhost`` port,
runs ``fn(mesh, *args)`` on every rank and returns rank 0's result;
``RankPool`` keeps the ranks alive between calls.  Every wait is bounded.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import traceback

import torch
import torch.distributed as dist

from lis_tpu_torch.config import resolve_device

AXIS = "p"
_TIMEOUT = 300.0            # seconds a collective or a result may take


def backend_for(device) -> str:
    """``nccl`` for a card, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _check_cards(backend: str, device: torch.device, nprocs: int) -> None:
    if backend == "nccl" and device.type == "cuda":
        have = torch.cuda.device_count()
        if have < nprocs:
            raise RuntimeError(
                f"an nccl mesh of {nprocs} ranks needs {nprocs} cards, "
                f"{have} visible: NCCL refuses two ranks on one card; pass "
                "backend='gloo' to let the ranks share a card (staged "
                "through host buffers, for testing), or use fewer ranks")


class _Pending:
    """The receives of one ``Mesh.shift``: ``wait()`` returns them."""

    def __init__(self, works, recvs, keep, dev):
        self._works, self._recvs, self._keep = works, recvs, keep
        self._dev = dev

    def wait(self) -> list:
        for w in self._works:
            w.wait()
        out = [r.to(self._dev) if self._dev is not None else r
               for r in self._recvs]
        self._keep = self._recvs = self._works = None
        return out


class Mesh:
    """One rank's view of the 1-D mesh: its process group, rank, size,
    device and backend, and the collectives the distributed layer uses.
    ``counts`` tallies the collectives this rank issued (``p2p`` counts
    one ``shift``); ``reset_counts`` sets them to 0."""

    def __init__(self, rank: int, size: int, device, backend: str,
                 group=None):
        self.rank, self.size = int(rank), int(size)
        self.device = torch.device(device)
        self.backend = backend
        self.group = group
        # gloo moves no CUDA tensor point to point: stage through the host
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.reset_counts()

    def __repr__(self):
        return (f"Mesh(rank={self.rank}, size={self.size}, "
                f"device={self.device}, backend={self.backend!r})")

    def reset_counts(self) -> None:
        self.counts = {"all_reduce": 0, "all_gather": 0,
                       "reduce_scatter": 0, "p2p": 0}

    # ---- staging -----------------------------------------------------------
    def _host(self, t: torch.Tensor) -> torch.Tensor:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        return h

    # ---- collectives -------------------------------------------------------
    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the ranks in place (SUM or MAX) and returned:
        lis_tpu's ``psum`` / ``pmax``.  ``t`` must be contiguous."""
        self.counts["all_reduce"] += 1
        rop = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        flat = t.view(-1)
        if self.staged:
            h = self._host(flat)
            dist.all_reduce(h, op=rop, group=self.group)
            flat.copy_(h)
        else:
            dist.all_reduce(flat, op=rop, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` concatenated in rank order along a flat axis
        (lis_tpu's tiled ``all_gather``)."""
        self.counts["all_gather"] += 1
        src = t.reshape(-1).contiguous()
        if self.staged:
            src = self._host(src)
        out = src.new_empty(src.numel() * self.size)
        ag = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        ag(out, src, group=self.group)
        return out.to(self.device) if self.staged else out

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` summed and split in ``size`` equal pieces,
        piece k to rank k (lis_tpu's tiled ``psum_scatter``)."""
        self.counts["reduce_scatter"] += 1
        src = t.reshape(-1).contiguous()
        if self.staged:
            src = self._host(src)
        out = src.new_empty(src.numel() // self.size)
        rs = getattr(dist, "reduce_scatter_single", None) \
            or dist.reduce_scatter_tensor
        rs(out, src, group=self.group)
        return out.to(self.device) if self.staged else out

    def shift(self, items) -> _Pending:
        """Post, for each ``(t, d)`` of ``items``, a send of ``t`` to rank
        (k − d) mod p and a receive of a tensor like ``t`` from rank
        (k + d) mod p: lis_tpu's ``ppermute`` with the pairs (i, i − d).
        Every rank posts the same distances in the same order with tensors
        of one shape.  Returns a handle whose ``wait()`` gives the received
        tensors; the caller computes in between (the reference's
        USE_OVERLAP).  A distance that is a multiple of p is a local copy."""
        items = list(items)
        if not items:
            return _Pending([], [], None, None)
        self.counts["p2p"] += 1
        ops, recvs, keep = [], [], []
        for tag, (t, d) in enumerate(items):
            t = t.contiguous()
            if d % self.size == 0:
                recvs.append(t.clone())
                continue
            src = self._host(t) if self.staged else t
            buf = torch.empty_like(src)
            to = (self.rank - d) % self.size
            frm = (self.rank + d) % self.size
            ops.append(dist.P2POp(dist.isend, src, to, self.group, tag))
            ops.append(dist.P2POp(dist.irecv, buf, frm, self.group, tag))
            keep.append(src)
            recvs.append(buf)
        works = dist.batch_isend_irecv(ops) if ops else []
        return _Pending(works, recvs, keep,
                        self.device if self.staged else None)

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order (host set-up only:
        undistributing a matrix)."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def first(self, n: int) -> "Mesh | None":
        """The mesh of ranks 0 .. n-1, on this mesh's device and backend
        (a collective: every rank calls it); None on the other ranks.
        One pool of ranks then serves several mesh widths."""
        if n == self.size:
            return self
        group = dist.new_group(list(range(n)), backend=self.backend)
        if self.rank >= n:
            return None
        return Mesh(self.rank, n, self.device, self.backend, group=group)


_RANK_MESH: Mesh | None = None


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_device(device: torch.device, backend: str, rank: int):
    if device.type != "cuda":
        return device
    if backend == "nccl":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        return dev
    return torch.device("cuda", device.index or 0)


def _init(rank: int, size: int, port: int, device, backend: str,
          timeout: float) -> Mesh:
    global _RANK_MESH
    dev = _rank_device(torch.device(device), backend, rank)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout))
    _RANK_MESH = Mesh(rank, size, dev, backend)
    return _RANK_MESH


def make_mesh(n_devices: int | None = None, device=None,
              backend: str | None = None) -> Mesh:
    """The mesh of this process.  Inside a rank started by ``launch`` or
    ``RankPool`` it is that rank's mesh (``n_devices`` must then be None
    or the world size).  In a process with no group, ``n_devices`` None or
    1 sets up a world of one rank on ``device`` (None: the default
    device, the card) over ``backend`` (None: from the device); more ranks
    need ``launch``."""
    if dist.is_initialized():
        mesh = _RANK_MESH
        if mesh is None:
            raise RuntimeError("a process group exists that make_mesh did "
                               "not set up")
        if n_devices not in (None, mesh.size):
            raise RuntimeError(f"make_mesh({n_devices}) inside a world of "
                               f"{mesh.size} ranks")
        return mesh
    if n_devices not in (None, 1):
        raise RuntimeError(
            f"make_mesh({n_devices}): a mesh of several ranks runs one "
            "process per rank; start them with lis_tpu_torch.parallel."
            "launch(fn, nprocs) or RankPool(nprocs)")
    dev = resolve_device(device)
    backend = backend or backend_for(dev)
    _check_cards(backend, dev, 1)
    return _init(0, 1, _free_port(), dev, backend, _TIMEOUT)


def nprocs(mesh: Mesh) -> int:
    """Ranks along the distribution axis (MPI_Comm_size analogue)."""
    return mesh.size


def ensure_devices(n: int, device=None, backend: str | None = None) -> int:
    """The number of ranks a mesh on ``device`` can run; raises if that is
    fewer than n.  An ``nccl`` mesh runs one rank per visible card; a
    ``gloo`` mesh any number of processes (at least the CPU count)."""
    dev = resolve_device(device)
    backend = backend or backend_for(dev)
    _check_cards(backend, dev, n)
    if backend == "nccl" and dev.type == "cuda":
        return torch.cuda.device_count()
    return max(n, os.cpu_count() or 1)


# ---- the launcher -----------------------------------------------------------

def _rank_main(rank, size, port, device, backend, timeout, tasks, results):
    from lis_tpu_torch.config import set_default_device
    torch.set_num_threads(1)
    try:
        mesh = _init(rank, size, port, device, backend, timeout)
        set_default_device(mesh.device)     # a rank builds on its device
    except BaseException:
        results.put((rank, "err", traceback.format_exc()))
        return
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args, kwargs = task
        try:
            results.put((rank, "ok", fn(mesh, *args, **kwargs)))
        except BaseException:
            results.put((rank, "err", traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``nprocs`` spawned ranks on one process group on ``device`` (None:
    the default device), kept alive between calls.  ``run(fn, *args)``
    runs ``fn(mesh, *args)`` on every rank and returns rank 0's result
    (``run_all``: every rank's, in rank order).
    A rank that raises fails the call with its traceback; a call that
    takes longer than ``timeout`` seconds fails too.  Either way the ranks
    are stopped and the next call starts new ones."""

    def __init__(self, nprocs: int, device=None, backend: str | None = None,
                 timeout: float = _TIMEOUT):
        self.nprocs = int(nprocs)
        self.device = resolve_device(device)
        self.backend = backend or backend_for(self.device)
        self.timeout = float(timeout)
        _check_cards(self.backend, self.device, self.nprocs)
        self._procs = None

    def _start(self):
        ctx = torch.multiprocessing.get_context("spawn")
        port = _free_port()
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.nprocs)]
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(k, self.nprocs, port, str(self.device),
                              self.backend, self.timeout, self._tasks[k],
                              self._results))
            for k in range(self.nprocs)]
        for p in self._procs:
            p.start()

    def run_all(self, fn, *args, timeout: float | None = None,
                **kwargs) -> list:
        if self._procs is None:
            self._start()
        for q in self._tasks:
            q.put((fn, args, kwargs))
        import time
        limit = time.monotonic() + (timeout or self.timeout)
        got, errors = {}, []
        while len(got) + len(errors) < self.nprocs:
            left = limit - time.monotonic()
            if errors:
                left = min(left, 5.0)     # the others may wait in a collective
            try:
                rank, kind, val = self._results.get(timeout=max(left, 0.01))
            except queue.Empty:
                break
            if kind == "ok":
                got[rank] = val
            else:
                errors.append(f"rank {rank}:\n{val}")
        if errors or len(got) < self.nprocs:
            self.close(kill=True)
            if errors:
                raise RuntimeError("a rank failed:\n" + "\n".join(errors))
            raise TimeoutError(f"{fn.__name__} did not finish on all "
                               f"{self.nprocs} ranks within the time limit")
        return [got[k] for k in range(self.nprocs)]

    def run(self, fn, *args, timeout: float | None = None, **kwargs):
        return self.run_all(fn, *args, timeout=timeout, **kwargs)[0]

    def close(self, kill: bool = False) -> None:
        """Stop the ranks (waiting at most 30 s each, then killing)."""
        if self._procs is None:
            return
        if not kill:
            for q in self._tasks:
                q.put(None)
        for p in self._procs:
            if kill:
                p.kill()
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self._procs = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def launch(fn, nprocs: int, *args, device=None, backend: str | None = None,
           timeout: float = _TIMEOUT, **kwargs):
    """Spawn ``nprocs`` ranks on ``device`` (None: the default device, the
    card), run ``fn(mesh, *args, **kwargs)`` on each and return rank 0's
    result; the ranks are stopped before it returns.
    ``fn`` must be importable by name (defined at a module's top level)."""
    with RankPool(nprocs, device=device, backend=backend,
                  timeout=timeout) as pool:
        return pool.run(fn, *args, **kwargs)
