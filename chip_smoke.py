#!/usr/bin/env python3
"""Chip smoke for lis_tpu_torch: build, check and time the CUDA kernels,
then drive the ported solve paths on one CUDA device.

Usage: python3 chip_smoke.py [--seed N]

Phases (one or more lines each):
1. environment: the card (nvidia-smi name and power limit), torch and
   CUDA versions, and the nvcc build of lis_tpu_torch/csrc/*.cu (one nvcc
   per source, in parallel);
2. every kernel against its plain PyTorch version on the card, at the
   shapes of the solves below: permutations bit-equal (lane_shuffle in
   f32, f64, complex64 and complex128; a benes_pass with d = 16 through
   lane_shuffle), row sums to rtol 1e-12 (f64) / 1e-5 (f32); f64 and f32
   timed beside the plain version, beside the one PyTorch call that
   computes the same function where there is one (torch.gather with a
   prebuilt int64 index, for lane_shuffle and benes_pass), and beside
   the bound: the bytes each must move over 3.35 TB/s, or its additions
   and multiplications over the card's peak rate if that is more.
   benes_small_run is also checked, untimed, for runs of 1, 2, 4 and 8
   passes with Kp in {None, 2, 16, 32, 128} on 1 and on 133 tiles;
3. CG + Jacobi over the CST SpMV: solve(A, ones, "-i cg -p jacobi
   -storage cst -tol 1e-10") for the locality-free SPD system
   a + aᵀ + 32·I, n = 2^20, 8 random columns per row, made from --seed;
   SUCCESS with true residual <= 1e-9 and kernels A-D launched at least
   once per iteration; then once more at -f single.  Each solve rebuilds
   the CST on the host.  The CPU oracle runs at n = 2^17 (see below);
4. the CST matvec, kernels against plain torch on the card, in
   csr-equivalent GB/s = (nnz·12 + 2n·8) / t;
5. reuse: one CST of the nonsymmetric a − 0.5·aᵀ + 32·I (phase 3's
   pattern), built once with its transpose grid, solved with
   "-storage cst -scale 1 -p jacobi -tol 1e-10" by bicg, bicr, bicgstab
   and bicrstab, which scale the grid itself (lane_shuffle); then
   "-i cg -p jacobi -storage cst -scale 1" on phase 4's prebuilt SPD CST
   (scale_symm); then "-i bicgstab -p is -storage cst" on the
   nonsymmetric CST (I+S forces -scale 1); then the same options as the
   first four on the nonsymmetric CST for the eleven nonsymmetric solvers
   of the Krylov slice (cgs, crs, tfqmr, orthomin, gpbicg, gpbicr,
   bicgsafe, bicrsafe, bicgstabl, idrs, idr1).
   Each: SUCCESS, true residual <= 1e-9 (scipy too), lane_shuffle
   launched, the oracle at n = 2^17; BiCG and BiCR launch kernels A-D at
   least once per iteration, the slice's solvers exactly as often as one
   matvec launches each on A's grid and on the transpose grid times the
   solver's matvecs and Aᴴ products (``krylov_counts``), printed beside;
6. complex: the complex-symmetric a + aᵀ + 32·I with complex128 values on
   the same pattern, one CST; cocg and cocr with -p jacobi, checked as
   in phase 5 with lane_shuffle launched at least once per iteration;
   cocg at -f single, which must keep complex128 and whose oracle is the
   CPU run at double; the complex CST matvec against its plain version
   to rel 1e-12, both timed;
7. dia kernels: E (dia_spmv) and F (dia_spmvh) against their plain
   versions on poisson3d27 96³ (884,736 rows, 27 diagonals) in f32, f64
   and complex128, with a complex vector on the real diagonals, and on a
   nonsymmetric banded matrix of 1,000,003 rows with offsets beyond n/2,
   to rtol 1e-13 / 1e-5; the four kernels of the fused CG step (G) against
   their plain versions from one state: p, x and r bit-equal, sums to rtol
   1e-12 / 1e-5, the breakdown freeze and the no-op after the loop ended.
   E, F and G are timed beside their plain versions and their bounds; E
   also beside ``torch.sparse`` CSR @ x (built outside the timed region)
   and the port's CSR gather matvec;
8. main path, all with default routing (no -storage): (a) poisson2d
   512x512 written to a MatrixMarket file and solved by
   ``lis_tpu_torch.cli.lsolve.main``: exit 0, route dia; (b)
   solve(poisson3d27 96³ CSR, ones, "-i cg -p jacobi -tol 1e-8"): route
   dia, SUCCESS, true residual <= 1e-7, the CPU plain path's iteration
   count ±1 (the dot products sum in another order), E launched once per
   iteration plus once for the initial residual and G's kernels exactly
   as often as the step calls them, so no call took a plain version; the
   same at -f single (finite, SUCCESS, true residual <= 3e-4 and within
   2x of the CPU's at -f single: float32 stalls near 1.5e-4 on this
   system at any tolerance) and with bicg (E and F per iteration); the
   step of torch operations timed on the same DIA beside the fused one,
   and the fused one with the loop condition read every 16 steps; (c)
   poisson3d27_dia 192³ (7,077,888 rows, 1.53 GB of diagonals) solved the same way and held to the iteration count ±1 of a
   CG loop over the plain versions of E and G on the card, written out in
   this script; (d) phase 3's locality-free matrix with no -storage: route
   cst, kernels A-D launched, beside the wall of the same solve with
   -auto_storage false (CSR); (e) a nonsymmetric matrix of 2^20 rows with
   6 random columns per row within ±2000 of the diagonal: route css (torch
   operations, no kernel), solved by bicgstab, bicg and bicg -scale 1 to
   true residual <= 1e-9 (scipy too) in the CPU CSR solve's iterations ±1;
   the CSS matvec, matvech (through the transpose and by the scatter) and
   diagonal on the card against scipy to 1e-12.

9. preconditioned, the hpcg configuration: (a) kernels H (dia_relax) and
   I (dia_relaxh) on the strict triangles of poisson3d27_dia 96³ (13
   diagonals each) and K (trisolve_levels) on the level plan of its
   (D + L) (666 levels of at most 2304 rows), each against its plain
   version in f64, f32 and complex128 to rtol 1e-13 / 1e-5 (real H and I
   also checked bit for bit in their start and no-term forms), timed
   beside the plain version, the bound and the library call (torch.sparse
   CSR @ y for the sweep's product; torch.triangular_solve on a sparse CSR
   for K, where this torch takes it), K's time also per level; then K
   against its plain version on the upper plan of the same operator
   (plain and with the ``rs`` fold), with NaN and Inf in b (same NaN/Inf
   pattern), on the ILU(1) factors of poisson3d27 32³ (rows longer than
   16 entries) in f64 and f32, on a bidiagonal of 20,000 rows (one level
   per row) and on a diagonal plan (one level); (b)
   ``cli.hpcg.main(["96", "96", "96"])`` with its defaults (-i cg -p ssor
   -adds true): exit 0, route
   dia, SUCCESS, true residual <= 1e-7, H launched exactly 9 times per
   iteration and E, G as the fused step calls them (so no sweep took a
   plain version), and the CPU run's iteration count ±1; (c) the same at
   192³ (poisson3d27_dia, 1.53 GB of diagonals), held to the iteration
   count ±1 of a CG + SSOR + additive Schwarz loop over the plain versions
   of E, G and H on the card, written out in this script; (d) cg -p ilu on
   the 96³ CSR, routed to DIA (ILU(0) by the native factor on the host,
   timed), H 4 times per iteration, the CPU's count ±1; (e) gmres
   -restart 30 -p ssor on the same operator, bicg -p ssor on a
   nonsymmetric 96³ DIA (I launched), and on poisson3d27 64³ CSR the
   level-scheduled -i cg -p ssor -auto_storage false (K twice per
   iteration, and one psolve dispatching no torch operation but K's
   allocations, so nothing runs between its two launches) and -i sor -tol
   1e-8 (DIA, ω = 1.9: the level plan, K once per iteration), held to the
   CPU's count exactly (the others ±1).  Every solve prints its ms/iter
   beside one psolve's and one matvec's time on the card.
10. the Krylov slice: (a) at 96³ on poisson3d27_dia (minres, orthomin)
   and phase 9's nonsymmetric variant (the other ten), "-p jacobi -tol
   1e-8" (cgs, crs and tfqmr with -p ssor: under Jacobi they stagnate
   near 1e-7 on the variant, as in lis_tpu), and bicgstabl -p ssor and
   idrs -irestart 4 -p ssor on the variant; (b) at 192³ on poisson3d27_dia, bicgstabl and idrs -irestart
   4 with -p jacobi.  Each: SUCCESS, true residual <= 1e-7, E, F and H
   launched exactly as the solver's matvecs, Aᴴ products and psolves imply
   (``krylov_counts``; nothing else launched), and the iteration count ±1
   (BiCGSTAB(l): ±l, one cycle) of the same solver function over a
   wrapper whose matvec and matvech are E's and F's plain versions on the
   card (and, under SSOR, a psolve over H's), checked to launch no
   kernel; at 192³ x also to 1e-6 relative.  Each solve runs once
   untimed first.  Each prints ms/iter, kernel launches and all launches per
   iteration (torch operations counted by a dispatch mode in a second
   solve, views and allocations left out) and host reads per iteration,
   then one table row.
11. the remaining preconditioners: (a) kernels J (lattice_prolong) and L
   (lattice_restrict) over the smoothed prolongator P assembled as the
   solve path assembles it (``LatticeTransfer``), against their plain
   versions, bit-equal, on the 96³ fine level (timed beside the plain
   version, the byte bound of P's CSR arrays and the vectors, and the
   one-call library counterpart: torch.sparse.addmm(x, P, ec) and
   torch.sparse.mm(Pᵀ, r) on the same P as torch sparse CSR, built
   outside the timed region) and on a 94x95x97 lattice (cropped edge
   boxes), f64 and f32; at f64 the assembled P is also held to lis_tpu's
   implicit form (z = Pt·ec, z − ω·D⁻¹(A·z), on the level's DIA) to rtol
   1e-12; (b) solve(poisson3d27 96³ CSR, ones, "-i cg -p
   saamg -tol 1e-10") with default routing: route dia, the lattice
   hierarchy, SUCCESS, true residual <= 1e-9, the CPU's count ±1, and J,
   L once and H twelve times per level per V-cycle (E, G as CG calls
   them); (c) the same on poisson3d27_dia 192³ with the hierarchy built
   once (its time printed), held to the count ±1 and x to 1e-6 of CG
   over the plain versions of E, G, H, J and L on the card, written out
   here (``plain_pcg``, ``plain_vcycle``); (d) "-saamg_lattice false" on
   a 64³ CSR: the graph path, K four times per level per V-cycle, the
   CPU's count ±1; (e) on the 64³ operator, bicgstab with ilut and with
   iluc -iluc_drop 0.01 (routed to DIA: H; -auto_storage false: K), cg
   -p sainv -sainv_drop 0.01, cg -p bjacobi and gmres -p hybrid at -tol
   1e-10, and bicgstab -p is at -tol 1e-8 on phase 9's nonsymmetric
   variant (on the SPD operator a 1e-14 change in b moves its count by 12,
   tools/count_spread.py), each SUCCESS at the CPU's count ±1 with the
   kernels its apply
   uses launched.  Each SA-AMG solve prints the level sizes, ptime,
   ms/iter, one psolve's time and launches, the finest level's kernel
   times (J and L beside their byte bound) and the device memory of the
   transfers.
12. the precision modes (``phase quad:`` lines): (a) kernels M
   (dd_dia_spmv, both directions, on the 96³ poisson3d27 DIA), N
   (dd_ell_spmv, A and Aᵀ, on phase 3's n = 2^20 system as ELL arrays), O
   (dd_reduce: sum, dot, nrm2, nrm1) and P (dd_update: axpy, xpay, scal,
   add, sub) on 96³ vectors, each in f64 pairs and f32 pairs (df) against
   its plain version, bit-equal, and O's dot at 192³ (m = 2^23) in f64
   pairs; the forward M, N, the dots and axpy timed
   beside the plain version and the bound (no PyTorch call computes
   double-double arithmetic: library none); (b) ``-i cg -p jacobi -f quad
   -tol 1e-12`` on poisson3d27 96³ (CSR -> router -> DIA) and 192³ (built
   in DIA): SUCCESS, DD residual <= 1e-12, true residual <= 1e-11, the
   count of the same solve over the plain versions of M-P on the card
   exactly (every M-P wrapper swapped for its plain version, which must
   launch no kernel), M, O, P launched exactly it + 1, 3 it + 1, 3 it + 1
   times at 96³, and the torch operations and host reads per iteration
   counted by a dispatch mode; (c) test5: ``-i bicg -f quad -tol 1e-12
   -maxiter 500`` on gamma_matrix(200, 2.0), b = A·1: SUCCESS in the CPU's
   count where ``-f double`` ends MAXITER; (d) -f switch (-switch_tol
   1e-8), df and switch_df at 96³, each SUCCESS within the limits of (b);
   (e) ``-i bicgstab -f quad -auto_storage false`` on the n = 2^20 CSR (N,
   twice per iteration), the oracle's count exactly; (f) the 17 twins with
   -p jacobi -restart 8 -tol 1e-8 on the 7-point poisson3d 64³ shifted by
   6·I, in DIA (GMRES, FGMRES and Orthomin restart every 8 steps), each
   SUCCESS at its plain oracle's count;
13. the scalar formats, RCM, -use_at and the I/O (``phase formats:``
   lines): (a) poisson3d27 96³ converted to coo, csc, msr, ell and jad,
   each matvec and matvech held to the CSR's to rtol 1e-13 and timed
   from the device's queue beside the CSR gather and the bound (the
   format's array bytes plus 2n·8 over 3.35 TB/s); (b) ``-i cg -p jacobi
   -tol 1e-10 -storage X`` for csr and the five: SUCCESS, true residual
   <= 1e-9, the csr count ±1, G once an iteration; (c) ``-i bicgstab -f
   quad -tol 1e-12 -storage csr|coo|jad``: the csr count exactly, N 2·it
   + 1 times; (d) ``-i cg -p ssor -storage ell`` on poisson3d27 64³: the
   csr count ±1, K twice an iteration; (e) poisson2d 128² (n = 16384) as
   DNS, 2 GiB, checked as in (b) and its torch.mv timed; (f) poisson3d27
   64³ scrambled by a seeded symmetric permutation, solved with
   ``-reorder rcm``: the route and the bandwidth before and after, the
   unscrambled count ±1 and x to 1e-8; (g) ``-use_at true`` on phase 9's
   nonsymmetric variant: the explicit Aᴴ's product held to F's (rtol
   1e-13); BiCG and BiCR + Jacobi on the 64³ DIA, and BiCG + SSOR on the
   96³ CSR (-auto_storage false: at 96³ BiCG + Jacobi is count-unstable),
   each at the ``-use_at false`` count ±1, F never launched with it;
   (h) phase 8a's matrix written as hb, lis and
   binary MM in both byte orders, b as plain and lisb, each read back
   through ``lsolve`` with the MM file's count exactly (parse seconds
   printed), and built by ``MatrixAssembler`` entry by entry to the
   generator's arrays.  The per-format rows go on a JSON line of their
   own (``{"formats": [...]}``) before the kernels line.

Phases 1 to 13 all run at the sizes named here.  The matrices of phases 3
to 6 are built with no ``device`` argument, so they live on the default
device, the card.  Their CPU oracles (the port's plain path on the CPU,
whose Benes passes take up to a minute a solve at n = 2^20) run at
n = 2^17 on systems of the same kinds: each solve is made there on the
card and on the CPU, and the iteration counts must agree ±1 (the CSR
remainder sums with atomics on the card); the card's solves at n = 2^20
keep every other check.

Launch counts are set to 0 just before each solve of phases 3, 5, 6 and
8 to 13 and read just after; launches made to compare a kernel with its plain
version are not counted.  It prints one JSON line of per-kernel results
(each row's ``timing`` says how its ``ms`` was taken; where that is
"queued", ``host_ms`` and ``library_host_ms`` are the kernel's and the
library call's figures taken as ``plain_ms`` is), then as its
last line {"ok": true, "device": {...}}.  Any failure exits
non-zero before that line; so does a machine without CUDA.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def system(n: int, k: int, seed: int, kind: str = "spd"):
    """a + aᵀ + 4k·I ("spd"), a − 0.5·aᵀ + 4k·I ("nonsym") or a + aᵀ + 4k·I
    with standard-normal real and imaginary parts ("csym"), where a has k
    random columns per row: one sparsity pattern for every kind (scipy
    CSR)."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, size=n * k)
    vals = rng.standard_normal(n * k)
    if kind == "csym":
        vals = vals + 1j * rng.standard_normal(n * k)
    a = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    a = (a - 0.5 * a.T if kind == "nonsym" else a + a.T) + sp.eye(n) * (4 * k)
    a = a.tocsr()
    a.sort_indices()
    return a


def windowed(n: int, w: int, seed: int):
    """30·I plus 6 random columns per row within ±w of the diagonal,
    nonsymmetric (scipy CSR): a pattern neither banded nor fit for the
    CST grid, which the router sends to CSS."""
    import scipy.sparse as sp
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), 6)
    cols = np.clip(rows + rng.integers(-w, w, n * 6), 0, n - 1)
    a = sp.coo_matrix((rng.standard_normal(n * 6), (rows, cols)),
                      shape=(n, n)).tocsr()
    a = (a + sp.eye(n) * 30).tocsr()
    a.sort_indices()
    return a


def cuda_ms(fn, reps: int = 20, warm: int = 3, queued: bool = False) -> float:
    """Mean device time of fn() in ms over ``reps`` back-to-back calls,
    measured with CUDA events after ``warm`` untimed calls.  With
    ``queued`` the calls are enqueued while the device is still busy with
    two earlier products of 4096 x 4096 matrices (a few ms), so they run
    back to back from the queue and the host's time to enqueue a launch
    is not in the figure: for kernels of a few microseconds."""
    import torch
    for _ in range(warm):
        fn()
    if queued and not hasattr(cuda_ms, "spin"):
        cuda_ms.spin = torch.ones((4096, 4096), device="cuda")
        cuda_ms.spun = torch.empty_like(cuda_ms.spin)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if queued:
        for _ in range(2):
            torch.mm(cuda_ms.spin, cuda_ms.spin, out=cuda_ms.spun)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# The card's peaks (NVIDIA H100 SXM data sheet): device memory rate, and
# the arithmetic rate outside the tensor cores for each real type.
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {"float32": 67e12, "float64": 33.5e12}


def bound_ms(nbytes: int, flops: int, dtype) -> tuple[float, str]:
    """The least time the card could take: (ms, "bytes" | "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FLOPS_PER_S[str(dtype)[6:]]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    t_start = time.perf_counter()

    def stamp(what):
        print(f"phase time: {what} starts at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a "
             "CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import lis_tpu_torch
        from lis_tpu_torch.cli import lsolve
        from lis_tpu_torch.core import ddreal as dq, vector as v
        from lis_tpu_torch.matrix import cst as cstm, dia as diam
        from lis_tpu_torch.ops import _cuda, amg, shuffle as sh
        from lis_tpu_torch.ops import trisolve as tsm
        from lis_tpu_torch.runtime.options import SolverOptions
        from lis_tpu_torch.utils import testmat
    except ImportError as e:
        fail(f"lis_tpu_torch is not importable next to this script ({e})")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # ---- 1. environment ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(smi_line)
    print(f"phase env: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    _cuda.lib()
    print(f"phase build: kernels ready in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_cuda.build_seconds or 0.0:.2f} s)")
    for ln in _cuda.build_log.splitlines():
        if "Compiling entry" in ln or "Used" in ln:
            print("  ptxas:", ln.split(":", 1)[-1].strip())

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def randn(n, dtype):
        if dtype.is_complex:
            re = torch.randn(2 * n, generator=gen, device=dev,
                             dtype=torch.float64)
            return torch.complex(re[:n], re[n:]).to(dtype)
        return torch.randn(n, generator=gen, device=dev,
                           dtype=torch.float64).to(dtype)

    def row_perms(M, d=128):
        """Random lane permutations of each 128-lane row, within aligned
        groups of d lanes (a pass with digit d)."""
        r = torch.rand(M // 128, 128 // d, d, generator=gen, device=dev)
        base = torch.arange(0, 128, d, device=dev).view(1, -1, 1)
        return (torch.argsort(r, dim=2) + base).view(-1, 128).to(torch.uint8)

    # ---- 2. kernels against their plain versions ---------------------------
    stamp("phase 2")
    M = 1 << 25              # the slot count of the n = 2^20, Kp = 32 grid
    CB = (1 << 20) // 128
    mtag = f"M=2^{M.bit_length() - 1}"
    results = {}             # kernel -> dict of the f64 numbers
    results32 = {}          # the same at f32

    def check(name, dtype, shape, got, want, exact, timed=None, rtol=None,
              queued=False, record=True):
        """Hold a kernel's output against its plain version's; with
        ``timed`` = (kernel fn, plain fn, library fn or None, bytes moved,
        additions and multiplications) also time them (the slice's shape:
        recorded per dtype).  The record's ``timing`` says how ``ms`` and
        ``library_ms`` were taken: "host", as ``plain_ms`` always is (the
        host enqueues each call as the device runs), or, with ``queued``,
        "queued" (from the device's queue, see cuda_ms); ``host_ms`` and
        ``library_host_ms`` are then the kernel's and the library call's
        times taken as ``plain_ms`` is, the pair to hold against each
        other where the host's launch is what a solve pays."""
        wide = torch.complex128 if got.is_complex() else torch.float64
        err = (got.to(wide) - want.to(wide)).abs().max().item()
        if exact:
            ok = torch.equal(got, want)
        else:
            if rtol is None:
                rtol = 1e-12 if dtype in (torch.float64,
                                          torch.complex128) else 1e-5
            scale = want.to(wide).abs().max().item()
            ok = err <= rtol * max(scale, 1.0)
        line = (f"phase kernels: {name} {str(dtype)[6:]} {shape}: "
                f"max_abs_err {err:.3e} "
                f"({'bit-equal' if exact else 'rtol'}) "
                f"{'ok' if ok else 'MISMATCH'}")
        if timed is not None:
            kern, plain, library, nbytes, flops = timed
            ms, plain_ms = cuda_ms(kern, queued=queued), cuda_ms(plain)
            lib_ms = None if library is None else cuda_ms(library,
                                                          queued=queued)
            b_ms, b_by = bound_ms(nbytes, flops, dtype)
            rec = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                   "timing": "queued" if queued else "host"}
            if record and dtype == torch.float64:
                results[name] = rec
            elif record and dtype == torch.float32:
                results32[name] = rec
            line += (f"; {ms:.4f} ms vs plain {plain_ms:.4f} ms, bound "
                     f"{b_ms:.4f} ms ({b_by}, {100 * b_ms / ms:.0f} %), "
                     f"library " + ("none" if lib_ms is None
                                    else f"{lib_ms:.4f} ms"))
            if queued:
                rec["host_ms"] = cuda_ms(kern)
                line += (f"; {rec['host_ms']:.4f} ms a call with the host "
                         f"enqueueing each launch, as the plain version's")
                if library is not None:
                    rec["library_host_ms"] = cuda_ms(library)
                    line += (f" (library "
                             f"{rec['library_host_ms']:.4f} ms)")
        print(line, flush=True)
        if not ok:
            fail(f"{name} {dtype} {shape} disagrees with its plain version")

    def es(dtype):
        return torch.empty((), dtype=dtype).element_size()

    # ---- launch counts over the counted solves of phases 3, 5, 6, 8-10 -----
    kernels = {"lane_shuffle": sh.lane_shuffle, "cst_front": cstm.cst_front,
               "benes_pass": sh.benes_pass,
               "benes_pass_rowsum": sh.benes_pass_rowsum,
               "benes_small_run": sh.benes_small_run,
               "dia_spmv": diam.dia_spmv, "dia_spmvh": diam.dia_spmvh,
               "krylov_dot": v.krylov_dot, "cg_direction": v.cg_direction,
               "cg_update": v.cg_update, "cg_finish": v.cg_finish,
               "dia_relax": diam.dia_relax, "dia_relaxh": diam.dia_relaxh,
               "trisolve": tsm.trisolve,
               "lattice_prolong": amg.lattice_prolong,
               "lattice_restrict": amg.lattice_restrict,
               "dd_dia_spmv": dq.dd_dia_spmv, "dd_ell_spmv": dq.dd_ell_spmv,
               "dd_reduce": dq.dd_reduce, "dd_update": dq.dd_update}
    matvec_kernels = ("cst_front", "benes_pass", "benes_pass_rowsum",
                      "benes_small_run")
    total = dict.fromkeys(kernels, 0)     # launches over the counted solves

    def counted(fn):
        """fn() with every launch count set to 0 just before it and read
        just after: (result, launches, wall s)."""
        for f in kernels.values():
            f.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {name: f.launches for name, f in kernels.items()}
        for name, cnt in got.items():
            total[name] += cnt
        return out, got, wall

    def need_launches(got, names, least, what):
        for name in names:
            if got[name] < least:
                fail(f"{what}: {name} launched {got[name]} times, "
                     f"expected at least {least}")

    def route_of(A, opts):
        return lis_tpu_torch.transform_operator(
            A, SolverOptions.from_string(opts)).format_name

    def launches_per(fn):
        """The launches of one call of fn(), counted outside the solves'
        counts."""
        for f in kernels.values():
            f.launches = 0
        fn()
        torch.cuda.synchronize()
        got = {name: f.launches for name, f in kernels.items()}
        for f in kernels.values():
            f.launches = 0
        return got

    def need_exact(got, want, what):
        for name, cnt in want.items():
            if got[name] != cnt:
                fail(f"{what}: {name} launched {got[name]} times, expected "
                     f"exactly {cnt}: a call took another path")

    S = types.SimpleNamespace(
        dev=dev, kernels=kernels, check=check, counted=counted, stamp=stamp,
        need_launches=need_launches, launches_per=launches_per,
        need_exact=need_exact, route_of=route_of, randn=randn, es=es,
        results=results, results32=results32, grids=(96, 192, 64),
        seed=args.seed, gen=gen)
    R = M // 128
    for dtype in (torch.float64, torch.float32, torch.complex128,
                  torch.complex64):
        for rep in (1, 32):     # rep 32: the select of the Kp = 32 grid
            x, idx = randn(R // rep * 128, dtype).view(-1, 128), row_perms(M)
            timed = None
            if rep == 1 and not dtype.is_complex:
                wide = idx.long()       # the library call's index, untimed
                timed = (lambda: sh.lane_shuffle(x, idx, rep),
                         lambda: sh._lane_shuffle_plain(x, idx, rep),
                         lambda: torch.gather(x, 1, wide),
                         M * (2 * es(dtype) + 1), 0)
            check("lane_shuffle", dtype, f"R=2^{R.bit_length() - 1} "
                  f"rep={rep}", sh.lane_shuffle(x, idx, rep),
                  sh._lane_shuffle_plain(x, idx, rep), True, timed)
            del timed
    for dtype in (torch.float64, torch.float32):
        for s in (1, 128, 16384):
            x, idx = randn(M, dtype), row_perms(M)
            timed = None
            if s == 16384:
                # out[p, a, w] = x[p, idx[p s + w, a], w] as one gather
                # along a of the (P, 128, s) view; the index is untimed
                x3 = x.view(-1, 128, s)
                i3 = idx.view(-1, s, 128).transpose(1, 2).long().contiguous()
                if not torch.equal(torch.gather(x3, 1, i3).reshape(-1),
                                   sh._pass_plain(x, idx, 128, s)):
                    fail("benes_pass: the library gather disagrees")
                timed = (lambda: sh.benes_pass(x, idx, 128, s),
                         lambda: sh._pass_plain(x, idx, 128, s),
                         lambda: torch.gather(x3, 1, i3),
                         M * (2 * es(dtype) + 1), 0)
            check("benes_pass", dtype, f"{mtag} s={s}",
                  sh.benes_pass(x, idx, 128, s),
                  sh._pass_plain(x, idx, 128, s), True, timed)
            if timed is not None:
                del timed, x3, i3
        d, s = 16, 1024         # a digit below 128: lane_shuffle's route
        x, idx = randn(M, dtype), row_perms(M, d)
        check("benes_pass", dtype, f"{mtag} d={d} s={s} (lane_shuffle)",
              sh.benes_pass(x, idx, d, s), sh._pass_plain(x, idx, d, s),
              True)
        for s, kp in ((16384, 32), (16384, 2), (1024, 256), (128, 16)):
            x, idx = randn(M, dtype), row_perms(M)
            check("benes_pass_rowsum", dtype, f"{mtag} s={s} Kp={kp}",
                  sh.benes_pass_rowsum(x, idx, s, kp),
                  sh._pass_plain(x, idx, 128, s).view(-1, kp).sum(1), False,
                  (lambda: sh.benes_pass_rowsum(x, idx, s, kp),
                   lambda: sh._pass_plain(x, idx, 128, s).view(-1, kp)
                   .sum(1), None,
                   M * (es(dtype) + 1) + M // kp * es(dtype),
                   M - M // kp) if (s, kp) == (16384, 32) else None)

        def run_plain(x, idxs, ss, kp):
            out = x
            for i, s in zip(idxs, ss):
                out = sh._pass_plain(out, i, 128, s)
            return out if kp is None else out.view(-1, kp).sum(1)

        # the slice's run at its size, timed; then every run shape on one
        # tile and on 133 tiles (a count that no grid divides), untimed
        ss = [128, 1, 128]
        x, idxs = randn(M, dtype), [row_perms(M) for _ in ss]
        run = sh.RunTables(idxs, ss)
        for kp in (None, 2, 16, 32, 128):
            check("benes_small_run", dtype, f"{mtag} s={ss} Kp={kp}",
                  sh.benes_small_run(x, run, Kp=kp),
                  run_plain(x, idxs, ss, kp), kp is None,
                  (lambda: sh.benes_small_run(x, run, Kp=kp),
                   lambda: run_plain(x, idxs, ss, kp), None,
                   M * (2 * es(dtype) + len(ss)), 0)
                  if kp is None else None)
        for Ms in (16384, 16384 * 133):
            for ss in ([1], [128], [1, 128], [128, 1], [1, 128, 1, 128],
                       [128, 1, 1, 128, 128, 1, 128, 1]):
                xs, idxs = randn(Ms, dtype), [row_perms(Ms) for _ in ss]
                run = sh.RunTables(idxs, ss)
                for kp in (None, 2, 16, 32, 128):
                    check("benes_small_run", dtype,
                          f"M={Ms} s={ss} Kp={kp}",
                          sh.benes_small_run(xs, run, Kp=kp),
                          run_plain(xs, idxs, ss, kp), kp is None)
        for beta, rbc in ((256, 16), (4096, 1), (64, 32)):
            n_slot = CB * rbc * beta
            xp = randn(CB * 128, dtype)
            lidx = torch.randint(0, 128, (n_slot,), generator=gen,
                                 device=dev, dtype=torch.uint8)
            val = randn(n_slot, dtype)
            check("cst_front", dtype, f"CB={CB} beta={beta} RBc={rbc}",
                  cstm.cst_front(xp, lidx, val, rbc, beta),
                  cstm._front_plain(xp, lidx, val, rbc, beta), True,
                  (lambda: cstm.cst_front(xp, lidx, val, rbc, beta),
                   lambda: cstm._front_plain(xp, lidx, val, rbc, beta), None,
                   n_slot * (2 * es(dtype) + 1) + CB * 128 * es(dtype),
                   n_slot) if (beta, rbc) == (4096, 1) else None)
    for name, r32 in results32.items():
        print(f"phase kernels: {name} float32 at the slice's shape: "
              f"{r32['ms']:.4f} ms vs plain {r32['plain_ms']:.4f} ms, "
              f"bound {r32['bound_ms']:.4f} ms, library "
              f"{r32['library_ms']}", flush=True)
    del x, xs, idx, idxs, run, xp, lidx, val, wide
    torch.cuda.empty_cache()

    # ---- 3. the slice: CG + Jacobi over the CST SpMV -----------------------
    stamp("phase 3")
    n, k = 1 << 20, 8
    t0 = time.perf_counter()
    a = system(n, k, args.seed)
    csr = (a.indptr, a.indices, a.data, a.shape)
    A = lis_tpu_torch.CSRMatrix.from_csr_arrays(*csr)   # the default device
    A_cpu = lis_tpu_torch.CSRMatrix.from_csr_arrays(*csr, device="cpu")
    if A.device.type != "cuda" or A_cpu.device.type != "cpu":
        fail(f"a matrix built with no device lives on {A.device}, with "
             f"device='cpu' on {A_cpu.device}")
    b = np.ones(n)
    print(f"phase slice: system n={n} nnz={a.nnz} built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    opts = "-i cg -p jacobi -storage cst -tol 1e-10"
    r, launches, t_cold = counted(
        lambda: lis_tpu_torch.solve(A, b, options=opts))

    def report(tag, res, wall):
        print(f"phase slice: {tag}: status {res.status} iters {res.iters} "
              f"true_resid {res.true_resid:.3e} solve {wall:.2f} s "
              f"(itime {res.itime:.4f} s, "
              f"{1e3 * res.itime / max(res.iters, 1):.4f} ms/iter)",
              flush=True)

    report("cuda f64 cold (CST build included)", r, t_cold)
    x = r.x.cpu().numpy()
    res_scipy = np.linalg.norm(a @ x - b) / np.linalg.norm(b)
    print(f"phase slice: launches {launches}; scipy residual of x "
          f"{res_scipy:.3e}", flush=True)
    if r.status != lis_tpu_torch.LIS_SUCCESS:
        fail(f"slice status {r.status}")
    if not (r.true_resid <= 1e-9 and res_scipy <= 1e-9):
        fail(f"true residual {r.true_resid:.3e} / {res_scipy:.3e} > 1e-9")
    need_launches(launches, matvec_kernels, r.iters, "slice")
    t0 = time.perf_counter()
    r2 = lis_tpu_torch.solve(A, b, options=opts)
    t_warm = time.perf_counter() - t0
    report("cuda f64 warm", r2, t_warm)
    it_cst = r.iters
    # the CPU's plain CST passes take minutes at n = 2^20, so the CPU
    # oracle of phases 3, 5 and 6 runs at n = 2^17, on systems of the same
    # kinds, each solved on the card and on the CPU
    ns = 1 << 17
    a_s = system(ns, k, args.seed)
    b_s = np.ones(ns)
    csr_s = (a_s.indptr, a_s.indices, a_s.data, a_s.shape)
    t0 = time.perf_counter()
    r_s = lis_tpu_torch.solve(lis_tpu_torch.CSRMatrix.from_csr_arrays(
        *csr_s), b_s, options=opts)
    rc = lis_tpu_torch.solve(lis_tpu_torch.CSRMatrix.from_csr_arrays(
        *csr_s, device="cpu"), b_s, options=opts)
    report(f"n=2^17 oracle, cuda {r_s.iters} iterations; cpu f64 plain "
           f"path", rc, time.perf_counter() - t0)
    if abs(rc.iters - r_s.iters) > 1 or rc.status != r_s.status \
            or r_s.status != lis_tpu_torch.LIS_SUCCESS:
        fail(f"n=2^17: cuda iters {r_s.iters} vs cpu iters {rc.iters}")
    t0 = time.perf_counter()
    rs = lis_tpu_torch.solve(A, b, options=opts + " -f single")
    report("cuda -f single", rs, time.perf_counter() - t0)
    if not (np.isfinite(rs.x.cpu().numpy()).all()
            and rs.true_resid <= 1e-4):
        fail(f"-f single true residual {rs.true_resid:.3e}")

    # ---- 4. CST matvec: kernels against plain torch on the card ------------
    stamp("phase 4")
    def cst_pair(a_sp, **kw):
        """A CST of ``a_sp`` built with no device (so on the card), and
        its CPU copy; one host build serves both."""
        Cd = cstm.CSTMatrix.from_csr_arrays(a_sp.indptr, a_sp.indices,
                                            a_sp.data, a_sp.shape, **kw)
        if Cd.device.type != "cuda" or Cd.plan.device.type != "cuda":
            fail(f"a CST built with no device lives on {Cd.device}")
        return Cd, Cd.to("cpu")

    C, _ = cst_pair(a, transpose=False)
    C_s = cst_pair(a_s, transpose=False) + (b_s,)     # the oracle's

    def plain_matvec(C, xv):
        """C.matvec(xv) through the kernels' plain versions only."""
        xp = torch.nn.functional.pad(xv, (0, C.n_pad - xv.shape[0]))
        if xv.is_complex():
            t = sh._lane_shuffle_plain(xp.view(-1, 128), C.lidx, C.Kp) * C.val
            t = t.view(-1, C.RBc, C.beta).transpose(0, 1).reshape(-1)
        else:
            t = cstm._front_plain(xp, C.lidx, C.val, C.RBc, C.beta)

        def route(t):
            for (d, s), idx in zip(C.plan.meta, C.plan.idxs):
                t = sh._pass_plain(t, idx, d, s)
            return t.view(-1, C.Kp).sum(1)

        y = (torch.complex(route(t.real.contiguous()),
                           route(t.imag.contiguous()))
             if t.is_complex() else route(t))[: C.nrows]
        return y if C.rem is None else y + C.rem.matvec(xv)

    xv = randn(n, torch.float64)
    y_k, y_p = C.matvec(xv), plain_matvec(C, xv)
    err = ((y_k - y_p).abs().max() / y_p.abs().max()).item()
    ms_k = cuda_ms(lambda: C.matvec(xv))
    ms_p = cuda_ms(lambda: plain_matvec(C, xv))
    ms_csr = cuda_ms(lambda: A.matvec(xv))
    traffic = a.nnz * 12 + 2 * n * 8
    print(f"phase matvec: CST Kp={C.Kp} M=2^{C.plan.M.bit_length() - 1} "
          f"passes {C.plan.meta} rem {0 if C.rem is None else C.rem.nnz}: "
          f"kernels {ms_k:.4f} ms = {traffic / ms_k / 1e6:.2f} GB/s, "
          f"plain torch {ms_p:.4f} ms = {traffic / ms_p / 1e6:.2f} GB/s, "
          f"CSR gather {ms_csr:.4f} ms = {traffic / ms_csr / 1e6:.2f} GB/s "
          f"(csr-equivalent); kernel vs plain rel err {err:.2e}",
          flush=True)
    if err > 1e-12:
        fail(f"CST matvec kernels vs plain: relative error {err:.3e}")

    def solve_checked(tag, Ad, a_sp, b, opts, per_iter, once, small,
                      rc=None, exact=None):
        """One counted solve on the card (n = 2^20): SUCCESS, true
        residual <= 1e-9 (the port's and scipy's), the kernels in
        ``per_iter`` launched at least once per iteration, those in
        ``once`` at least once, and with ``exact`` (a function of the
        result giving {kernel: count}) each of those exactly so often.
        The oracle runs on ``small`` = (card operator, its CPU copy, b) at
        n = 2^17: the card's iterations equal the CPU's ±1 (or those of
        the CPU result ``rc`` of an equivalent solve).  Returns (result,
        wall s, CPU result)."""
        r, got, wall = counted(
            lambda: lis_tpu_torch.solve(Ad, b, options=opts))
        Sd, Sc, s_b = small
        r_s = lis_tpu_torch.solve(Sd, s_b, options=opts)
        t0 = time.perf_counter()
        if rc is None:
            rc = lis_tpu_torch.solve(Sc, s_b, options=opts)
        wall_cpu = time.perf_counter() - t0
        x = r.x.cpu().numpy()
        res_scipy = np.linalg.norm(a_sp @ x - b) / np.linalg.norm(b)
        print(f"phase {tag}: {opts}: status {r.status} iters {r.iters} "
              f"true_resid {r.true_resid:.3e} (scipy {res_scipy:.3e}) x "
              f"{r.x.dtype}; solve {wall:.4f} s (itime {r.itime:.4f} s, "
              f"{1e3 * r.itime / max(r.iters, 1):.4f} ms/iter); n=2^17 "
              f"oracle: cuda {r_s.iters} it, cpu {rc.iters} it in "
              f"{wall_cpu:.2f} s; launches {got}", flush=True)
        if r.status != lis_tpu_torch.LIS_SUCCESS or rc.status != r_s.status \
                or r_s.status != lis_tpu_torch.LIS_SUCCESS:
            fail(f"{tag} {opts}: status {r.status} (n=2^17: cuda "
                 f"{r_s.status}, cpu {rc.status})")
        if not (r.true_resid <= 1e-9 and res_scipy <= 1e-9):
            fail(f"{tag} {opts}: true residual {r.true_resid:.3e} / "
                 f"{res_scipy:.3e} > 1e-9")
        if abs(rc.iters - r_s.iters) > 1:
            fail(f"{tag} {opts}: n=2^17 cuda iters {r_s.iters} vs cpu "
                 f"{rc.iters}")
        need_launches(got, per_iter, r.iters, f"{tag} {opts}")
        need_launches(got, once, 1, f"{tag} {opts}")
        if exact is not None:
            want = exact(r)
            print(f"phase {tag}: {opts}: launches the code implies {want}",
                  flush=True)
            need_exact(got, want, f"{tag} {opts}")
        return r, wall, rc

    # ---- 5. reuse: one prebuilt CST, scaled by each solve ------------------
    stamp("phase 5")
    t0 = time.perf_counter()
    an = system(n, k, args.seed, "nonsym")
    N, _ = cst_pair(an)
    an_s = system(ns, k, args.seed, "nonsym")
    N_s = cst_pair(an_s) + (b_s,)
    print(f"phase reuse: nonsymmetric system nnz={an.nnz}, CST with its "
          f"transpose grid built once in {time.perf_counter() - t0:.2f} s "
          f"(phase 3 rebuilt per solve: {t_cold:.2f} s cold, "
          f"{t_warm:.2f} s warm)", flush=True)
    walls = []
    for solver in ("bicg", "bicr", "bicgstab", "bicrstab"):
        _, wall, _ = solve_checked(
            "reuse", N, an, b,
            f"-i {solver} -p jacobi -storage cst -scale 1 -tol 1e-10",
            matvec_kernels if solver in ("bicg", "bicr") else (),
            ("lane_shuffle",) + matvec_kernels, N_s)
        walls.append(wall)
    _, wall, _ = solve_checked(
        "reuse", C, a, b,
        "-i cg -p jacobi -storage cst -scale 1 -tol 1e-10",
        matvec_kernels, ("lane_shuffle",), C_s)
    walls.append(wall)
    # I+S forces -scale 1: the prebuilt grid is scaled through #1, and the
    # truncated-U arrays come from the scaled grid's host CSR
    _, wall, _ = solve_checked(
        "reuse", N, an, b, "-i bicgstab -p is -storage cst -tol 1e-10",
        matvec_kernels, ("lane_shuffle",), N_s)
    walls.append(wall)
    # the Krylov slice's nonsymmetric solvers: A-D exactly as often as the
    # solver's matvecs on A's grid (the initial and the true residual
    # included) and its Aᴴ products on the transpose grid imply
    xs = randn(n, torch.float64)
    per_a, per_at = launches_per(lambda: N.matvec(xs)), \
        launches_per(lambda: N.at.matvec(xs))
    t0 = time.perf_counter()
    for solver in KRYLOV[:-1]:
        def exact(r, solver=solver):
            mv, mvh, _ = krylov_counts(solver, r.iters)
            return {k: per_a[k] * (mv + 1) + per_at[k] * mvh
                    for k in matvec_kernels}
        _, wall, _ = solve_checked(
            "reuse", N, an, b,
            f"-i {solver} -p jacobi -storage cst -scale 1 -tol 1e-10",
            (), ("lane_shuffle",) + matvec_kernels, N_s, exact=exact)
        walls.append(wall)
    print(f"phase reuse: the {len(KRYLOV) - 1} solvers of the Krylov slice "
          f"with their n=2^17 oracles in {time.perf_counter() - t0:.2f} s; "
          f"one matvec launches {per_a} on A's grid, {per_at} on the "
          f"transpose grid", flush=True)
    print(f"phase reuse: per-solve wall {min(walls):.4f}-{max(walls):.4f} s "
          f"on the prebuilt CST, against {t_warm:.2f} s for phase 3's warm "
          f"solve that rebuilds it", flush=True)
    del N, N_s
    torch.cuda.empty_cache()

    # ---- 6. complex: COCG / COCR over a complex CST -------------------------
    stamp("phase 6")
    t0 = time.perf_counter()
    ac = system(n, k, args.seed, "csym")
    Z, _ = cst_pair(ac, transpose=False)
    rng = np.random.default_rng(args.seed + 1)
    bc = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    ac_s = system(ns, k, args.seed, "csym")
    Z_s = cst_pair(ac_s, transpose=False) + (
        rng.standard_normal(ns) + 1j * rng.standard_normal(ns),)
    print(f"phase complex: complex-symmetric system nnz={ac.nnz}, CST built "
          f"once in {time.perf_counter() - t0:.2f} s", flush=True)
    cpu = {}
    for solver, single in (("cocg", ""), ("cocr", ""), ("cocg", " -f single")):
        opts = f"-i {solver} -p jacobi -storage cst -tol 1e-10" + single
        # a complex vector takes the select (lane_shuffle) in place of
        # kernel A, then B, C and D on its real and imaginary planes.
        # -f single leaves complex128 as it is, so it is held against
        # the CPU run at double
        r, _, cpu[solver] = solve_checked(
            "complex", Z, ac, bc, opts,
            ("lane_shuffle",) + matvec_kernels[1:], (), Z_s, cpu.get(solver))
        if r.x.dtype != torch.complex128:
            fail(f"complex {opts}: x is {r.x.dtype}")
    zv = randn(n, torch.complex128)
    y_k, y_p = Z.matvec(zv), plain_matvec(Z, zv)
    err = ((y_k - y_p).abs().max() / y_p.abs().max()).item()
    ms_zk = cuda_ms(lambda: Z.matvec(zv))
    ms_zp = cuda_ms(lambda: plain_matvec(Z, zv))
    print(f"phase complex: complex128 CST matvec: kernels {ms_zk:.4f} ms "
          f"({ms_zk / ms_k:.2f}x the real f64 matvec's {ms_k:.4f} ms), "
          f"plain torch {ms_zp:.4f} ms; kernel vs plain rel err {err:.2e}",
          flush=True)
    if err > 1e-12:
        fail(f"complex CST matvec kernels vs plain: relative error "
             f"{err:.3e}")


    # ---- 7. dia kernels: E, F and G against their plain versions -----------
    stamp("phase 7")
    t0 = time.perf_counter()
    A96 = testmat.poisson3d27(96, 96, 96)          # CSR on the card
    D96 = lis_tpu_torch.convert_matrix(A96, "dia")
    n96, nnd = D96.nrows, len(D96.offsets)
    print(f"phase dia: poisson3d27 96^3: n={n96} nnz={A96.nnz} nnd={nnd} "
          f"max|off|={max(map(abs, D96.offsets))}, CSR and DIA built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    if D96.device.type != "cuda" or D96.off.dtype != torch.int64:
        fail(f"a DIA built with no device lives on {D96.device}")
    S96 = torch.sparse_csr_tensor(A96.ptr, A96.index, A96.value,
                                  size=A96.shape)      # the library's operand

    def dia_rtol(dtype):
        return 1e-13 if dtype in (torch.float64, torch.complex128) else 1e-5

    def dia_check(tag, D, x, timed_for=None):
        """E and F on D and x against their plain versions."""
        dt = torch.promote_types(D.value.dtype, x.dtype)
        nbytes = (D.value.numel() * D.value.element_size()
                  + 2 * D.nrows * x.element_size())
        flops = 2 * D.value.numel()
        for name, fn, plain in (
                ("dia_spmv", lambda: D.matvec(x),
                 lambda: diam._spmv_plain(D.value, D.offsets, x, D.ncols)),
                ("dia_spmvh", lambda: D.matvech(x),
                 lambda: diam._spmvh_plain(D.value, D.offsets, x, D.ncols))):
            timed = None
            if timed_for is not None:
                library = timed_for[name]
                timed = (fn, plain, library, nbytes, flops)
            check(name, dt, tag, fn(), plain(), False, timed,
                  rtol=dia_rtol(dt))

    for dtype in (torch.float64, torch.float32, torch.complex128):
        Dt = D96 if dtype == torch.float64 else dataclasses.replace(
            D96, value=D96.value.to(dtype))
        x = randn(n96, dtype)
        lib = None
        if dtype == torch.float64:
            # A is symmetric, so the same CSR serves the library's A^H x
            lib = {"dia_spmv": lambda: S96 @ x, "dia_spmvh": lambda: S96 @ x}
            want = S96 @ x
            err = ((D96.matvec(x) - want).abs().max()
                   / want.abs().max()).item()
            if err > 1e-13:
                fail(f"torch.sparse CSR @ x disagrees with dia_spmv: "
                     f"{err:.2e}")
        elif dtype == torch.float32:
            S32 = torch.sparse_csr_tensor(A96.ptr, A96.index,
                                          A96.value.to(dtype), size=A96.shape)
            lib = {"dia_spmv": lambda: S32 @ x, "dia_spmvh": lambda: S32 @ x}
        dia_check(f"96^3 nnd={nnd}", Dt, x, lib)
        if dtype == torch.complex128:
            ms_z = cuda_ms(lambda: Dt.matvec(x))
            print(f"phase dia: complex128 dia_spmv 96^3: {ms_z:.4f} ms",
                  flush=True)
    # real diagonals, complex vector: the result type is the vector's
    dia_check("96^3 f64 x complex128", D96, randn(n96, torch.complex128))
    x64 = randn(n96, torch.float64)
    ms_csr96 = cuda_ms(lambda: A96.matvec(x64))
    print(f"phase dia: the port's CSR gather matvec on the same operator: "
          f"{ms_csr96:.4f} ms", flush=True)
    nb_, offs_ = 1_000_003, (-600_000, -1001, -1, 0, 2, 997, 700_001)
    for dtype in (torch.float64, torch.complex128, torch.float32):
        val = randn(len(offs_) * nb_, dtype).view(len(offs_), nb_)
        cols = (torch.arange(nb_, device=dev)[None, :]
                + torch.tensor(offs_, device=dev)[:, None])
        val = val * ((cols >= 0) & (cols < nb_))
        B = diam.DIAMatrix.from_diagonals(
            val, offs_, (nb_, nb_), nnz=int(torch.count_nonzero(val)))
        dia_check(f"n={nb_} offsets={offs_}", B, randn(nb_, dtype))
    del val, cols, B, S96
    torch.cuda.empty_cache()

    def new_ws(like, nrm1=False):
        one = torch.ones((), dtype=like.dtype, device=dev)
        return v.KrylovScalars(like, 10_000, 0.0, one * 0.5, one, nrm1=nrm1,
                               running=-99, breakdown=2)

    def ws_copy(ws, like):
        w2 = new_ws(like, ws.nrm1)
        for dst, src in ((w2.sc, ws.sc), (w2.ic, ws.ic),
                         (w2.part, ws.part)):
            dst.copy_(src)
        return w2

    def same_bits(what, got, want):
        if not torch.equal(got, want):
            err = (got - want).abs().max().item()
            fail(f"fused CG step: {what} differs from its plain version "
                 f"(max abs {err:.3e})")

    for dtype in (torch.float64, torch.float32):
        tag = f"n={n96}"
        r, p, x, q, dinv = (randn(n96, dtype) for _ in range(5))
        dinv = dinv.abs() + 0.5
        eb = es(dtype)
        # G1: the sums, kernel partials against the plain total
        wk, wp = new_ws(r), new_ws(r)
        v.krylov_dot(r, dinv, r, wk, v.P_RHO)
        v._krylov_dot_plain(r, dinv, r, wp, v.P_RHO)
        check("krylov_dot", dtype, tag + " <r, dinv r>",
              wk.part[v.P_RHO].sum(), wp.part[v.P_RHO].sum(), False)
        v.krylov_dot(p, q, None, wk, v.P_PQ)
        v._krylov_dot_plain(p, q, None, wp, v.P_PQ)
        check("krylov_dot", dtype, tag + " <p, q>", wk.part[v.P_PQ].sum(),
              wp.part[v.P_PQ].sum(), False,
              (lambda: v.krylov_dot(p, q, None, wk, v.P_PQ),
               lambda: v._krylov_dot_plain(p, q, None, wp, v.P_PQ),
               lambda: torch.dot(p, q), 2 * n96 * eb, 2 * n96), queued=True)
        # G2 and G3 from one state (the plain sums): p, x, r bit for bit
        for mode, z, d in (("jacobi", None, dinv), ("none", None, None),
                           ("z", dinv * r, None)):
            w1, w2 = ws_copy(wp, r), ws_copy(wp, r)
            p1, p2 = p.clone(), p.clone()
            v.cg_direction(p1, r, z, d, w1)
            v._cg_direction_plain(p2, r, z, d, w2)
            same_bits(f"cg_direction {mode} {dtype}", p1, p2)
            same_bits("rho", w1.sc, w2.sc)
        for nrm1 in (False, True):
            wq = ws_copy(w2, r)
            wq.nrm1 = nrm1
            w1, w2_ = ws_copy(wq, r), ws_copy(wq, r)
            w1.nrm1 = w2_.nrm1 = nrm1
            x1, x2, r1, r2 = x.clone(), x.clone(), r.clone(), r.clone()
            v.cg_update(x1, r1, p, q, dinv, w1, next_rho=True)
            v._cg_update_plain(x2, r2, p, q, dinv, w2_, True)
            same_bits(f"cg_update x {dtype}", x1, x2)
            same_bits(f"cg_update r {dtype}", r1, r2)
            check("cg_update", dtype, tag + f" sums nrm1={nrm1}",
                  w1.part.sum(1), w2_.part.sum(1), False)
            if not nrm1:        # what the timed rows below are held to
                upd = (torch.cat([x1, r1, w1.part.sum(1)]),
                       torch.cat([x2, r2, w2_.part.sum(1)]))
            rh1 = torch.zeros(10_002, dtype=dtype, device=dev)
            rh2 = rh1.clone()
            w2_.part.copy_(w1.part)
            v.cg_finish(w1, rh1)
            v._cg_finish_plain(w2_, rh2)
            check("cg_finish", dtype, tag + f" nrm1={nrm1}",
                  torch.cat([w1.sc, rh1[:3]]), torch.cat([w2_.sc, rh2[:3]]),
                  False)
            if not nrm1:
                fin = (torch.cat([w1.sc, rh1[:3]]),
                       torch.cat([w2_.sc, rh2[:3]]))
            if not torch.equal(w1.ic, w2_.ic) or int(w1.it) != 2:
                fail(f"cg_finish: loop scalars {w1.ic.tolist()} vs "
                     f"{w2_.ic.tolist()}")
        # the breakdown freeze (p.q == 0), then a step after the end
        wb = ws_copy(wp, r)
        v.cg_direction(p.clone(), r, None, dinv, wb)
        zq = torch.zeros_like(q)
        v.krylov_dot(p, zq, None, wb, v.P_PQ)
        x1, r1 = x.clone(), r.clone()
        v.cg_update(x1, r1, p, zq, dinv, wb, next_rho=True)
        v.cg_finish(wb, rh1)
        if not (torch.equal(x1, x) and torch.equal(r1, r)
                and int(wb.flag) == 2 and int(wb.live) == 0
                and float(wb.nrm) == 1.0):
            fail(f"fused CG step: breakdown did not freeze the state "
                 f"(flag {int(wb.flag)}, live {int(wb.live)})")
        v.krylov_dot(p, q, None, wb, v.P_PQ)
        v.cg_update(x1, r1, p, q, dinv, wb, next_rho=True)
        v.cg_finish(wb, rh1)
        if not (torch.equal(x1, x) and int(wb.it) == 2):
            fail("fused CG step: a step after the loop ended changed x")
        print(f"phase dia: fused CG step {str(dtype)[6:]}: p, x, r bit-equal "
              f"to the plain versions; breakdown freezes; dead step is a "
              f"no-op", flush=True)
        # G2, G3, G4 timed in a live state (Jacobi folded, as the main
        # path); the error beside each time is kernel against plain version
        # from the comparisons above: p; x, r and the three sums; the
        # scalars and the history entry that cg_finish wrote
        wt, wpl = ws_copy(wp, r), ws_copy(wp, r)
        pt, xt, rt = p.clone(), x.clone(), r.clone()
        check("cg_direction", dtype, tag, p1, p2, True,
              (lambda: v.cg_direction(pt, r, None, dinv, wt),
               lambda: v._cg_direction_plain(pt, r, None, dinv, wpl),
               None, 4 * n96 * eb, 3 * n96), queued=True)
        check("cg_update", dtype, tag, upd[0], upd[1], False,
              (lambda: v.cg_update(xt, rt, p, q, dinv, wt, next_rho=True),
               lambda: v._cg_update_plain(xt, rt, p, q, dinv, wpl, True),
               None, 7 * n96 * eb, 9 * n96), queued=True)
        check("cg_finish", dtype, tag, fin[0], fin[1], False,
              (lambda: v.cg_finish(wt, rh1),
               lambda: v._cg_finish_plain(wpl, rh2),
               None, (wt.nb + 16) * eb, wt.nb), queued=True)
    del r, p, x, q, dinv, pt, xt, rt, p1, p2, x1, x2, r1, r2, rh1, rh2, upd
    torch.cuda.empty_cache()

    # ---- 8. main path: default routing, lsolve, DIA, the fused step --------
    stamp("phase 8")
    # (a) a MatrixMarket file through the lsolve command line
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "poisson2d_512.mtx")
        t0 = time.perf_counter()
        P2 = testmat.poisson2d(512, 512)
        lis_tpu_torch.write_matrix_market(path, P2)
        t_write = time.perf_counter() - t0
        argv = [path, "1", "-i", "cg", "-p", "jacobi", "-tol", "1e-8",
                "-maxiter", "10000"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc_ls, got, wall = counted(lambda: lsolve.main(argv))
        t0 = time.perf_counter()
        Afile = lis_tpu_torch.lis_input(path)[0]
        t_read = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    print(f"phase main: lsolve {' '.join(argv[1:])} on poisson2d 512x512 "
          f"(n={P2.nrows}, file written in {t_write:.2f} s, read and parsed "
          f"in {t_read:.2f} s): exit {rc_ls}, wall {wall:.2f} s, "
          f"{len(lines)} lines printed, last: {lines[-2:]}; launches {got}",
          flush=True)
    route = route_of(Afile, "-i cg -p jacobi")
    if rc_ls != 0 or route != "dia" or Afile.device.type != "cuda":
        fail(f"lsolve: exit {rc_ls}, route {route}, device {Afile.device}")
    if Afile.nnz != P2.nnz or not lines[-2].startswith("CG: number of"):
        fail(f"lsolve: nnz {Afile.nnz} vs {P2.nnz}; report {lines[-2:]}")
    it_ls = int(lines[-2].rsplit("=", 1)[1])
    S.it_ls = it_ls                 # phase 13h reads the file's count
    need_exact(got, {"dia_spmv": it_ls + 1, "krylov_dot": it_ls + 1,
                     "cg_direction": it_ls, "cg_update": it_ls,
                     "cg_finish": it_ls}, "lsolve")
    del P2, Afile

    # (b) 96^3 from CSR, default options
    dia_e = results["dia_spmv"]["ms"]

    def report_main(tag, res, wall, got, n, nnz, nnd, e_ms, esize=8):
        per = 1e3 * res.itime / max(res.iters, 1)
        csr_eq = (nnz * 12 + 2 * n * 8) / e_ms / 1e6
        true = (nnd * n + 2 * n) * esize / e_ms / 1e6
        print(f"phase main: {tag}: status {res.status} iters {res.iters} "
              f"true_resid {res.true_resid:.3e} wall {wall:.3f} s (itime "
              f"{res.itime:.4f} s, {per:.4f} ms/iter; dia_spmv "
              f"{e_ms:.4f} ms = {100 * e_ms / per:.1f} % of it, "
              f"{csr_eq:.1f} csr-equivalent GB/s, {true:.1f} GB/s of true "
              f"traffic); launches {got}", flush=True)

    b96 = np.ones(n96)
    opts = "-i cg -p jacobi -tol 1e-8"
    A96 = A96.to(dev)       # a new matrix object: no route is cached on it
    r96, got, wall = counted(lambda: lis_tpu_torch.solve(A96, b96,
                                                         options=opts))
    report_main("96^3 CSR input, cold (routing and DIA build included)", r96,
                wall, got, n96, A96.nnz, nnd, dia_e)
    if route_of(A96, opts) != "dia":
        fail(f"96^3: routed to {route_of(A96, opts)}")
    if r96.status != lis_tpu_torch.LIS_SUCCESS or not r96.true_resid <= 1e-7:
        fail(f"96^3: status {r96.status} true residual {r96.true_resid:.3e}")
    need_exact(got, {"dia_spmv": r96.iters + 1, "dia_spmvh": 0,
                     "krylov_dot": r96.iters + 1, "cg_direction": r96.iters,
                     "cg_update": r96.iters, "cg_finish": r96.iters},
               "96^3 cg")
    r96w, got, wall = counted(lambda: lis_tpu_torch.solve(A96, b96,
                                                          options=opts))
    report_main("96^3 warm (route cached)", r96w, wall, got, n96, A96.nnz,
                nnd, dia_e)
    t0 = time.perf_counter()
    rc96 = lis_tpu_torch.solve(D96.to("cpu"), b96, options=opts)
    print(f"phase main: 96^3 on the CPU, plain versions: iters {rc96.iters} "
          f"status {rc96.status} in {time.perf_counter() - t0:.2f} s",
          flush=True)
    if abs(rc96.iters - r96.iters) > 1 or rc96.status != r96.status:
        fail(f"96^3: cuda iters {r96.iters} vs cpu {rc96.iters}")
    err = (r96.x.cpu() - rc96.x).abs().max().item()
    if err > 1e-6 * rc96.x.abs().max().item():
        fail(f"96^3: x differs from the CPU plain path by {err:.3e}")
    rs, got, wall = counted(lambda: lis_tpu_torch.solve(
        A96, b96, options=opts + " -f single"))
    report_main("96^3 -f single", rs, wall, got, n96, A96.nnz, nnd,
                results32["dia_spmv"]["ms"], esize=4)
    t0 = time.perf_counter()
    rsc = lis_tpu_torch.solve(D96.to("cpu"), b96, options=opts + " -f single")
    print(f"phase main: 96^3 -f single on the CPU, plain versions: iters "
          f"{rsc.iters} true_resid {rsc.true_resid:.3e} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    # float32 cannot reach 1e-4 here: from -tol 1e-4 to 1e-8 the true
    # residual of this system stops at about 1.5e-4 (rounding times the
    # condition number), on the CPU as on the card.  So the card is held
    # to twice that floor, and to twice the CPU's own
    if not (torch.isfinite(rs.x).all() and rs.status == rsc.status == 0
            and rs.true_resid <= 3e-4
            and rs.true_resid <= 2 * rsc.true_resid):
        fail(f"96^3 -f single: true residual {rs.true_resid:.3e} (cpu "
             f"{rsc.true_resid:.3e}), status {rs.status}")
    need_exact(got, {"dia_spmv": rs.iters + 1, "cg_update": rs.iters},
               "96^3 -f single")
    rb, got, wall = counted(lambda: lis_tpu_torch.solve(
        A96, b96, options="-i bicg -p jacobi -tol 1e-8"))
    report_main("96^3 bicg (E and F per iteration, torch-ops step)", rb, wall,
                got, n96, A96.nnz, nnd, dia_e)
    if rb.status != lis_tpu_torch.LIS_SUCCESS or not rb.true_resid <= 1e-7:
        fail(f"96^3 bicg: status {rb.status} resid {rb.true_resid:.3e}")
    need_launches(got, ("dia_spmv", "dia_spmvh"), rb.iters, "96^3 bicg")

    from lis_tpu_torch.precon.jacobi import create_jacobi
    from lis_tpu_torch.solvers import cg as cgm
    from lis_tpu_torch.solvers.base import (SolverSpec, init_residual,
                                            new_rhistory)

    def step_ms(step, D, every=1, reps=3):
        """CG + Jacobi to -tol 1e-8 on D, b = ones, through one of the two
        steps of solvers/cg.py as ``cg`` calls them, the host reading the
        loop condition every ``every`` steps: (iterations, [wall ms per
        iteration of ``reps`` solves after a warm-up])."""
        bv = torch.ones(D.nrows, dtype=torch.float64, device=dev)
        Mj = create_jacobi(D, None)
        spec = SolverSpec(solver="cg", tol=1e-8, maxiter=2000,
                          check_every=every)
        ms = []
        for _ in range(reps + 1):
            x0 = torch.zeros_like(bv)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r0, bnrm_inv, tol_eff, nrm0 = init_residual(D, bv, x0, spec)
            rh = new_rhistory(spec, nrm0, bv.dtype)
            out = step(D, bv, x0, Mj, spec, r0, bnrm_inv, tol_eff, nrm0, rh)
            iters = int(out.iters)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0) / iters)
        return iters, [round(m, 4) for m in ms[1:]]

    def report_steps(tag, D, want_iters):
        rows = [("fused", cgm.cg_fused, 1), ("torch operations",
                cgm.cg_torch_ops, 1), ("fused, condition read every 16 "
                "steps", cgm.cg_fused, 16)]
        text = []
        for name, step, every in rows:
            iters, ms = step_ms(step, D, every)
            if abs(iters - want_iters) > 1:
                fail(f"{tag} {name} step: iters {iters} vs {want_iters}")
            text.append(f"{name} {ms} ({iters} it)")
        print(f"phase main: {tag} CG + Jacobi on the DIA, wall ms/iter of 3 "
              f"solves: " + "; ".join(text), flush=True)

    report_steps("96^3", D96, r96.iters)
    del A96, D96, r96, r96w, rs, rb
    torch.cuda.empty_cache()

    # (c) 192^3 built directly in DIA form on the card
    t0 = time.perf_counter()
    D192 = testmat.poisson3d27_dia(192, 192, 192)
    torch.cuda.synchronize()
    n192 = D192.nrows
    print(f"phase main: poisson3d27_dia 192^3: n={n192} nnz={D192.nnz} "
          f"diagonals {D192.value.numel() * 8 / 1e9:.2f} GB on "
          f"{D192.device}, built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    x192 = randn(n192, torch.float64)
    e192 = cuda_ms(lambda: D192.matvec(x192), reps=10)
    b_ms, _ = bound_ms((nnd + 2) * n192 * 8, 2 * nnd * n192, torch.float64)
    err = ((D192.matvec(x192) - diam._spmv_plain(
        D192.value, D192.offsets, x192, n192)).abs().max()
        / x192.abs().max()).item()
    print(f"phase main: dia_spmv 192^3: {e192:.4f} ms, bound {b_ms:.4f} ms "
          f"({100 * b_ms / e192:.0f} %); against its plain version "
          f"{err:.2e}", flush=True)
    if err > 1e-11:
        fail(f"dia_spmv 192^3 disagrees with its plain version: {err:.2e}")
    b192 = torch.ones(n192, dtype=torch.float64, device=dev)
    r192, got, wall = counted(lambda: lis_tpu_torch.solve(D192, b192,
                                                          options=opts))
    report_main("192^3 DIA input", r192, wall, got, n192, D192.nnz, nnd, e192)
    if r192.status != lis_tpu_torch.LIS_SUCCESS or not r192.true_resid <= 1e-7:
        fail(f"192^3: status {r192.status} resid {r192.true_resid:.3e}")
    # the initial and the true residual are both on the DIA here
    need_exact(got, {"dia_spmv": r192.iters + 2, "krylov_dot": r192.iters + 1,
                     "cg_direction": r192.iters, "cg_update": r192.iters,
                     "cg_finish": r192.iters}, "192^3 cg")

    def plain_cg(D, b, tol, maxiter):
        """CG + Jacobi over the plain versions of E and G, on D's device:
        the oracle of the 192^3 solve (x0 = 0, nrm2_r)."""
        def mv(u):
            return diam._spmv_plain(D.value, D.offsets, u, D.ncols)
        d = D.get_diagonal()
        dinv = 1.0 / d
        x, r, p = torch.zeros_like(b), b.clone(), torch.zeros_like(b)
        nrm0 = torch.sqrt(torch.dot(r, r))
        ws = v.KrylovScalars(b, maxiter, tol, 1.0 / nrm0,
                             torch.ones_like(nrm0), nrm1=False, running=-99,
                             breakdown=2)
        rh = torch.zeros(maxiter + 2, dtype=b.dtype, device=b.device)
        v._krylov_dot_plain(r, dinv, r, ws, v.P_RHO)
        while int(ws.live):
            v._cg_direction_plain(p, r, None, dinv, ws)
            q = mv(p)
            v._krylov_dot_plain(p, q, None, ws, v.P_PQ)
            v._cg_update_plain(x, r, p, q, dinv, ws, True)
            v._cg_finish_plain(ws, rh)
        return x, int(ws.it) - 1

    before = {name: f.launches for name, f in kernels.items()}
    t0 = time.perf_counter()
    xo, it_o = plain_cg(D192, b192, 1e-8, 1000)
    torch.cuda.synchronize()
    t_o = time.perf_counter() - t0
    if before != {name: f.launches for name, f in kernels.items()}:
        fail("the plain-version oracle launched a kernel")
    err = ((r192.x - xo).abs().max() / xo.abs().max()).item()
    print(f"phase main: 192^3 oracle over the plain versions on the card: "
          f"iters {it_o} in {t_o:.2f} s ({1e3 * t_o / it_o:.3f} ms/iter); x "
          f"differs by {err:.2e} relative", flush=True)
    if abs(it_o - r192.iters) > 1 or err > 1e-6:
        fail(f"192^3: iters {r192.iters} vs the oracle's {it_o}, x {err:.2e}")
    report_steps("192^3", D192, r192.iters)
    del D192, x192, b192, r192, xo
    torch.cuda.empty_cache()

    # (d) the locality-free matrix of phase 3 with no -storage
    opts = "-i cg -p jacobi -tol 1e-10"
    rr, got, wall_cst = counted(lambda: lis_tpu_torch.solve(A, b,
                                                            options=opts))
    route = route_of(A, opts)
    rcsr, got_csr, wall_csr = counted(lambda: lis_tpu_torch.solve(
        A, b, options=opts + " -auto_storage false"))
    print(f"phase main: locality-free n={n}, default routing: route {route}, "
          f"status {rr.status} iters {rr.iters} true_resid "
          f"{rr.true_resid:.3e}, wall {wall_cst:.2f} s (itime "
          f"{rr.itime:.4f} s); the same with -auto_storage false (CSR): "
          f"iters {rcsr.iters} wall {wall_csr:.3f} s (itime "
          f"{rcsr.itime:.4f} s); launches {got}", flush=True)
    if route != "cst" or rr.status != lis_tpu_torch.LIS_SUCCESS \
            or not rr.true_resid <= 1e-9 or abs(rr.iters - it_cst) > 1 \
            or abs(rr.iters - rcsr.iters) > 1:
        fail(f"routed locality-free solve: route {route} status {rr.status} "
             f"iters {rr.iters} (phase 3's -storage cst {it_cst}, CSR "
             f"{rcsr.iters}) resid {rr.true_resid:.3e}")
    if lis_tpu_torch.auto_storage(A, need_at=False).at is not None:
        fail("cg routed to a CST with a transpose grid")
    need_launches(got, matvec_kernels, rr.iters, "routed cst")
    need_exact(got, {"cg_update": rr.iters}, "routed cst")
    need_exact(got_csr, {"cg_update": rcsr.iters, "cst_front": 0},
               "-auto_storage false")

    # (e) a matrix that the router sends to CSS, its last format
    del A, A_cpu
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    aw = windowed(n, 2000, args.seed)
    csr = (aw.indptr, aw.indices, aw.data, aw.shape)
    Aw = lis_tpu_torch.CSRMatrix.from_csr_arrays(*csr)
    Aw_cpu = lis_tpu_torch.CSRMatrix.from_csr_arrays(*csr, device="cpu")
    print(f"phase main: windowed nonsymmetric n={n} nnz={aw.nnz} built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for opts in ("-i bicgstab -p jacobi -tol 1e-10",
                 "-i bicg -p jacobi -tol 1e-10",
                 "-i bicg -p jacobi -tol 1e-10 -scale 1"):
        rw, got, wall = counted(lambda: lis_tpu_torch.solve(Aw, b,
                                                            options=opts))
        route = route_of(Aw, opts)
        rwc = lis_tpu_torch.solve(Aw_cpu, b,
                                  options=opts + " -auto_storage false")
        xw = rw.x.cpu().numpy()
        sres = np.linalg.norm(aw @ xw - b) / np.linalg.norm(b)
        print(f"phase main: windowed, {opts}: route {route}, status "
              f"{rw.status} iters {rw.iters} (CSR on the CPU {rwc.iters}) "
              f"true_resid {rw.true_resid:.3e} (scipy {sres:.3e}), wall "
              f"{wall:.2f} s (itime {rw.itime:.4f} s)", flush=True)
        if route != "css" or rw.status != lis_tpu_torch.LIS_SUCCESS \
                or not rw.true_resid <= 1e-9 or not sres <= 1e-9 \
                or abs(rw.iters - rwc.iters) > 1:
            fail(f"routed css solve ({opts}): route {route} status "
                 f"{rw.status} iters {rw.iters} (cpu {rwc.iters}) resid "
                 f"{rw.true_resid:.3e} / {sres:.3e}")
    Sw = lis_tpu_torch.auto_storage(Aw)      # the cached route
    xw = randn(n, torch.float64)
    xh = xw.cpu().numpy()
    for name, got, want in (("matvec", Sw.matvec(xw), aw @ xh),
                            ("matvech", Sw.matvech(xw), aw.T @ xh),
                            ("matvech by the scatter", dataclasses.replace(
                                Sw, at=None).matvech(xw), aw.T @ xh),
                            ("diagonal", Sw.get_diagonal(), aw.diagonal())):
        err = np.abs(got.cpu().numpy() - want).max() / np.abs(want).max()
        print(f"phase main: css {name} on the card against scipy: "
              f"{err:.2e} relative", flush=True)
        if not err <= 1e-12:
            fail(f"css {name} on the card disagrees with scipy")
    print(f"phase main: css matvec {cuda_ms(lambda: Sw.matvec(xw)):.4f} ms "
          f"(torch operations, blowup {Sw.fill_blowup:.2f}); the CSR gather "
          f"matvec on the same matrix {cuda_ms(lambda: Aw.matvec(xw)):.4f} "
          f"ms", flush=True)

    # ---- 9. preconditioned: H, I, K and the hpcg configuration -------------
    stamp("phase 9")
    phase_preconditioned(S)
    # ---- 10. the Krylov slice's twelve solvers on DIA ----------------------
    stamp("phase 10")
    phase_krylov(S)
    # ---- 11. the remaining preconditioners: SA-AMG (J, L) and the rest ----
    stamp("phase 11")
    phase_precon_more(S)
    # ---- 12. the precision modes: kernels M-P and the _quad twins ---------
    stamp("phase 12")
    phase_quad(S)
    # ---- 13. the scalar formats, -reorder rcm, -use_at and the I/O ------
    stamp("phase 13")
    phase_formats(S)
    report_results(S, smi_line, total)

def phase_preconditioned(S):
    """Phase 9: kernels H, I and K against their plain versions, then the
    hpcg configuration and the level-scheduled path (see the docstring)."""
    import torch
    import lis_tpu_torch
    from lis_tpu_torch.cli import hpcg
    from lis_tpu_torch.matrix import dia as diam
    from lis_tpu_torch.ops import trisolve as tsm
    from lis_tpu_torch.precon import ads as pads, ilu as pilu, ssor as pssor
    from lis_tpu_torch.runtime.options import SolverOptions
    from lis_tpu_torch.utils import testmat
    import scipy.sparse as sp
    from torch.utils._python_dispatch import TorchDispatchMode

    dev, check, randn, es = S.dev, S.check, S.randn, S.es
    g96, g192, g64 = S.grids

    def tag(msg):
        print(f"phase precon: {msg}", flush=True)

    # ---- (a) H, I and K on the 96^3 operator's triangles and plans --------
    t0 = time.perf_counter()
    P = testmat.poisson3d27_dia(g96, g96, g96)
    n = P.nrows
    L, U, d = pssor._split_dia(P)
    if L.value.data_ptr() != P.value.data_ptr():
        fail("the strict-lower triangle of a sorted DIA is not a view")
    p_h, i_h, v_h = P.to_csr_arrays()
    a_h = sp.csr_matrix((v_h, i_h, p_h), shape=(n, n))
    low_h = sp.tril(a_h, -1).tocsr()
    up_t = sp.triu(a_h, 1).T.tocsr()            # the CSR of Uᴴ (real)
    for m in (low_h, up_t):
        m.sort_indices()
    tag(f"poisson3d27_dia 96^3: n={n}, triangles of {len(L.offsets)} and "
        f"{len(U.offsets)} diagonals, host CSR of the triangles in "
        f"{time.perf_counter() - t0:.2f} s")

    def sparse_csr(m, dtype):
        return torch.sparse_csr_tensor(
            torch.from_numpy(m.indptr.astype(np.int64)).to(dev),
            torch.from_numpy(m.indices.astype(np.int64)).to(dev),
            torch.from_numpy(m.data).to(dev, dtype), size=m.shape,
            check_invariants=False)

    rtol = {torch.float64: 1e-13, torch.float32: 1e-5,
            torch.complex128: 1e-13}
    for dtype in (torch.float64, torch.float32, torch.complex128):
        if dtype.is_complex:
            # complex diagonals: a random phase on every entry
            ph = torch.exp(1j * randn(L.value.numel() + U.value.numel(),
                                      torch.float64))
            Lt = dataclasses.replace(L, value=(L.value * ph[:L.value.numel()]
                                               .view(L.value.shape)))
            Ut = dataclasses.replace(U, value=(U.value * ph[L.value.numel():]
                                               .view(U.value.shape)))
        else:
            Lt = dataclasses.replace(L, value=L.value.to(dtype))
            Ut = dataclasses.replace(U, value=U.value.to(dtype))
        r, y, w, rs = (randn(n, dtype) for _ in range(4))
        eb = es(dtype)
        nnd = Lt.value.shape[0]
        nbytes = (nnd + 4) * n * eb        # T, rhs, y, w in; out
        flops = (2 * nnd + 2) * n
        lib_h = lib_i = None
        if not dtype.is_complex:
            Lcsr, Uhcsr = sparse_csr(low_h, dtype), sparse_csr(up_t, dtype)
            lib_h, lib_i = (lambda: Lcsr @ y), (lambda: Uhcsr @ y)
        for name, fn, trans, T, kw in (
                ("dia_relax", diam.dia_relax, False, Lt, dict(w=w)),
                ("dia_relaxh", diam.dia_relaxh, True, Ut, dict(s=w))):
            def plain(T=T, kw=kw, trans=trans):
                return diam._relax_plain(T.value, T.offsets, r, y,
                                         kw.get("s"), kw.get("w"), None,
                                         False, trans)
            check(name, dtype, f"96^3 nnd={nnd}", fn(T, r, y, **kw), plain(),
                  False, None if dtype.is_complex else (
                      lambda T=T, kw=kw, fn=fn: fn(T, r, y, **kw), plain,
                      lib_h if name == "dia_relax" else lib_i, nbytes, flops),
                  rtol=rtol[dtype])
            # the start vector in place and the rhs scale (the backward
            # series of SSOR), and the start alone
            check(name, dtype, f"96^3 start rs",
                  fn(T, r, w=w, rs=rs, start=True),
                  diam._relax_plain(T.value, T.offsets, r, None, None, w, rs,
                                    True, trans), False, rtol=rtol[dtype])
            check(name, dtype, f"96^3 no term", fn(T, r, w=w),
                  r * w, dtype != torch.complex128, rtol=rtol[dtype])
        del Lt, Ut
    # K: the GS plan of the 96^3 operator, (D + L) x = b
    t0 = time.perf_counter()
    dg = a_h.diagonal()
    plan = tsm.make_plan(low_h.indptr, low_h.indices, low_h.data, 1.0 / dg,
                         lower=True, device=dev)
    torch.cuda.synchronize()
    nlev, max_rows = plan.rows.shape
    max_nnz = plan.cols.shape[2]

    def plan_mb(pl, names):
        return sum(getattr(pl, f).numel() * getattr(pl, f).element_size()
                   for f in names) / 2**20
    padded_mb = plan_mb(plan, ("rows", "cols", "vals", "dinv"))
    sliced_mb = plan_mb(plan, ("srows", "sbase", "scols", "svals", "sdinv"))
    tag(f"level plan of (D + L) at 96^3: nlev {nlev}, max_rows {max_rows}, "
        f"max_nnz {max_nnz}, {plan.nunits} units of 32, built in "
        f"{time.perf_counter() - t0:.2f} s; device bytes f64: padded "
        f"{padded_mb:.1f} MiB + sliced {sliced_mb:.1f} MiB")
    rng_k = np.random.default_rng(S.seed)
    full_h = (low_h + sp.diags(dg)).tocsr()
    full_h.sort_indices()
    for dtype in (torch.float64, torch.float32, torch.complex128):
        if dtype.is_complex:
            # complex values: a random phase on every entry
            ph = np.exp(1j * rng_k.standard_normal(low_h.nnz))
            pl = tsm.make_plan(low_h.indptr, low_h.indices, low_h.data * ph,
                               (1.0 / dg).astype(np.complex128), lower=True,
                               device=dev)
        else:
            pl = plan.to(dtype=dtype)
        b = randn(n, dtype)
        eb = es(dtype)
        # the bound counts the unpadded triangle (row and column indices,
        # values, b, dinv and x once)
        nbytes = n * 4 + low_h.nnz * (4 + eb) + 3 * n * eb
        flops = 2 * low_h.nnz + 2 * n
        lib = None
        if not dtype.is_complex:
            Acsr = sparse_csr(full_h, dtype)
            bcol = b.view(-1, 1)
            try:
                xl = torch.triangular_solve(bcol, Acsr, upper=False).solution
                err = ((xl.view(-1) - tsm.trisolve(pl, b)).abs().max()
                       / xl.abs().max()).item()
                tag(f"torch.triangular_solve (sparse CSR) {str(dtype)[6:]}: "
                    f"against K {err:.2e}")
                lib = lambda: torch.triangular_solve(bcol, Acsr, upper=False)
            except (RuntimeError, NotImplementedError, TypeError,
                    ValueError) as e:
                tag(f"no library call for K at {str(dtype)[6:]}: "
                    f"torch.triangular_solve refuses a sparse CSR "
                    f"({str(e).splitlines()[0][:120]})")
        check("trisolve", dtype, f"96^3 nlev={nlev}", tsm.trisolve(pl, b),
              tsm._trisolve_plain(pl, b), False,
              None if dtype.is_complex else (
                  lambda: tsm.trisolve(pl, b),
                  lambda: tsm._trisolve_plain(pl, b), lib, nbytes, flops),
              rtol=rtol[dtype])
        if not dtype.is_complex:
            rec = (S.results if dtype == torch.float64 else S.results32)[
                "trisolve"]
            tag(f"K {str(dtype)[6:]}: {rec['ms']:.4f} ms = "
                f"{1e3 * rec['ms'] / nlev:.3f} us per level over nlev "
                f"{nlev}; bound of the unpadded triangle "
                f"{rec['bound_ms']:.4f} ms ({100 * rec['bound_ms'] / rec['ms']:.2f} "
                f"% of it)")
    del plan, pl, Acsr, full_h

    def k_case(what, pl, b, rs=None, dtype=torch.float64):
        """K against its plain version on the card, NaN and Inf where the
        plain version has them and rtol on the finite entries."""
        got = tsm.trisolve(pl, b, rs)
        want = tsm._trisolve_plain(pl, b, rs)
        torch.cuda.synchronize()
        if not (torch.equal(got.isnan(), want.isnan())
                and torch.equal(got.isinf(), want.isinf())
                and torch.equal(got[got.isinf()], want[want.isinf()])):
            fail(f"trisolve {what}: NaN/Inf differ from the plain version")
        fin = torch.isfinite(want)
        check("trisolve", dtype, what, got[fin], want[fin], False,
              rtol=rtol[dtype])
        return got

    # the upper plan of the 96^3 operator (SSOR's backward solve), plain
    # and with the rs fold; NaN and Inf in b on the lower plan
    up_h = sp.triu(a_h, 1).tocsr()
    up_h.sort_indices()
    plan_u = tsm.make_plan(up_h.indptr, up_h.indices, up_h.data, 1.0 / dg,
                           lower=False, device=dev)
    b = randn(n, torch.float64)
    k_case(f"96^3 upper nlev={plan_u.nlev}", plan_u, b)
    k_case("96^3 upper, rs fold", plan_u, b, randn(n, torch.float64))
    del plan_u, up_h
    plan = tsm.make_plan(low_h.indptr, low_h.indices, low_h.data, 1.0 / dg,
                         lower=True, device=dev)
    bad = b.clone()
    bad[torch.tensor([7, n // 3, n - 5], device=dev)] = float("nan")
    bad[torch.tensor([11, n // 2], device=dev)] = float("inf")
    bad[n - 100] = -float("inf")
    got = k_case("96^3 b with NaN and Inf", plan, bad)
    if not torch.isfinite(got[:7]).all():
        fail("trisolve: rows before the first NaN are not finite")
    del plan, bad
    # the ILU(1) factors of poisson3d27 32^3: rows longer than 16 entries
    A32 = testmat.poisson3d27(32, 32, 32)
    M1 = pilu.create_iluk(A32, SolverOptions.from_string("-ilu_fill 1"))
    r32 = randn(A32.nrows, torch.float64)
    for side in ("lower", "upper"):
        pl = getattr(M1, side)
        wmax = int(((pl.sbase[1:] - pl.sbase[:-1]) // 32).max())
        for dtype in (torch.float64, torch.float32):
            k_case(f"ILU(1) 32^3 {side} nlev={pl.nlev} longest row {wmax}",
                   pl.to(dtype=dtype), r32.to(dtype), dtype=dtype)
    del A32, M1
    # one level per row (a bidiagonal), and one level (no triangle)
    nb = 20000
    hb = sp.diags(np.linspace(-0.9, 0.9, nb - 1), -1, shape=(nb, nb)).tocsr()
    pl = tsm.make_plan(hb.indptr, hb.indices, hb.data, np.full(nb, 0.5),
                       device=dev)
    k_case(f"bidiagonal nlev={pl.nlev}", pl, randn(nb, torch.float64))
    pl = tsm.make_plan(np.zeros(n + 1, np.int32), np.zeros(0, np.int32),
                       np.zeros(0), 1.0 / dg, device=dev)
    k_case(f"diagonal nlev={pl.nlev}", pl, b)
    del pl, P, L, U, a_h, low_h, up_t
    torch.cuda.empty_cache()

    # ---- helpers for the solves -------------------------------------------
    orig_solve = lis_tpu_torch.solve
    seen = []

    def recording(*a, **k):
        res = orig_solve(*a, **k)
        seen.append((a[0], k.get("options"), res))
        return res

    def run_hpcg(argv, device=None):
        """hpcg.main(argv) with its printout captured; also the operator,
        the options and the SolveResult of its solve."""
        out = io.StringIO()
        seen.clear()
        lis_tpu_torch.solve = recording
        try:
            with contextlib.redirect_stdout(out):
                rc = hpcg.main(argv, device=device)
        finally:
            lis_tpu_torch.solve = orig_solve
        A, opts, res = seen[-1]
        return rc, A, opts, res, out.getvalue()

    def shares(tag_, res, wall, got, M, Aop):
        """ms/iter of a solve beside one psolve's and one matvec's time on
        the card (each enqueued by the host, as in the solve)."""
        per = 1e3 * res.itime / max(res.iters, 1)
        rv = randn(Aop.nrows, torch.float64)
        ps = cuda_ms(lambda: M.psolve(rv), reps=10)
        mv = cuda_ms(lambda: Aop.matvec(rv), reps=10)
        tag(f"{tag_}: status {res.status} iters {res.iters} true_resid "
            f"{res.true_resid:.3e} wall {wall:.3f} s (ptime {res.ptime:.3f} "
            f"s, itime {res.itime:.4f} s, {per:.4f} ms/iter; psolve "
            f"{ps:.4f} ms = {100 * ps / per:.1f} %, matvec {mv:.4f} ms = "
            f"{100 * mv / per:.1f} %); launches {got}")
        return per

    def same_count(what, got_iters, want_iters):
        if abs(got_iters - want_iters) > 1:
            fail(f"{what}: cuda iters {got_iters} vs cpu {want_iters}")

    def hpcg_precon(Aop, opts):
        o = SolverOptions.from_string(opts)
        return pads.wrap_additive_schwarz(Aop, pssor.create_ssor(Aop, o), o)

    # ---- (b) the hpcg default at 96^3: CSR -> router -> DIA ---------------
    S.stamp("phase 9b")
    for run in ("first run", "second run"):
        (rc, A, o, r, text), got, wall = S.counted(
            lambda: run_hpcg([str(g96)] * 3))
        route = S.route_of(A, o)
        Dr = lis_tpu_torch.auto_storage(A)
        it = r.iters
        shares(f"hpcg 96^3 default (-i cg -p ssor -adds true), {run} (wall: "
               f"CSR build, routing and solve)", r, wall, got,
               hpcg_precon(Dr, o), Dr)
        if rc != 0 or route != "dia" or r.status != 0 \
                or not r.true_resid <= 1e-7:
            fail(f"hpcg 96^3: exit {rc}, route {route}, status {r.status}, "
                 f"true residual {r.true_resid:.3e}")
        # every sweep launched H: 9 per psolve (SSOR: 2 + 2; ADDS: 2 SSOR
        # and the residual), one psolve per iteration; nothing took K or I
        S.need_exact(got, {"dia_relax": 9 * it, "dia_relaxh": 0,
                           "trisolve": 0, "dia_spmv": it + 1,
                           "krylov_dot": 2 * it, "cg_direction": it,
                           "cg_update": it, "cg_finish": it}, "hpcg 96^3")
    tag(f"hpcg 96^3 report: {text.splitlines()[:4]}")
    t0 = time.perf_counter()
    rc_c, _, _, r_c, _ = run_hpcg([str(g96)] * 3, device="cpu")
    tag(f"hpcg 96^3 on the CPU, plain versions: exit {rc_c} iters "
        f"{r_c.iters} in {time.perf_counter() - t0:.2f} s")
    same_count("hpcg 96^3", it, r_c.iters)
    err = (r.x.cpu() - r_c.x).abs().max().item()
    if err > 1e-6 * r_c.x.abs().max().item():
        fail(f"hpcg 96^3: x differs from the CPU plain path by {err:.3e}")
    del A, Dr, r, r_c
    torch.cuda.empty_cache()

    # ---- (c) the hpcg default at 192^3 (built in DIA on the card) ---------
    S.stamp("phase 9c")
    (rc, A, o, r, text), got, wall = S.counted(
        lambda: run_hpcg([str(g192)] * 3))
    it = r.iters
    shares("hpcg 192^3 default", r, wall, got, hpcg_precon(A, o), A)
    if rc != 0 or A.format_name != "dia" or r.status != 0 \
            or not r.true_resid <= 1e-7:
        fail(f"hpcg 192^3: exit {rc}, format {A.format_name}, status "
             f"{r.status}, true residual {r.true_resid:.3e}")
    # b = A·ones, the initial and the true residual all on the DIA here
    S.need_exact(got, {"dia_relax": 9 * it, "dia_spmv": it + 3,
                       "trisolve": 0, "cg_update": it}, "hpcg 192^3")

    def plain_hpcg(D, b, tol, maxiter):
        """CG + SSOR + additive Schwarz over the plain versions of E, G
        and H on D's device: the oracle of the 192^3 solve."""
        ssor, sweep = plain_ssor(D)

        def psolve(q):
            xq = ssor(q)
            return xq + ssor(sweep(D, q, xq))
        return plain_pcg(D, b, tol, maxiter, psolve)

    b192 = diam._spmv_plain(A.value, A.offsets, torch.ones(
        A.nrows, dtype=torch.float64, device=dev), A.ncols)
    before = {name: f.launches for name, f in S.kernels.items()}
    t0 = time.perf_counter()
    xo, it_o = plain_hpcg(A, b192, 1e-12, 1000)
    torch.cuda.synchronize()
    t_o = time.perf_counter() - t0
    if before != {name: f.launches for name, f in S.kernels.items()}:
        fail("the plain-version oracle launched a kernel")
    err = ((r.x - xo).abs().max() / xo.abs().max()).item()
    tag(f"hpcg 192^3 oracle over the plain versions on the card: iters "
        f"{it_o} in {t_o:.2f} s ({1e3 * t_o / max(it_o, 1):.3f} ms/iter); x "
        f"differs by {err:.2e} relative")
    if abs(it_o - it) > 1 or err > 1e-6:
        fail(f"hpcg 192^3: iters {it} vs the oracle's {it_o}, x {err:.2e}")
    del A, r, xo, b192
    torch.cuda.empty_cache()

    # ---- (d) CG + ILU(0) at 96^3, routed to DIA ---------------------------
    S.stamp("phase 9d")
    t0 = time.perf_counter()
    A96 = testmat.poisson3d27(g96, g96, g96)
    A96c = A96.to("cpu")
    b96 = np.ones(A96.nrows)
    tag(f"poisson3d27 96^3 CSR built in {time.perf_counter() - t0:.2f} s")
    opts = "-i cg -p ilu"
    r, got, wall = S.counted(lambda: lis_tpu_torch.solve(A96, b96,
                                                         options=opts))
    Dr = lis_tpu_torch.auto_storage(A96)
    it = r.iters
    t0 = time.perf_counter()
    Milu = pilu.create_iluk(Dr, SolverOptions.from_string(opts))
    torch.cuda.synchronize()
    tag(f"ILU(0) of the 96^3 DIA (native ilu0_dia on a host copy, upload): "
        f"{time.perf_counter() - t0:.3f} s; {type(Milu).__name__}")
    shares("cg -p ilu 96^3", r, wall, got, Milu, Dr)
    if S.route_of(A96, opts) != "dia" or r.status != 0 \
            or not r.true_resid <= 1e-7:
        fail(f"cg -p ilu 96^3: status {r.status} resid {r.true_resid:.3e}")
    S.need_exact(got, {"dia_relax": 4 * it, "dia_spmv": it + 1,
                       "trisolve": 0}, "cg -p ilu 96^3")
    t0 = time.perf_counter()
    r_c = lis_tpu_torch.solve(A96c, b96, options=opts)
    tag(f"cg -p ilu 96^3 on the CPU: iters {r_c.iters} in "
        f"{time.perf_counter() - t0:.2f} s")
    same_count("cg -p ilu 96^3", it, r_c.iters)
    del Milu

    # ---- (e) the level-scheduled path, I, and GMRES -----------------------
    S.stamp("phase 9e")
    opts = "-i gmres -restart 30 -p ssor"
    r, got, wall = S.counted(lambda: lis_tpu_torch.solve(A96, b96,
                                                         options=opts))
    shares("gmres -restart 30 -p ssor 96^3", r, wall, got,
           pssor.create_ssor(Dr, SolverOptions.from_string(opts)), Dr)
    if r.status != 0 or not r.true_resid <= 1e-7:
        fail(f"gmres 96^3: status {r.status} resid {r.true_resid:.3e}")
    S.need_exact(got, {"dia_relax": 4 * r.iters + 4 * -(-r.iters // 30),
                       "trisolve": 0}, "gmres 96^3")
    t0 = time.perf_counter()
    r_c = lis_tpu_torch.solve(A96c, b96, options=opts)
    tag(f"gmres 96^3 on the CPU: iters {r_c.iters} in "
        f"{time.perf_counter() - t0:.2f} s")
    same_count("gmres 96^3", r.iters, r_c.iters)

    # a nonsymmetric banded matrix: the 96^3 stencil with its lower
    # diagonals times 0.7, its upper ones times 1.3 and 28 on the diagonal
    Dn = Dr.to(dev)
    scale = torch.tensor([0.7 if o < 0 else (1.3 if o > 0 else 28 / 26)
                          for o in Dn.offsets], dtype=torch.float64,
                         device=dev)
    Dn = dataclasses.replace(Dn, value=Dn.value * scale[:, None])
    opts = "-i bicg -p ssor"
    r, got, wall = S.counted(lambda: lis_tpu_torch.solve(Dn, b96,
                                                         options=opts))
    shares("bicg -p ssor, nonsymmetric 96^3 DIA", r, wall, got,
           pssor.create_ssor(Dn, SolverOptions.from_string(opts)), Dn)
    if r.status != 0 or not r.true_resid <= 1e-7:
        fail(f"bicg -p ssor: status {r.status} resid {r.true_resid:.3e}")
    S.need_launches(got, ("dia_relax", "dia_relaxh"), 4 * r.iters,
                    "bicg -p ssor")
    r_c = lis_tpu_torch.solve(Dn.to("cpu"), b96, options=opts)
    same_count("bicg -p ssor", r.iters, r_c.iters)
    del A96, A96c, Dr, Dn
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    A64 = testmat.poisson3d27(g64, g64, g64)
    A64c = A64.to("cpu")
    b64 = np.ones(A64.nrows)
    tag(f"poisson3d27 64^3 CSR built in {time.perf_counter() - t0:.2f} s")
    for opts, want in (("-i cg -p ssor -auto_storage false", 2),
                       ("-i sor -tol 1e-8", 1)):
        r, got, wall = S.counted(lambda: lis_tpu_torch.solve(A64, b64,
                                                             options=opts))
        route = S.route_of(A64, opts)
        it = r.iters
        if "ssor" in opts:
            t0 = time.perf_counter()
            M = pssor.create_ssor(A64, SolverOptions.from_string(opts))
            torch.cuda.synchronize()
            tag(f"level-scheduled SSOR of the 64^3 CSR: four plans in "
                f"{time.perf_counter() - t0:.2f} s, nlev {M.fwd.nlev} / "
                f"{M.bwd.nlev}, max_rows {M.fwd.rows.shape[1]}")
            shares(f"{opts} 64^3 (route {route})", r, wall, got, M, A64)
            # one psolve is two launches of K and nothing between them:
            # every torch operation it dispatches that makes a tensor is
            # an allocation (K's flags and x), the y·(D/ω) multiply being
            # folded into K
            ops = []

            class Record(TorchDispatchMode):
                def __torch_dispatch__(self, func, types, args=(),
                                       kwargs=None):
                    out = func(*args, **(kwargs or {}))
                    ops.append((str(func), isinstance(out, torch.Tensor)))
                    return out
            rv = randn(A64.nrows, torch.float64)
            k0 = tsm.trisolve.launches
            with Record():
                M.psolve(rv)
            other = [o for o, made in ops
                     if made and not o.startswith("aten.empty")]
            if tsm.trisolve.launches - k0 != 2 or other:
                fail(f"SSOR psolve: {tsm.trisolve.launches - k0} launches "
                     f"of K and the operations {other} besides them")
            tag(f"SSOR psolve dispatches {[o for o, _ in ops]}: two "
                f"launches of K, no elementwise launch between them")
        else:
            tag(f"{opts} 64^3 (route {route}): status {r.status} iters {it} "
                f"true_resid {r.true_resid:.3e} wall {wall:.3f} s "
                f"({1e3 * r.itime / max(it, 1):.4f} ms/iter); launches {got}")
        if r.status != 0 or not r.true_resid <= (1e-7 if "cg" in opts
                                                 else 1e-6):
            fail(f"{opts} 64^3: status {r.status} resid {r.true_resid:.3e}")
        S.need_exact(got, {"trisolve": want * it, "dia_relax": 0},
                     f"{opts} 64^3")
        t0 = time.perf_counter()
        r_c = lis_tpu_torch.solve(A64c, b64, options=opts)
        tag(f"{opts} 64^3 on the CPU: iters {r_c.iters} in "
            f"{time.perf_counter() - t0:.2f} s")
        if it != r_c.iters:
            fail(f"{opts} 64^3: cuda iters {it} vs cpu {r_c.iters}")
    del A64, A64c
    torch.cuda.empty_cache()


def phase_krylov(S):
    """Phase 10: the twelve solvers of the Krylov slice on DIA at 96^3,
    two of them at 192^3 (see the docstring)."""
    import torch
    import lis_tpu_torch
    from lis_tpu_torch.matrix import dia as diam
    from lis_tpu_torch.precon.jacobi import create_jacobi
    from lis_tpu_torch.runtime.options import SolverOptions
    from lis_tpu_torch.solvers import driver as drv
    from lis_tpu_torch.solvers.base import SOLVER_FNS, SOLVER_PREPARE
    from lis_tpu_torch.utils import testmat

    dev = S.dev
    g96, g192 = S.grids[0], S.grids[1]

    def tag(msg):
        print(f"phase krylov: {msg}", flush=True)

    class PlainDIA:
        """D's matvec and matvech through the plain versions of E, F."""

        def __init__(self, D):
            self.D, self.nrows, self.device = D, D.nrows, D.device

        def matvec(self, x):
            return diam._spmv_plain(self.D.value, self.D.offsets, x,
                                    self.D.ncols)

        def matvech(self, x):
            return diam._spmvh_plain(self.D.value, self.D.offsets, x,
                                     self.D.ncols)

    class PlainSSOR:
        def __init__(self, D):
            self.psolve = plain_ssor(D)[0]

    def oracle(D, b, opts):
        """The solve's own solver function over the plain versions of E,
        F and H on the card (Jacobi is torch operations either way):
        (iterations, status, x, wall s).  It must launch no kernel."""
        o = SolverOptions.from_string(opts)
        spec = drv._make_spec(o)
        A = PlainDIA(D)
        M = PlainSSOR(D) if o.precon == "ssor" else create_jacobi(D, o)
        kw = {"aux": SOLVER_PREPARE[o.solver](A, spec)} \
            if o.solver in SOLVER_PREPARE else {}
        before = {name: f.launches for name, f in S.kernels.items()}
        t0 = time.perf_counter()
        out = SOLVER_FNS[o.solver](A, b, torch.zeros_like(b), M, spec, **kw)
        it = int(out.iters)
        wall = time.perf_counter() - t0
        if before != {name: f.launches for name, f in S.kernels.items()}:
            fail(f"the plain-version oracle of {opts} launched a kernel")
        return it, int(out.status), out.x, wall

    rows = []

    def cell(D, tag_, opts, oracle_x=False):
        """One counted solve of ``opts`` on D (b = ones), after one untimed
        and uncounted (the first call of a torch operation pays its
        library's set-up): SUCCESS, true residual <= 1e-7, E, F and H
        launched exactly as the solver's products and psolves imply, and
        the oracle's count ±1 (BiCGSTAB(l): ±l, one cycle, since it mostly
        converges in the MR part that ends a cycle)."""
        o = SolverOptions.from_string(opts)
        bt = torch.ones(D.nrows, dtype=torch.float64, device=dev)
        lis_tpu_torch.solve(D, bt, options=opts)
        r, got, wall = S.counted(lambda: lis_tpu_torch.solve(D, bt,
                                                             options=opts))
        it = r.iters
        mv, mvh, ps = krylov_counts(o.solver, it, ell=o.ell, s=o.irestart)
        want = dict.fromkeys(S.kernels, 0)
        want.update(dia_spmv=mv + 1, dia_spmvh=mvh,
                    dia_relax=4 * ps if o.precon == "ssor" else 0)
        kern = sum(got.values())
        (rd, cnt) = dispatched(lambda: lis_tpu_torch.solve(D, bt,
                                                           options=opts))
        it_o, st_o, x_o, wall_o = oracle(D, bt, opts)
        err = ((r.x - x_o).abs().max() / x_o.abs().max()).item()
        per = 1e3 * r.itime / max(it, 1)
        row = (tag_, opts, it, per, kern / it, (cnt["ops"] + kern) / it,
               cnt["reads"] / rd.iters, wall)
        rows.append(row)
        tag(f"{tag_} {opts}: status {r.status} iters {it} (plain-version "
            f"oracle {it_o} in {wall_o:.2f} s, x {err:.2e} relative) "
            f"true_resid {r.true_resid:.3e} wall {wall:.3f} s (ptime "
            f"{r.ptime:.3f} s, itime {r.itime:.4f} s, {per:.4f} ms/iter); "
            f"kernel launches {kern} = {kern / it:.2f}/iter, torch "
            f"operations {cnt['ops']} (views, allocations and reads "
            f"excluded), all launches {(cnt['ops'] + kern) / it:.1f}/iter, "
            f"host reads {cnt['reads']} = {cnt['reads'] / rd.iters:.2f}/iter "
            f"(the recorded solve: {rd.iters} iterations); products and "
            f"psolves the code implies {mv} + 1, {mvh}, {ps}")
        if r.status != 0 or st_o != 0 or not r.true_resid <= 1e-7:
            fail(f"{tag_} {opts}: status {r.status} (oracle {st_o}), true "
                 f"residual {r.true_resid:.3e}")
        if abs(it - it_o) > (o.ell if o.solver == "bicgstabl" else 1):
            fail(f"{tag_} {opts}: iters {it} vs the oracle's {it_o}")
        if oracle_x and err > 1e-6:
            fail(f"{tag_} {opts}: x differs from the oracle's by {err:.2e}")
        S.need_exact(got, want, f"{tag_} {opts}")

    # ---- (a) 96^3: SPD poisson3d27 and its nonsymmetric variant ----------
    t0 = time.perf_counter()
    P = testmat.poisson3d27_dia(g96, g96, g96)
    scale = torch.tensor([0.7 if o < 0 else (1.3 if o > 0 else 28 / 26)
                          for o in P.offsets], dtype=torch.float64,
                         device=dev)
    Dn = dataclasses.replace(P, value=P.value * scale[:, None])
    torch.cuda.synchronize()
    tag(f"poisson3d27_dia {g96}^3 (n={P.nrows}) and its nonsymmetric "
        f"variant built in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    for solver in KRYLOV:
        D = P if solver in ("minres", "orthomin") else Dn
        # the squared methods stagnate near 1e-7 on Dn under Jacobi (CGS
        # and CRS for 1000 iterations, TFQMR for 200, on the CPU and in
        # lis_tpu alike), so they run with SSOR
        precon = "ssor" if solver in ("cgs", "crs", "tfqmr") else "jacobi"
        cell(D, f"{g96}^3", f"-i {solver} -p {precon} -tol 1e-8")
    for opts in ("-i bicgstabl -p ssor -tol 1e-8",
                 "-i idrs -irestart 4 -p ssor -tol 1e-8"):
        cell(Dn, f"{g96}^3", opts)
    tag(f"{g96}^3: {len(KRYLOV) + 2} solves with their recorded runs and "
        f"oracles in {time.perf_counter() - t0:.2f} s")
    del P, Dn
    torch.cuda.empty_cache()

    # ---- (b) 192^3: the two solvers whose stacks grow with n --------------
    t0 = time.perf_counter()
    D192 = testmat.poisson3d27_dia(g192, g192, g192)
    torch.cuda.synchronize()
    tag(f"poisson3d27_dia {g192}^3 (n={D192.nrows}) built in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    for opts in ("-i bicgstabl -p jacobi -tol 1e-8",
                 "-i idrs -irestart 4 -p jacobi -tol 1e-8"):
        cell(D192, f"{g192}^3", opts, oracle_x=True)
    tag(f"{g192}^3: 2 solves with their recorded runs and oracles in "
        f"{time.perf_counter() - t0:.2f} s")
    del D192
    torch.cuda.empty_cache()
    tag("table: size, options, iterations, ms/iter, kernel launches/iter, "
        "all launches/iter, host reads/iter, solve wall s")
    for row in rows:
        tag("row " + json.dumps(row))


def phase_precon_more(S):
    """Phase 11: kernels J and L against their plain versions, SA-AMG's
    lattice path at 96^3 and 192^3, its graph path at 64^3, and each
    other preconditioner of the slice once (see the docstring)."""
    import torch
    import scipy.sparse as sp
    import lis_tpu_torch
    from lis_tpu_torch.ops import amg
    from lis_tpu_torch.precon import saamg as psa
    from lis_tpu_torch.runtime.options import SolverOptions
    from lis_tpu_torch.utils import testmat

    dev, check, randn, es = S.dev, S.check, S.randn, S.es
    g96, g192, g64 = S.grids

    def tag(msg):
        print(f"phase amg: {msg}", flush=True)

    def level_of(D, dims):
        """The finest lattice level of the DIA D: its transfer, assembled
        as the solve path assembles it, P as scipy CSR, and lis_tpu's
        implicit form (dinv and the tent) for the reference."""
        p_h, i_h, v_h = D.to_csr_arrays()
        a_h = sp.csr_matrix((v_h, i_h, p_h), shape=D.shape)
        P, cd, wc, dinv = psa.lattice_prolongator(a_h, dims)
        P.sort_indices()
        T = amg.LatticeTransfer.from_scipy(P, dev)
        tent = amg.LatticeTent(wc=torch.from_numpy(wc).to(dev), fdims=dims,
                               cdims=cd)
        return T, P, torch.from_numpy(dinv).to(dev), tent

    def sparse_csr(m, dtype):
        return torch.sparse_csr_tensor(
            torch.from_numpy(m.indptr.astype(np.int64)).to(dev),
            torch.from_numpy(m.indices.astype(np.int64)).to(dev),
            torch.from_numpy(m.data).to(dev, dtype), size=m.shape,
            check_invariants=False)

    # ---- (a) J and L on the 96^3 fine level and a cropped lattice --------
    S.stamp("phase 11a")
    for dims in ((g96,) * 3, (g96 - 2, g96 - 1, g96 + 1)):
        # dims slowest..fastest; poisson3d27_dia takes the fastest first
        Dd = testmat.poisson3d27_dia(*dims[::-1])
        n = Dd.nrows
        shape = "x".join(map(str, dims))
        timed_shape = dims == (g96,) * 3
        t0 = time.perf_counter()
        T64, P, dinv64, tent64 = level_of(Dd, dims)
        nc, nnz = T64.nc, P.nnz
        tag(f"{shape}: P and Pᵀ assembled and packed in "
            f"{time.perf_counter() - t0:.2f} s ({n} x {nc}, nnz {nnz}, "
            f"{nnz / n:.2f} a fine row, at most "
            f"{int((T64.pptr[1:] - T64.pptr[:-1]).max())}; a Pᵀ row at "
            f"most {int((T64.rptr[1:] - T64.rptr[:-1]).max())}); "
            f"{T64.nbytes / 2**20:.1f} MiB on the card at f64")
        if timed_shape:
            PT = P.T.tocsr()
            PT.sort_indices()
        for dtype in (torch.float64, torch.float32):
            T = T64.to(dtype=dtype)
            ec, x, r = randn(nc, dtype), randn(n, dtype), randn(n, dtype)
            tj = tl = None
            if dtype == torch.float64:
                # the assembled P against lis_tpu's implicit form
                D = Dd.to(dtype=dtype)
                for what, got, want in (
                        ("J", amg.lattice_prolong(T, ec, x),
                         amg.implicit_prolong(D, dinv64, tent64, ec, x)),
                        ("L", amg.lattice_restrict(T, r),
                         amg.implicit_restrict(D, dinv64, tent64, r))):
                    rel = ((got - want).abs().max()
                           / want.abs().max()).item()
                    tag(f"{shape} {what}: the assembled P against the "
                        f"implicit reference: {rel:.3e} relative")
                    if not rel <= 1e-12:
                        fail(f"{what} over the assembled P differs from "
                             f"the implicit reference by {rel:.2e}")
                del D
            if timed_shape:
                Pd, PTd = sparse_csr(P, dtype), sparse_csr(PT, dtype)
                x2, ec2, r2 = x[:, None], ec[:, None], r[:, None]
                e = es(dtype)
                # J: P's entries and row pointers, ec, x and out once
                tj = (lambda: amg.lattice_prolong(T, ec, x),
                      lambda: amg._prolong_plain(T, ec, x),
                      lambda: torch.sparse.addmm(x2, Pd, ec2),
                      nnz * (4 + e) + 4 * (n + 1) + (nc + 2 * n) * e,
                      2 * nnz + n)
                # L: Pᵀ's entries and row pointers, r and rc once
                tl = (lambda: amg.lattice_restrict(T, r),
                      lambda: amg._restrict_plain(T, r),
                      lambda: torch.sparse.mm(PTd, r2),
                      nnz * (4 + e) + 4 * (nc + 1) + (n + nc) * e,
                      2 * nnz)
                # the library calls compute the same functions
                for got, want in ((torch.sparse.addmm(x2, Pd, ec2)[:, 0],
                                   amg._prolong_plain(T, ec, x)),
                                  (torch.sparse.mm(PTd, r2)[:, 0],
                                   amg._restrict_plain(T, r))):
                    lerr = ((got - want).abs().max()
                            / want.abs().max()).item()
                    if lerr > (1e-12 if dtype == torch.float64 else 1e-4):
                        fail(f"the library P disagrees with J/L's plain "
                             f"versions by {lerr:.2e}")
            # J and L take 0.02-0.05 ms at 96^3, about what the host needs
            # to enqueue a launch: timed from the device's queue, as G is
            # (the host's figures are the record's host_ms and
            # library_host_ms)
            check("lattice_prolong", dtype, shape,
                  amg.lattice_prolong(T, ec, x),
                  amg._prolong_plain(T, ec, x), True, tj, queued=True)
            check("lattice_restrict", dtype, shape,
                  amg.lattice_restrict(T, r),
                  amg._restrict_plain(T, r), True, tl, queued=True)
            del T, tj, tl
            if timed_shape:
                del Pd, PTd
        del Dd, T64, P, dinv64, tent64
        if timed_shape:
            del PT
    torch.cuda.empty_cache()

    def vcycle_report(tag_, M, Dfine, r, got):
        """One psolve's time and launches, the finest level's kernels
        beside it, and the level sizes."""
        nlev = len(M.levels)
        rv = randn(Dfine.nrows, torch.float64)
        ps = cuda_ms(lambda: M.psolve(rv), reps=10)
        per_ps = S.launches_per(lambda: M.psolve(rv))
        _, ops = dispatched(lambda: M.psolve(rv))
        lv = M.levels[0]
        h = cuda_ms(lambda: S.kernels["dia_relax"](lv.A, rv, rv), reps=10)
        T = lv.transfer
        fine = {}
        if T is not None:
            # each kernel's time on the finest level (from the device's
            # queue) beside its byte bound (as phase 11a counts it, f64)
            nnz = T.pcol.numel()
            for k, fn, nb, fl in (
                    ("J", lambda: amg.lattice_prolong(T, rv[:T.nc], rv),
                     nnz * 12 + 4 * (T.n + 1) + (T.nc + 2 * T.n) * 8,
                     2 * nnz + T.n),
                    ("L", lambda: amg.lattice_restrict(T, rv),
                     nnz * 12 + 4 * (T.nc + 1) + (T.n + T.nc) * 8,
                     2 * nnz)):
                ms = cuda_ms(fn, reps=10, queued=True)
                b_ms = bound_ms(nb, fl, torch.float64)[0]
                fine[k] = f"{ms:.4f} ms (bound {b_ms:.4f}, " \
                    f"{100 * b_ms / ms:.0f} %)"
        tbytes = sum(l.transfer.nbytes for l in M.levels
                     if l.transfer is not None)
        per = 1e3 * r.itime / max(r.iters, 1)
        tag(f"{tag_}: levels {[l.A.nrows for l in M.levels]} + coarse "
            f"{M.coarse_inv.shape[0]}; status {r.status} iters {r.iters} "
            f"true_resid {r.true_resid:.3e}; ptime {r.ptime:.3f} s, itime "
            f"{r.itime:.4f} s, {per:.4f} ms/iter; one psolve {ps:.4f} ms "
            f"({100 * ps / per:.1f} % of an iteration), its launches "
            f"{ {k: c for k, c in per_ps.items() if c} } and torch "
            f"operations {ops['ops']} (host reads {ops['reads']}); finest "
            f"level: the residual sweep over all of A (H) {h:.4f} ms"
            + "".join(f", {k} {t}" for k, t in fine.items())
            + (f"; the transfers of J and L {tbytes / 2**20:.1f} MiB on the "
               f"card" if tbytes else "")
            + f"; launches in the solve {got}")
        return nlev

    def need_counts(what, got, want):
        print(f"phase amg: {what}: launches the code implies {want}",
              flush=True)
        S.need_exact(got, want, what)

    # ---- (b) CG + SA-AMG at 96^3: CSR -> router -> DIA, lattice path -----
    S.stamp("phase 11b")
    t0 = time.perf_counter()
    A96 = testmat.poisson3d27(g96, g96, g96)
    b96 = np.ones(A96.nrows)
    tag(f"poisson3d27 96^3 CSR built in {time.perf_counter() - t0:.2f} s")
    opts = "-i cg -p saamg -tol 1e-10"
    t0 = time.perf_counter()
    lis_tpu_torch.solve(A96, b96, options=opts)
    torch.cuda.synchronize()
    t_cold = time.perf_counter() - t0
    # the counted solve is the second: the first also pays the routing and
    # the first calls of torch's libraries (cuBLAS for the coarsest solve)
    r, got, wall = S.counted(lambda: lis_tpu_torch.solve(A96, b96,
                                                         options=opts))
    route = S.route_of(A96, opts)
    Dr = lis_tpu_torch.auto_storage(A96)
    M = psa.create_saamg(Dr, SolverOptions.from_string(opts))
    it = r.iters
    nlev = vcycle_report(f"cg -p saamg 96^3 (wall {wall:.3f} s, hierarchy "
                         f"and solve; the first solve {t_cold:.3f} s with "
                         f"the routing)", M, Dr, r, got)
    if route != "dia" or r.status != 0 or not r.true_resid <= 1e-9 \
            or any(lv.transfer is None for lv in M.levels):
        fail(f"cg -p saamg 96^3: route {route}, status {r.status}, true "
             f"residual {r.true_resid:.3e}, levels "
             f"{[lv.transfer is not None for lv in M.levels]}")
    # one psolve per iteration; per level and cycle J and L once, H twelve
    # times (two sweeps per Gauss-Seidel half, four residuals)
    need_counts("cg -p saamg 96^3", got, {
        "lattice_prolong": nlev * it, "lattice_restrict": nlev * it,
        "dia_relax": 12 * nlev * it, "dia_spmv": it + 1, "dia_relaxh": 0,
        "trisolve": 0})
    t0 = time.perf_counter()
    rc = lis_tpu_torch.solve(A96.to("cpu"), b96, options=opts)
    tag(f"cg -p saamg 96^3 on the CPU, plain versions: iters {rc.iters} "
        f"in {time.perf_counter() - t0:.2f} s")
    if abs(rc.iters - it) > 1 or rc.status != 0:
        fail(f"cg -p saamg 96^3: cuda iters {it} vs cpu {rc.iters}")
    del M, Dr, r, rc
    torch.cuda.empty_cache()

    # ---- (c) 192^3, built in DIA on the card, held to a plain oracle -----
    S.stamp("phase 11c")
    t0 = time.perf_counter()
    D192 = testmat.poisson3d27_dia(g192, g192, g192)
    b192 = torch.ones(D192.nrows, dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    tag(f"poisson3d27_dia 192^3 (n={D192.nrows}) built in "
        f"{time.perf_counter() - t0:.2f} s")
    o = SolverOptions.from_string(opts)
    t0 = time.perf_counter()
    M = psa.create_saamg(D192, o)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    r, got, wall = S.counted(lambda: lis_tpu_torch.solve(
        D192, b192, options=opts, M=M))
    it = r.iters
    tag(f"192^3: hierarchy built in {t_build:.2f} s (the host CSR of the "
        f"DIA, lattice detection, scipy Galerkin products, the upload)")
    nlev = vcycle_report(f"cg -p saamg 192^3 (wall {wall:.3f} s)", M, D192,
                         r, got)
    if r.status != 0 or not r.true_resid <= 1e-9:
        fail(f"cg -p saamg 192^3: status {r.status}, true residual "
             f"{r.true_resid:.3e}")
    need_counts("cg -p saamg 192^3", got, {
        "lattice_prolong": nlev * it, "lattice_restrict": nlev * it,
        "dia_relax": 12 * nlev * it, "dia_spmv": it + 2, "trisolve": 0})
    before = {name: f.launches for name, f in S.kernels.items()}
    t0 = time.perf_counter()
    xo, it_o = plain_pcg(D192, b192, 1e-10, 1000, plain_vcycle(M))
    torch.cuda.synchronize()
    t_o = time.perf_counter() - t0
    if before != {name: f.launches for name, f in S.kernels.items()}:
        fail("the plain-version oracle of SA-AMG launched a kernel")
    err = ((r.x - xo).abs().max() / xo.abs().max()).item()
    tag(f"192^3 oracle over the plain versions of E, G, H, J and L on the "
        f"card: iters {it_o} in {t_o:.2f} s; x differs by {err:.2e} "
        f"relative")
    if abs(it_o - it) > 1 or err > 1e-6:
        fail(f"cg -p saamg 192^3: iters {it} vs the oracle's {it_o}, x "
             f"{err:.2e}")
    del M, D192, b192, r, xo
    torch.cuda.empty_cache()

    # ---- (d) the graph path on a 64^3 CSR: K for the SGS ------------------
    S.stamp("phase 11d")
    A64 = testmat.poisson3d27(g64, g64, g64)
    A64c = A64.to("cpu")
    b64 = np.ones(A64.nrows)
    opts = "-i cg -p saamg -saamg_lattice false -tol 1e-10"
    r, got, wall = S.counted(lambda: lis_tpu_torch.solve(A64, b64,
                                                         options=opts))
    Dr = lis_tpu_torch.auto_storage(A64)
    M = psa.create_saamg(Dr, SolverOptions.from_string(opts))
    nlev = vcycle_report(f"cg -p saamg -saamg_lattice false 64^3 (wall "
                         f"{wall:.3f} s)", M, Dr, r, got)
    it = r.iters
    if r.status != 0 or not r.true_resid <= 1e-9 \
            or any(lv.transfer is not None for lv in M.levels):
        fail(f"graph saamg 64^3: status {r.status}, true residual "
             f"{r.true_resid:.3e}")
    # four level-scheduled solves per level and cycle, no lattice kernel
    need_counts("graph saamg 64^3", got, {
        "trisolve": 4 * nlev * it, "lattice_prolong": 0,
        "lattice_restrict": 0})
    t0 = time.perf_counter()
    rc = lis_tpu_torch.solve(A64c, b64, options=opts)
    tag(f"graph saamg 64^3 on the CPU: iters {rc.iters} in "
        f"{time.perf_counter() - t0:.2f} s")
    if abs(rc.iters - it) > 1 or rc.status != 0:
        fail(f"graph saamg 64^3: cuda iters {it} vs cpu {rc.iters}")
    del M, Dr

    # ---- (e) each other preconditioner of the slice once, at 64^3 ---------
    S.stamp("phase 11e")
    # the nonsymmetric variant of phases 9 and 10 (lower diagonals × 0.7,
    # upper × 1.3, 28 on the diagonal), for I+S: on the SPD operator a
    # change of 1e-14 in b moves BiCGSTAB + I+S's count at -tol 1e-10 by
    # 12 (100-112 on the CPU, lis_tpu_torch/tools/count_spread.py), here
    # by none at -tol 1e-8 (50)
    Dsp = lis_tpu_torch.auto_storage(A64)
    scale = torch.tensor([0.7 if o < 0 else (1.3 if o > 0 else 28 / 26)
                          for o in Dsp.offsets], dtype=torch.float64,
                         device=dev)
    Dn = dataclasses.replace(Dsp, value=Dsp.value * scale[:, None])
    ops = {"spd": (A64, A64c, "-tol 1e-10", 1e-9),
           "nonsym": (Dn, Dn.to("cpu"), "-tol 1e-8", 1e-7)}
    cases = [
        # (options, operator, kernels launched at least once per
        # iteration, kernels not launched)
        ("-i bicgstab -p ilut", "spd", ("dia_relax",), ("trisolve",)),
        ("-i bicgstab -p ilut -auto_storage false", "spd", ("trisolve",),
         ("dia_relax",)),
        # ILUC and SAINV drop every off-diagonal entry of this operator at
        # their default drop tolerance 0.05 (|−1| < 0.05·‖row‖): 0.01 keeps
        # them
        ("-i bicgstab -p iluc -iluc_drop 0.01", "spd", ("dia_relax",),
         ("trisolve",)),
        ("-i bicgstab -p iluc -iluc_drop 0.01 -auto_storage false", "spd",
         ("trisolve",), ("dia_relax",)),
        ("-i cg -p sainv -sainv_drop 0.01", "spd", ("dia_spmv",),
         ("trisolve", "dia_relax")),
        ("-i bicgstab -p is", "nonsym", ("dia_spmv",),
         ("trisolve", "dia_relax")),
        ("-i cg -p bjacobi", "spd", ("dia_spmv",), ("trisolve", "dia_relax")),
        ("-i gmres -p hybrid", "spd", ("dia_relax", "dia_spmv"),
         ("trisolve",)),
    ]
    rows = []
    for base, op, per_iter, never in cases:
        Ad, Ac, tol, bound = ops[op]
        opts = f"{base} {tol}"
        r, got, wall = S.counted(lambda: lis_tpu_torch.solve(
            Ad, b64, options=opts))
        t0 = time.perf_counter()
        rc = lis_tpu_torch.solve(Ac, b64, options=opts)
        t_c = time.perf_counter() - t0
        it = r.iters
        per = 1e3 * r.itime / max(it, 1)
        tag(f"64^3 {op} {opts}: route {S.route_of(Ad, opts)}, status "
            f"{r.status} iters {it} (cpu {rc.iters} in {t_c:.2f} s) "
            f"true_resid {r.true_resid:.3e}; ptime {r.ptime:.3f} s, "
            f"{per:.4f} ms/iter; launches "
            f"{ {k: c for k, c in got.items() if c} }")
        rows.append((op, opts, it, rc.iters, r.ptime, per))
        if r.status != 0 or not r.true_resid <= bound or rc.status != 0 \
                or abs(rc.iters - it) > 1:
            fail(f"64^3 {op} {opts}: status {r.status} (cpu {rc.status}), "
                 f"iters {it} vs cpu {rc.iters}, true residual "
                 f"{r.true_resid:.3e}")
        S.need_launches(got, per_iter, it, f"64^3 {opts}")
        S.need_exact(got, dict.fromkeys(never, 0), f"64^3 {opts}")
    tag("table: operator, options, iterations, cpu iterations, ptime s, "
        "ms/iter")
    for row in rows:
        tag("row " + json.dumps(row))
    del A64, A64c, Dsp, Dn, ops
    torch.cuda.empty_cache()


def phase_quad(S):
    """Phase 12: kernels M-P against their plain versions, then the
    double-double solves (see the docstring)."""
    import torch
    import lis_tpu_torch
    from lis_tpu_torch.core import ddreal as dq
    from lis_tpu_torch.utils import testmat

    dev, check, randn = S.dev, S.check, S.randn
    g96, g192, g64 = S.grids
    f32, f64 = torch.float32, torch.float64

    def tag(msg):
        print(f"phase quad: {msg}", flush=True)

    def pair(n, dtype):
        hi = randn(n, f64)
        lo = hi * (torch.rand(n, generator=S.gen, device=dev,
                              dtype=f64) - 0.5) * torch.finfo(dtype).eps
        return dq.DD(hi.to(dtype), lo.to(dtype))

    def flat(v):
        return torch.cat([v.hi.reshape(-1), v.lo.reshape(-1)])

    def tree_adds(w):
        """dd_adds of lis_tpu's row tree over w terms."""
        adds = 0
        while w > 1:
            w += w % 2
            adds += w // 2
            w //= 2
        return adds

    # ---- (a) M-P against their plain versions, f64 and df pairs ---------
    t0 = time.perf_counter()
    D96 = testmat.poisson3d27_dia(g96, g96, g96)
    n = D96.nrows
    nnd = len(D96.offsets)
    for dtype in (f64, f32):
        op = dq.make_dd_operator(D96, None if dtype == f64 else f32)
        x = pair(n, dtype)
        es = torch.empty((), dtype=dtype).element_size()
        for trans in (False, True):
            timed = None if trans else (
                lambda: dq.dd_dia_spmv(op, x),
                lambda: dq._dia_plain(op.value, op.offsets, x, op.value_lo,
                                      False), None,
                nnd * n * 8 + 4 * n * es,
                nnd * n * (39 + 2 * (dtype == f32)))
            check("dd_dia_spmv", dtype, f"{g96}^3 trans={trans}",
                  flat(dq.dd_dia_spmv(op, x, trans)),
                  flat(dq._dia_plain(op.value, op.offsets, x, op.value_lo,
                                     trans)), True, timed)
        y = pair(n, dtype)
        a = dq.DD(*(t.reshape(()) for t in pair(1, dtype)))
        m = 1 << (n - 1).bit_length()
        for mode in range(4):
            other = y if mode == 1 else None
            timed = None if mode != 1 else (
                lambda: dq.dd_reduce(1, x, y),
                lambda: dq._reduce_plain(1, x, y), None, 4 * n * es,
                24 * n + 20 * m)
            check("dd_reduce", dtype, f"{g96}^3 mode={mode}",
                  flat(dq.dd_reduce(mode, x, other)),
                  flat(dq._reduce_plain(mode, x, other)), True, timed,
                  queued=True)
        for mode in range(8):   # axpy xpay scal add sub mul div sqrt
            alpha = None if mode >= 3 else a
            other = None if mode in (2, 7) else y
            xin = dq._mul(x, x) if mode == 7 else x
            timed = None if mode != 0 else (
                lambda: dq.dd_update(0, a, x, y),
                lambda: dq._update_plain(0, a, x, y), None, 6 * n * es,
                44 * n)
            check("dd_update", dtype, f"{g96}^3 mode={mode}",
                  flat(dq.dd_update(mode, alpha, xin, other)),
                  flat(dq._update_plain(mode, alpha, xin, other)), True,
                  timed, queued=True)
        b0 = dq.DD(*(t.reshape(()) for t in pair(1, dtype)))
        check("dd_update", dtype, "0-d division (the scalar algebra)",
              flat(dq.div(a, b0)), flat(dq._div(a, b0)), True,
              (lambda: dq.div(a, b0), lambda: dq._div(a, b0), None,
               6 * es, 60), queued=True, record=False)
    del op, x, y
    # O's dot at 192^3 (m = 2^23), as quad-cg-jacobi-192^3 runs it
    n192 = g192 ** 3
    x, y = pair(n192, f64), pair(n192, f64)
    check("dd_reduce", f64, f"{g192}^3 mode=1", flat(dq.dd_reduce(1, x, y)),
          flat(dq._reduce_plain(1, x, y)), True,
          (lambda: dq.dd_reduce(1, x, y), lambda: dq._reduce_plain(1, x, y),
           None, 4 * n192 * 8, 24 * n192 + 20 * (1 << (n192 - 1).bit_length())),
          queued=True, record=False)
    del x, y
    tag(f"M, O, P at {g96}^3 and O at {g192}^3 in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    a20 = system(1 << 20, 8, S.seed)
    A20 = lis_tpu_torch.CSRMatrix.from_csr_arrays(a20.indptr, a20.indices,
                                                  a20.data, a20.shape)
    n20 = a20.shape[0]
    op64 = dq.DDOperator.from_matrix(A20)
    for dtype in (f64, f32):
        op = op64
        if dtype == f32:      # the same ELL arrays, values as f32 limbs
            vh, vl = dq._split_limbs(op64.value, f32)
            vth, vtl = dq._split_limbs(op64.value_t, f32)
            op = dq.DDOperator(op64.index, vh, op64.index_t, vth,
                               op64.nrows, op64.ncols, vl, vtl)
        w = op.value.shape[1]
        x = pair(n20, dtype)
        es = torch.empty((), dtype=dtype).element_size()
        for idx, val, vlo in ((op.index, op.value, op.value_lo),
                              (op.index_t, op.value_t, op.value_t_lo)):
            timed = None if idx is op.index_t else (
                lambda: dq.dd_ell_spmv(idx, val, x, vlo),
                lambda: dq._ell_plain(idx, val, x, vlo), None,
                n20 * w * (4 + 8) + 4 * n20 * es,
                n20 * w * (19 + 2 * (dtype == f32)) + 20 * n20 * tree_adds(w))
            check("dd_ell_spmv", dtype,
                  f"n=2^20 w={w} {'A' if timed else 'At'}",
                  flat(dq.dd_ell_spmv(idx, val, x, vlo)),
                  flat(dq._ell_plain(idx, val, x, vlo)), True, timed)
    del op, op64, x
    torch.cuda.empty_cache()
    tag(f"N on the n = 2^20 ELL pair in {time.perf_counter() - t0:.2f} s")

    @contextlib.contextmanager
    def plain_dd():
        """Every M-P wrapper swapped for its plain version (the solvers
        and operators look them up in ddreal at each call)."""
        swaps = {
            "dd_update": lambda mode, alpha, x, y: dq._update_plain(
                mode, alpha, x, y),
            "dd_reduce": lambda mode, x, y=None: dq._reduce_plain(mode, x,
                                                                  y),
            "dd_dia_spmv": lambda A, x, trans=False: dq._dia_plain(
                A.value, A.offsets, x, A.value_lo, trans),
            "dd_ell_spmv": lambda index, value, x, value_lo=None:
                dq._ell_plain(index, value, x, value_lo)}
        saved = {k: getattr(dq, k) for k in swaps}
        before = {k: f.launches for k, f in saved.items()}
        for k, f in swaps.items():
            setattr(dq, k, f)
        try:
            yield
        finally:
            for k, f in saved.items():
                setattr(dq, k, f)
        if before != {k: f.launches for k, f in saved.items()}:
            fail("a plain-version oracle launched one of M-P")

    rows = []

    def solve(A, b, opts, what, oracle=True, dd_limit=1e-12,
              true_limit=1e-11):
        """The plain oracle (which also warms the torch operations), then
        the counted solve: SUCCESS, the DD residual and the true residual
        within their limits, the oracle's count exactly."""
        it_o = None
        if oracle:
            t0 = time.perf_counter()
            with plain_dd():
                ro = lis_tpu_torch.solve(A, b, options=opts)
            torch.cuda.synchronize()
            it_o, wall_o = ro.iters, time.perf_counter() - t0
        r, got, wall = S.counted(lambda: lis_tpu_torch.solve(A, b,
                                                             options=opts))
        per = 1e3 * r.itime / max(r.iters, 1)
        dd = {k: got[k] for k in ("dd_dia_spmv", "dd_ell_spmv", "dd_reduce",
                                  "dd_update")}
        tag(f"{what} {opts}: route {S.route_of(A, opts)}, status "
            f"{r.status} iters {r.iters}"
            + (f" (plain oracle {it_o} in {wall_o:.2f} s)" if oracle else "")
            + f" resid {r.resid:.3e} true_resid {r.true_resid:.3e} wall "
            f"{wall:.3f} s itime {r.itime:.4f} s ({per:.4f} ms/iter); "
            f"M-P launches {dd}")
        rows.append((what, opts, r.iters, per, sum(dd.values()) / r.iters,
                     wall))
        if r.status != lis_tpu_torch.LIS_SUCCESS or not r.resid <= dd_limit \
                or not r.true_resid <= true_limit:
            fail(f"{what} {opts}: status {r.status} resid {r.resid:.3e} "
                 f"true_resid {r.true_resid:.3e}")
        if oracle and r.iters != it_o:
            fail(f"{what} {opts}: iters {r.iters}, plain oracle {it_o}")
        return r, got

    # ---- (b) cg -f quad at 96^3 (CSR -> router -> DIA) and 192^3 ---------
    S.stamp("phase 12b")
    A96 = testmat.poisson3d27(g96, g96, g96)
    b96 = torch.ones(A96.nrows, dtype=f64, device=dev)
    opts = "-i cg -p jacobi -f quad -tol 1e-12"
    r, got = solve(A96, b96, opts, f"{g96}^3")
    it = r.iters
    # per iteration: the matvec, two dots and nrm2, xpay and two axpys,
    # and the two DD divisions (beta, alpha)
    S.need_exact(got, {"dd_dia_spmv": it + 1, "dd_reduce": 3 * it + 1,
                       "dd_update": 5 * it + 1, "dd_ell_spmv": 0},
                 f"{g96}^3 {opts}")
    rd, cnt = dispatched(lambda: lis_tpu_torch.solve(A96, b96, options=opts))
    kern = 9 * rd.iters + 3
    tag(f"{g96}^3 {opts}: {kern / rd.iters:.2f} M-P launches, "
        f"{cnt['ops'] / rd.iters:.1f} torch operations (views, allocations "
        f"and reads excluded) and {cnt['reads'] / rd.iters:.2f} host reads "
        f"per iteration ({rd.iters} iterations)")
    xd = pair(A96.nrows, f64)
    Dq = dq.make_dd_operator(lis_tpu_torch.auto_storage(A96))
    one = dq.DD(torch.ones((), dtype=f64, device=dev),
                torch.zeros((), dtype=f64, device=dev))
    tag(f"{g96}^3 one iteration's parts (as the host enqueues them): M "
        f"{cuda_ms(lambda: Dq.matvec(xd)):.4f} ms, 2 dots + nrm2 "
        f"{3 * cuda_ms(lambda: dq.dot(xd, xd)):.4f} ms, 3 updates "
        f"{3 * cuda_ms(lambda: dq.axpy(one, xd, xd)):.4f} ms, 2 DD divisions "
        f"{2 * cuda_ms(lambda: dq.div(one, one)):.4f} ms")
    D192 = testmat.poisson3d27_dia(g192, g192, g192)
    b192 = torch.ones(D192.nrows, dtype=f64, device=dev)
    solve(D192, b192, opts, f"{g192}^3")
    del D192, b192, Dq, xd
    torch.cuda.empty_cache()

    # ---- (c) test5: quad converges where double stalls -------------------
    S.stamp("phase 12c")
    g = testmat.gamma_matrix(200, 2.0)
    bg = g.matvec(torch.ones(200, dtype=f64, device=dev))
    rq = lis_tpu_torch.solve(g, bg, options="-i bicg -f quad -tol 1e-12 "
                             "-maxiter 500")
    rdbl = lis_tpu_torch.solve(g, bg, options="-i bicg -f double -tol 1e-12 "
                               "-maxiter 500")
    rc = lis_tpu_torch.solve(testmat.gamma_matrix(200, 2.0, device="cpu"),
                             bg.cpu(), options="-i bicg -f quad -tol 1e-12 "
                             "-maxiter 500")
    xerr = (rq.x - 1.0).abs().max().item()
    tag(f"test5 gamma_matrix(200, 2.0): quad status {rq.status} iters "
        f"{rq.iters} (CPU {rc.iters}), |x - 1| {xerr:.2e}; double status "
        f"{rdbl.status} iters {rdbl.iters}")
    if rq.status != lis_tpu_torch.LIS_SUCCESS or rq.iters != rc.iters \
            or rdbl.status != lis_tpu_torch.LIS_MAXITER or not xerr < 1e-8:
        fail("test5: quad must converge in the CPU's count where double "
             "ends MAXITER")

    # ---- (d) switch, df and switch_df at 96^3 ----------------------------
    S.stamp("phase 12d")
    for o in ("-i cg -p jacobi -f switch -switch_tol 1e-8 -tol 1e-12",
              "-i cg -p jacobi -f df -tol 1e-12",
              "-i cg -p jacobi -f switch_df -tol 1e-12"):
        solve(A96, b96, o, f"{g96}^3", oracle=False)

    # ---- (e) N on a real path: bicgstab -f quad on the 2^20 CSR ----------
    S.stamp("phase 12e")
    b20 = torch.ones(n20, dtype=f64, device=dev)
    o = "-i bicgstab -f quad -auto_storage false -tol 1e-12"
    r, got = solve(A20, b20, o, "n=2^20 csr")
    S.need_launches(got, ("dd_ell_spmv",), 2 * r.iters, f"n=2^20 {o}")
    del A20, b20, a20
    torch.cuda.empty_cache()

    # ---- (f) the 17 twins on 64^3 -----------------------------------------
    # the 7-point poisson3d shifted by 6·I (diagonal 12): on the unshifted
    # operator GMRES(40) takes 535 iterations and its plain oracle 55 s
    S.stamp("phase 12f")
    P7 = lis_tpu_torch.auto_storage(testmat.poisson3d(g64, g64, g64))
    val = P7.value.clone()
    val[P7.offsets.index(0)] += 6.0
    A64 = dataclasses.replace(P7, value=val)
    b64 = torch.ones(A64.nrows, dtype=f64, device=dev)
    t0 = time.perf_counter()
    for name in QUAD_TWINS:
        solve(A64, b64, f"-i {name} -p jacobi -restart 8 -f quad -tol 1e-8",
              f"{g64}^3", dd_limit=1e-8, true_limit=1e-7)
    tag(f"{g64}^3: the {len(QUAD_TWINS)} twins with their oracles in "
        f"{time.perf_counter() - t0:.2f} s")
    tag("table: size, options, iterations, ms/iter, M-P launches/iter, "
        "solve wall s")
    for row in rows:
        tag("row " + json.dumps(row))


def phase_formats(S):
    """Phase 13: the scalar formats coo, csc, msr, ell, jad and dns, the
    RCM reordering, the explicit transpose and the HB / Lis / PLAIN /
    binary MatrixMarket I/O (see the docstring).  The formats' matvecs
    are torch operations (lis_tpu has no Pallas kernel there); the solves
    run the existing kernels: G, K and N."""
    import torch
    import scipy.sparse as sp
    import lis_tpu_torch
    from lis_tpu_torch.cli import lsolve
    from lis_tpu_torch.matrix.base import TensorFields
    from lis_tpu_torch.matrix.reorder import (bandwidth, permute_symmetric,
                                              rcm_permutation)
    from lis_tpu_torch.matrix.useat import with_explicit_transpose
    from lis_tpu_torch.utils import testmat

    dev, f64 = S.dev, torch.float64
    g96, g192, g64 = S.grids
    t_phase = time.perf_counter()
    S.format_rows = []

    def tag(msg):
        print(f"phase formats: {msg}", flush=True)

    def nbytes(M):
        """Bytes of every tensor the format holds."""
        total = 0
        for f in dataclasses.fields(M):
            v = getattr(M, f.name)
            if isinstance(v, torch.Tensor):
                total += v.numel() * v.element_size()
            elif isinstance(v, TensorFields):
                total += nbytes(v)
        return total

    def rel_err(got, want):
        return ((got - want).abs().max() / want.abs().max()).item()

    def solve(M, b, opts):
        r, got, wall = S.counted(lambda: lis_tpu_torch.solve(M, b,
                                                             options=opts))
        per = 1e3 * r.itime / max(r.iters, 1)
        tag(f"{opts} on {M.format_name} n={M.nrows}: status {r.status} "
            f"iters {r.iters} true_resid {r.true_resid:.3e} wall {wall:.3f} "
            f"s ({per:.4f} ms/iter)")
        return r, got, per

    def near(what, it, it_ref, slack=1):
        if abs(it - it_ref) > slack:
            fail(f"{what}: {it} iterations against {it_ref}")

    def cg_step(got, it, what):
        S.need_exact(got, {"krylov_dot": it + 1, "cg_direction": it,
                           "cg_update": it, "cg_finish": it,
                           "dia_spmv": 0}, what)

    # ---- (a) the formats' matvecs at 96^3, f64 -------------------------
    S.stamp("phase 13a")
    t0 = time.perf_counter()
    A96 = testmat.poisson3d27(g96, g96, g96)
    n, nnz = A96.nrows, A96.nnz
    tag(f"poisson3d27 {g96}^3 CSR: n={n} nnz={nnz} built in "
        f"{time.perf_counter() - t0:.2f} s")
    x, y = S.randn(n, f64), S.randn(n, f64)
    want_mv, want_mvh = A96.matvec(x), A96.matvech(y)
    mats = {"csr": A96}
    for fmt in ("coo", "csc", "msr", "ell", "jad"):
        t0 = time.perf_counter()
        mats[fmt] = lis_tpu_torch.convert_matrix(A96, fmt)
        torch.cuda.synchronize()
        t_conv = time.perf_counter() - t0
        M = mats[fmt]
        err = max(rel_err(M.matvec(x), want_mv),
                  rel_err(M.matvech(y), want_mvh))
        if not err <= 1e-13 or M.device != dev:
            fail(f"{fmt} 96^3: matvec/matvech off the CSR's by {err:.3e}")
        tag(f"{fmt}: converted on the host and moved in {t_conv:.2f} s; "
            f"matvec and matvech against the CSR's: max rel err {err:.3e}")
    for fmt, M in mats.items():            # csr first: the gather
        mb = nbytes(M)
        b_ms, b_by = bound_ms(mb + 2 * n * 8, 2 * nnz, f64)
        ms = cuda_ms(lambda: M.matvec(x), queued=True)
        msh = cuda_ms(lambda: M.matvech(y), queued=True)
        S.format_rows.append({"format": fmt, "n": n, "nnz": nnz,
                              "array_bytes": mb, "matvec_ms": ms,
                              "matvech_ms": msh, "bound_ms": b_ms,
                              "bound_by": b_by, "timing": "queued"})
        csr = S.format_rows[0]
        tag(f"{fmt} {g96}^3 f64: matvec {ms:.4f} ms, matvech {msh:.4f} ms "
            f"(queued; the CSR's {csr['matvec_ms']:.4f} / "
            f"{csr['matvech_ms']:.4f}), bound {b_ms:.4f} ms ({b_by}; "
            f"{mb / 2**20:.1f} MiB of arrays; {100 * b_ms / ms:.0f} % / "
            f"{100 * b_ms / msh:.0f} %)")

    # ---- (b) CG + Jacobi per format at 96^3 -----------------------------
    S.stamp("phase 13b")
    b96 = torch.ones(n, dtype=f64, device=dev)
    opts = "-i cg -p jacobi -tol 1e-10 -storage"
    its = {}
    for fmt, M in mats.items():
        r, got, per = solve(M, b96, f"{opts} {fmt}")
        its[fmt] = r.iters
        if r.status != 0 or not r.true_resid <= 1e-9:
            fail(f"cg -storage {fmt}: status {r.status} resid "
                 f"{r.true_resid:.3e}")
        near(f"cg -storage {fmt}", r.iters, its["csr"])
        cg_step(got, r.iters, f"cg -storage {fmt}")
        next(w for w in S.format_rows if w["format"] == fmt).update(
            cg_jacobi_iters=r.iters, cg_jacobi_ms_per_iter=per)

    # ---- (c) BiCGSTAB -f quad: the ELL pair of the same CSR, N ----------
    S.stamp("phase 13c")
    opts = "-i bicgstab -f quad -tol 1e-12 -storage"
    for fmt in ("csr", "coo", "jad"):
        r, got, per = solve(mats[fmt], b96, f"{opts} {fmt}")
        its["quad " + fmt] = r.iters
        if r.status != 0 or not r.resid <= 1e-12 \
                or not r.true_resid <= 1e-11:
            fail(f"bicgstab quad -storage {fmt}: status {r.status} resid "
                 f"{r.resid:.3e} true_resid {r.true_resid:.3e}")
        near(f"bicgstab quad -storage {fmt}", r.iters, its["quad csr"], 0)
        S.need_exact(got, {"dd_ell_spmv": 2 * r.iters + 1,
                           "dd_dia_spmv": 0}, f"bicgstab quad {fmt}")
    del mats, A96, x, y, want_mv, want_mvh, b96
    torch.cuda.empty_cache()

    # ---- (d) SSOR on an ELL operator at 64^3: K, twice a psolve ---------
    S.stamp("phase 13d")
    A64 = testmat.poisson3d27(g64, g64, g64)
    n64 = A64.nrows
    E64 = lis_tpu_torch.convert_matrix(A64, "ell")
    b64 = torch.ones(n64, dtype=f64, device=dev)
    r_csr, _, _ = solve(A64, b64, "-i cg -p ssor -storage csr")
    r, got, per = solve(E64, b64, "-i cg -p ssor -storage ell")
    if r.status != 0 or not r.true_resid <= 1e-7:
        fail(f"cg -p ssor -storage ell: status {r.status}")
    near("cg -p ssor -storage ell", r.iters, r_csr.iters)
    S.need_exact(got, {"trisolve": 2 * r.iters, "dia_relax": 0},
                 "cg -p ssor -storage ell")
    del E64

    # ---- (e) DNS: poisson2d at n = 16384, 2 GiB of f64 -------------------
    S.stamp("phase 13e")
    P = testmat.poisson2d(128, 128)
    t0 = time.perf_counter()
    Dn = lis_tpu_torch.convert_matrix(P, "dns")
    torch.cuda.synchronize()
    tag(f"dns n={P.nrows}: {nbytes(Dn) / 2**30:.2f} GiB built in "
        f"{time.perf_counter() - t0:.2f} s")
    xd = S.randn(P.nrows, f64)
    err = rel_err(Dn.matvec(xd), P.matvec(xd))
    if not err <= 1e-13:
        fail(f"dns matvec off the CSR's by {err:.3e}")
    ms = cuda_ms(lambda: Dn.matvec(xd))
    b_ms, b_by = bound_ms(nbytes(Dn) + 2 * P.nrows * 8,
                          2 * P.nrows * P.nrows, f64)
    bp = torch.ones(P.nrows, dtype=f64, device=dev)
    r_csr, _, _ = solve(P, bp, "-i cg -p jacobi -tol 1e-10 -storage csr")
    r, got, per = solve(Dn, bp, "-i cg -p jacobi -tol 1e-10 -storage dns")
    if r.status != 0 or not r.true_resid <= 1e-9:
        fail(f"cg -storage dns: status {r.status} resid {r.true_resid:.3e}")
    near("cg -storage dns", r.iters, r_csr.iters)
    cg_step(got, r.iters, "cg -storage dns")
    S.format_rows.append({"format": "dns", "n": P.nrows,
                          "nnz": P.nrows * P.nrows,
                          "array_bytes": nbytes(Dn), "matvec_ms": ms,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "timing": "host", "cg_jacobi_iters": r.iters,
                          "cg_jacobi_ms_per_iter": per,
                          "csr_cg_jacobi_iters": r_csr.iters})
    tag(f"dns matvec (torch.mv) {ms:.4f} ms against the CSR's iters "
        f"{r_csr.iters}; bound {b_ms:.4f} ms ({b_by}, "
        f"{100 * b_ms / ms:.0f} %); max rel err {err:.3e}")
    del Dn, P, xd, bp
    torch.cuda.empty_cache()

    # ---- (f) -reorder rcm on a scrambled 64^3 ---------------------------
    S.stamp("phase 13f")
    ptr, idx, val = A64.to_csr_arrays()
    a = sp.csr_matrix((val, idx, ptr), shape=A64.shape)
    perm = np.random.default_rng(S.seed).permutation(n64)
    t0 = time.perf_counter()
    s = a[perm][:, perm].tocsr()
    s.sort_indices()
    As = lis_tpu_torch.CSRMatrix.from_csr_arrays(s.indptr, s.indices,
                                                 s.data, s.shape)
    pr = rcm_permutation(As)
    Ar = permute_symmetric(As, pr)
    opts = "-i cg -p jacobi -tol 1e-10"
    route = S.route_of(Ar, opts)
    tag(f"scrambled {g64}^3: bandwidth {bandwidth(As)} -> {bandwidth(Ar)} "
        f"after RCM, route {route} (scramble, RCM and routing "
        f"{time.perf_counter() - t0:.2f} s)")
    del Ar
    bx = S.randn(n64, f64)
    pd = torch.from_numpy(perm).to(dev)
    r0, _, _ = solve(A64, bx, opts)
    r, got, per = solve(As, bx.index_select(0, pd), opts + " -reorder rcm")
    want = r0.x.index_select(0, pd)
    xerr = rel_err(r.x, want)
    tag(f"-reorder rcm: iters {r.iters} against the unscrambled "
        f"{r0.iters}, x against the unscrambled x permuted: max rel err "
        f"{xerr:.3e}; launches {dict((k, c) for k, c in got.items() if c)}")
    if r.status != 0 or not r.true_resid <= 1e-9 or not xerr <= 1e-8:
        fail(f"-reorder rcm: status {r.status}, x off by {xerr:.3e}")
    near("-reorder rcm", r.iters, r0.iters)
    del A64, As, b64, bx, pd, r0, r, want
    torch.cuda.empty_cache()

    # ---- (g) -use_at on phase 9's nonsymmetric variant ------------------
    # (lower diagonals x 0.7, upper x 1.3, 28 on the diagonal).  On the
    # 64^3 DIA, BiCG and BiCR + Jacobi: -use_at false's count ±1, with F
    # launched there and never with -use_at.  At 96^3 BiCG + Jacobi is
    # count-unstable (a change of 1e-14 in b moves it by tens of
    # iterations, or makes it diverge), so there BiCG + SSOR runs on the
    # CSR form, where both settings take the level-scheduled SSOR (K) and
    # differ only in how Aᴴ is applied (scatter or explicit gather)
    S.stamp("phase 13g")
    for g in (g64, g96):
        Dd = testmat.poisson3d27_dia(g, g, g)
        scale = torch.tensor([0.7 if o < 0 else (1.3 if o > 0 else 28 / 26)
                              for o in Dd.offsets], dtype=f64, device=dev)
        Dd = dataclasses.replace(Dd, value=Dd.value * scale[:, None])
        W = with_explicit_transpose(Dd)
        yd = S.randn(Dd.nrows, f64)
        err = rel_err(W.matvech(yd), Dd.matvech(yd))
        tag(f"{g}^3: the explicit Aᴴ's gather against F: max rel err "
            f"{err:.3e}")
        if not err <= 1e-13:
            fail(f"-use_at {g}^3: Aᴴ off F's product by {err:.3e}")
        ones = torch.ones(Dd.nrows, dtype=f64, device=dev)
        if g == g64:
            A, runs = Dd, [f"-i {s} -p jacobi -tol 1e-10"
                           for s in ("bicg", "bicr")]
        else:
            A = lis_tpu_torch.convert_matrix(Dd, "csr")
            runs = ["-i bicg -p ssor -auto_storage false"]
        del W
        for opts in runs:
            its = {}
            for mode in ("false", "true"):
                r, got, per = solve(A, ones, f"{opts} -use_at {mode}")
                its[mode] = r.iters
                if r.status != 0 or not r.true_resid <= 1e-9:
                    fail(f"{opts} -use_at {mode} {g}^3: status "
                         f"{r.status} resid {r.true_resid:.3e}")
                on_dia = A.format_name == "dia"
                if mode == "true" and (got["dia_spmvh"] != 0 or on_dia
                                       and got["dia_spmv"] < r.iters):
                    fail(f"{opts} -use_at true {g}^3: F launched "
                         f"{got['dia_spmvh']} times, E {got['dia_spmv']}")
                if mode == "false" and on_dia \
                        and got["dia_spmvh"] < r.iters:
                    fail(f"{opts} -use_at false {g}^3: F launched "
                         f"{got['dia_spmvh']} times")
            near(f"{opts} -use_at true {g}^3", its["true"], its["false"])
        del Dd, A, ones
        torch.cuda.empty_cache()

    # ---- (h) the files of phase 8a's matrix through lsolve -------------
    S.stamp("phase 13h")
    P2 = testmat.poisson2d(512, 512)
    argv = ["-i", "cg", "-p", "jacobi", "-tol", "1e-8", "-maxiter", "10000"]
    with tempfile.TemporaryDirectory() as tmp:
        def file(name):
            return os.path.join(tmp, name)
        t0 = time.perf_counter()
        lis_tpu_torch.lis_output(file("a.hb"), P2, fmt="hb")
        lis_tpu_torch.lis_output(file("a.lis"), P2, fmt="lis")
        lis_tpu_torch.lis_output(file("a_le.mtx"), P2, fmt="mmb")
        # the writer takes the host's order, as lis_tpu's does: a
        # big-endian file is written with numpy told the host is one
        np.little_endian = False
        try:
            lis_tpu_torch.write_matrix_market(file("a_be.mtx"), P2,
                                              binary=True)
        finally:
            np.little_endian = sys.byteorder == "little"
        for name, flag in (("a_le.mtx", "2"), ("a_be.mtx", "1")):
            with open(file(name), "rb") as fh:
                size_line = fh.read(200).split(b"\n")[1].split()
            if size_line[-1] != flag.encode():
                fail(f"{name}: size line {size_line} lacks isbin {flag}")
        ones = torch.ones(P2.nrows, dtype=f64, device=dev)
        lis_tpu_torch.lis_output_vector(file("b.txt"), ones, fmt="plain")
        lis_tpu_torch.lis_output_vector(file("b.lisb"), ones, fmt="lisb")
        tag(f"poisson2d 512x512 written as hb, lis, mmb < and >, b as "
            f"plain and lisb in {time.perf_counter() - t0:.2f} s")
        for mat, rhs in (("a.hb", "b.txt"), ("a.lis", "b.lisb"),
                         ("a_le.mtx", "1"), ("a_be.mtx", "1")):
            t0 = time.perf_counter()
            Af = lis_tpu_torch.lis_input(file(mat))[0]
            if rhs != "1":
                bf = lis_tpu_torch.lis_input_vector(file(rhs))
                if not torch.equal(bf, ones):
                    fail(f"{rhs}: the vector read back differs")
            t_parse = time.perf_counter() - t0
            same = all(np.array_equal(u, w) for u, w in
                       zip(Af.to_csr_arrays(), P2.to_csr_arrays()))
            rhs_arg = file(rhs) if rhs != "1" else rhs
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc, got, wall = S.counted(
                    lambda: lsolve.main([file(mat), rhs_arg] + argv))
            last = out.getvalue().splitlines()[-2]
            it = int(last.rsplit("=", 1)[1])
            tag(f"lsolve {mat} {rhs}: exit {rc}, iters {it} (the MM file "
                f"{S.it_ls}), parsed in {t_parse:.2f} s, wall {wall:.2f} s")
            if rc != 0 or not same or it != S.it_ls:
                fail(f"lsolve {mat}: exit {rc}, arrays equal {same}, iters "
                     f"{it} against {S.it_ls}")
    ptr, idx, val = P2.to_csr_arrays()
    rows = np.repeat(np.arange(P2.nrows), np.diff(ptr)).tolist()
    t0 = time.perf_counter()
    asm = lis_tpu_torch.MatrixAssembler(P2.shape)
    for i, j, v in zip(rows, idx.tolist(), val.tolist()):
        asm.set_value(lis_tpu_torch.LIS_INS_VALUE, i, j, v)
    B = asm.assemble("csr")
    t_asm = time.perf_counter() - t0
    same = all(np.array_equal(u, w) for u, w in
               zip(B.to_csr_arrays(), P2.to_csr_arrays()))
    tag(f"MatrixAssembler: {len(rows)} set_value calls and assemble in "
        f"{t_asm:.2f} s on {B.device}, arrays equal to the generator's: "
        f"{same}")
    if not same or B.device != dev:
        fail("MatrixAssembler: the assembled matrix differs")
    tag(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")


# the solvers with a _quad twin (lis_tpu_torch/solvers/quad*.py)
QUAD_TWINS = ("cg", "cr", "bicg", "cgs", "bicgstab", "bicr", "crs",
              "bicrstab", "gpbicg", "gpbicr", "bicgsafe", "bicrsafe", "tfqmr",
              "orthomin", "bicgstabl", "gmres", "fgmres")


def plain_vcycle(M):
    """The psolve of the lattice SA-AMG preconditioner ``M`` over the plain
    versions of H, J and L (and the coarsest matmul), in the order of
    ``SAAMGPrecon._cycle`` with the SGS smoother: the oracle of the 192^3
    solve."""
    from lis_tpu_torch.matrix import dia as diam
    from lis_tpu_torch.ops import amg

    def relax(T, rhs, y=None, w=None, start=False):
        return diam._relax_plain(T.value, T.offsets, rhs, y, None, w, None,
                                 start, False)

    def gs(lv, b, lower):
        T = lv.Ls if lower else lv.Us
        return relax(T, b, relax(T, b, w=lv.dinv, start=True), w=lv.dinv)

    def cycle(k, b):
        if k == len(M.levels):
            return M.coarse_inv @ b
        lv = M.levels[k]
        x = gs(lv, b, True)
        x = x + gs(lv, relax(lv.A, b, x), False)
        rc = amg._restrict_plain(lv.transfer, relax(lv.A, b, x))
        x = amg._prolong_plain(lv.transfer, cycle(k + 1, rc), x)
        x = x + gs(lv, relax(lv.A, b, x), True)
        return x + gs(lv, relax(lv.A, b, x), False)
    return lambda b: cycle(0, b)


# torch operations that move no data on the card: views, allocations
FREE_OPS = {"view", "_unsafe_view", "alias", "slice", "select", "as_strided",
            "expand", "t", "transpose", "unsqueeze", "squeeze", "detach",
            "empty", "empty_strided", "lift_fresh", "_reshape_alias",
            "resolve_conj", "resolve_neg", "permute", "unbind", "real",
            "imag", "view_as_real", "view_as_complex", "_conj", "conj"}


def dispatched(fn):
    """fn()'s result and its (torch operations that run on the card, reads
    of a device value by the host), counted by a dispatch mode; views and
    allocations (``FREE_OPS``) are left out."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    cnt = {"ops": 0, "reads": 0}

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            on_card = any(isinstance(a, torch.Tensor) and a.is_cuda
                          for a in args)
            to_host = isinstance(out, torch.Tensor) and not out.is_cuda
            if name == "_local_scalar_dense" or (on_card and to_host):
                cnt["reads"] += 1
            elif name not in FREE_OPS:
                cnt["ops"] += 1
            return out
    with Record():
        res = fn()
    torch.cuda.synchronize()
    return res, cnt


def plain_pcg(D, b, tol, maxiter, psolve):
    """Preconditioned CG over the plain versions of E and G on D's device,
    in the order of the port's fused CG step (x0 = 0, nrm2_r), with the
    given ``psolve``: (x, iterations)."""
    import torch
    from lis_tpu_torch.core import vector as v
    from lis_tpu_torch.matrix import dia as diam
    x, rr, p = torch.zeros_like(b), b.clone(), torch.zeros_like(b)
    nrm0 = torch.sqrt(torch.dot(rr, rr))
    ws = v.KrylovScalars(b, maxiter, tol, 1.0 / nrm0, torch.ones_like(nrm0),
                         nrm1=False, running=-99, breakdown=2)
    rh = torch.zeros(maxiter + 2, dtype=b.dtype, device=b.device)
    while int(ws.live):
        z = psolve(rr)
        v._krylov_dot_plain(rr, z, None, ws, v.P_RHO)
        v._cg_direction_plain(p, rr, z, None, ws)
        q = diam._spmv_plain(D.value, D.offsets, p, D.ncols)
        v._krylov_dot_plain(p, q, None, ws, v.P_PQ)
        v._cg_update_plain(x, rr, p, q, None, ws, False)
        v._cg_finish_plain(ws, rh)
    return x, int(ws.it) - 1


def plain_ssor(D):
    """(psolve, sweep): ``-p ssor``'s psolve on the DIA ``D`` (ω = 1, two
    sweeps each way, as SSORRelaxPrecon orders them) and one relaxed sweep,
    both over the plain version of kernel H."""
    import torch
    from lis_tpu_torch.matrix import dia as diam
    from lis_tpu_torch.precon import ssor as pssor
    Lp, Up, dd = pssor._split_dia(D)
    wd = pssor._inv_where(dd, 1.0)
    dtil = torch.where(wd != 0, 1.0 / wd, torch.ones_like(wd))

    def sweep(T, rhs, y=None, w=None, rs=None, start=False):
        return diam._relax_plain(T.value, T.offsets, rhs, y, None, w, rs,
                                 start, False)

    def ssor(q):
        y = sweep(Lp, q, w=wd, start=True)
        y = sweep(Lp, q, y, w=wd)
        z = sweep(Up, y, w=wd, rs=dtil, start=True)
        return sweep(Up, y, z, w=wd, rs=dtil)
    return ssor, sweep


# the solvers of the Krylov slice (lis_tpu_torch/solvers/{cgs,tfqmr,
# orthomin,gpbicg,bicgsafe,bicgstabl,idrs,minres}.py); all but minres take
# nonsymmetric systems
KRYLOV = ("cgs", "crs", "tfqmr", "orthomin", "gpbicg", "gpbicr", "bicgsafe",
          "bicrsafe", "bicgstabl", "idrs", "idr1", "minres")


def krylov_counts(solver: str, iters: int, ell: int = 2, s: int = 2):
    """(matvecs, transposed products, psolves) that a solve by ``solver``
    makes when it converges in ``iters`` iterations, as its code in
    lis_tpu_torch/solvers applies them: the initial residual's matvec
    included, the driver's true residual not.  ``ell`` is BiCGSTAB(l)'s
    -ell and ``s`` IDR(s)'s -irestart.  Every step runs all its products
    (a masked one too): BiCGSTAB(l) runs whole cycles of l BiCG steps
    (2 matvecs and 2 psolves each) and one psolve at the exit; IDR(s)
    runs its s start steps even when it converges among them."""
    it = iters
    per_iter = {"cgs": (2, 0, 2), "crs": (2, 0, 2), "tfqmr": (2, 0, 4),
                "orthomin": (1, 0, 1), "gpbicg": (2, 0, 4),
                "gpbicr": (2, 0, 2), "bicgsafe": (2, 0, 2),
                "bicrsafe": (2, 0, 2), "minres": (1, 0, 1)}
    setup = {"crs": (0, 1, 0), "tfqmr": (1, 0, 1), "orthomin": (0, 0, 1),
             "gpbicr": (0, 1, 1), "bicgsafe": (1, 0, 1),
             "bicrsafe": (1, 1, 1), "minres": (0, 0, 1)}
    if solver == "bicgstabl":
        cycles = -(-it // ell)
        return 1 + 2 * ell * cycles, 0, 2 * ell * cycles + 1
    if solver in ("idrs", "idr1"):
        steps = max(it, s if solver == "idrs" else 1)
        return 1 + steps, 0, steps
    mv, mvh, ps = per_iter[solver]
    smv, smvh, sps = setup.get(solver, (0, 0, 0))
    return 1 + smv + mv * it, smvh + mvh * it, sps + ps * it


# the repo file of each kernel's source, and the lis_tpu code it replaces: a
# Pallas kernel (#1, A-D) or, for E-K, the loop that lis_tpu leaves to XLA
WHERE = {
    "lane_shuffle": ("lis_tpu_torch/csrc/lane_shuffle.cu",
                     "lis_tpu/ops/shuffle.py:350"),
    "cst_front": ("lis_tpu_torch/csrc/cst_front.cu",
                  "lis_tpu/matrix/cst.py:259"),
    "benes_pass": ("lis_tpu_torch/csrc/benes.cu",
                   "lis_tpu/ops/shuffle.py:419"),
    "benes_pass_rowsum": ("lis_tpu_torch/csrc/benes.cu",
                          "lis_tpu/ops/shuffle.py:509"),
    "benes_small_run": ("lis_tpu_torch/csrc/benes.cu",
                        "lis_tpu/ops/shuffle.py:583"),
    "dia_spmv": ("lis_tpu_torch/csrc/dia.cu", "lis_tpu/matrix/dia.py:119"),
    "dia_spmvh": ("lis_tpu_torch/csrc/dia.cu", "lis_tpu/matrix/dia.py:136"),
    "krylov_dot": ("lis_tpu_torch/csrc/krylov.cu",
                   "lis_tpu/solvers/cg.py:36"),
    "cg_direction": ("lis_tpu_torch/csrc/krylov.cu",
                     "lis_tpu/solvers/cg.py:38"),
    "cg_update": ("lis_tpu_torch/csrc/krylov.cu", "lis_tpu/solvers/cg.py:43"),
    "cg_finish": ("lis_tpu_torch/csrc/krylov.cu", "lis_tpu/solvers/cg.py:45"),
    "dia_relax": ("lis_tpu_torch/csrc/dia_relax.cu",
                  "lis_tpu/precon/ssor.py:60"),
    "dia_relaxh": ("lis_tpu_torch/csrc/dia_relax.cu",
                   "lis_tpu/precon/ssor.py:75"),
    "trisolve": ("lis_tpu_torch/csrc/trisolve.cu",
                 "lis_tpu/ops/trisolve.py:92"),
    "lattice_prolong": ("lis_tpu_torch/csrc/amg.cu",
                        "lis_tpu/precon/saamg.py:341"),
    "lattice_restrict": ("lis_tpu_torch/csrc/amg.cu",
                         "lis_tpu/precon/saamg.py:345"),
    "dd_dia_spmv": ("lis_tpu_torch/csrc/dd.cu", "lis_tpu/core/ddreal.py:365"),
    "dd_ell_spmv": ("lis_tpu_torch/csrc/dd.cu", "lis_tpu/core/ddreal.py:299"),
    "dd_reduce": ("lis_tpu_torch/csrc/dd.cu", "lis_tpu/core/ddreal.py:218"),
    "dd_update": ("lis_tpu_torch/csrc/dd.cu", "lis_tpu/core/ddreal.py:196"),
}


def report_results(S, smi_line, total):
    """The kernels line (the f64 records), the card line and the last
    line."""
    import torch
    print(f"phase results: launches over the counted solves {total}",
          flush=True)
    print(json.dumps({"formats": S.format_rows}))
    rows = []
    for name, (src, tpu) in WHERE.items():
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": total[name],
                     **S.results[name]})
    print(json.dumps({"kernels": rows}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
