// Kernels B, C, D · the Benes shuffle passes of the CST SpMV.
//
// A Benes pass with digit d = 128 and stride s views the flat (M,) array
// as x[p, a, w] (p < M/(128 s), a < 128, w < s) and permutes a within
// every column (p, w):
//
//     out[p, a, w] = x[p, idx[p s + w, a], w]        idx: (M/128, 128) uint8
//
// B · benes_pass         replaces lis_tpu/ops/shuffle.py::_fused_pass32
//                        (pallas_call at :450 and :473)
// C · benes_pass_rowsum  replaces ::_fused_pass_rowsum32 (:544, :568)
// D · benes_small_run    replaces ::_fused_small32 (:652)
//
// Bound on the H100: bytes.  A pass reads 8 B of x (f64) and 1 B of idx
// and writes 8 B per slot; the row-sum pass writes 8/Kp B; a fused run of
// k passes pays one read and one write for all k.  The gathers themselves
// stay in shared memory, where their random lane order costs nothing in
// device-memory traffic.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// B and C: one block owns kRows consecutive idx rows r = p s + w.  When
// s >= kRows those rows share p and cover w0..w0+kRows-1, so the block's x
// tile is 128 strided runs of kRows contiguous values; when s < kRows they
// cover kRows/s whole (128, s) panels, one contiguous run.  Either way the
// tile lands in shared memory as xs[a][j] (j = r - r0), the idx rows as
// is[j][a], and the output is read back as xs[is[j][a]][j].
// ---------------------------------------------------------------------------
constexpr int kRows = 32;
constexpr int kThreads = 256;
constexpr int kIdxPitch = 132;      // bytes: 4-aligned, spreads the banks

// Global offset and tile coordinates of the e-th element of the tile.
// The element order makes consecutive e contiguous in memory.
__device__ __forceinline__ int64_t tile_elem(int e, int64_t r0, int ls,
                                             int& j, int& a) {
    if (ls >= 5) {                                  // s >= kRows
        a = e >> 5;
        j = e & (kRows - 1);
        const int64_t p = r0 >> ls;
        const int64_t w0 = r0 & ((int64_t(1) << ls) - 1);
        return (p << (ls + 7)) + ((int64_t)a << ls) + w0 + j;
    }
    const int pl = e >> (ls + 7);                   // panel within tile
    const int rem = e & ((128 << ls) - 1);
    a = rem >> ls;
    j = (pl << ls) + (rem & ((1 << ls) - 1));
    return r0 * 128 + e;
}

template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ x,
                                          const uint8_t* __restrict__ idx,
                                          int64_t r0, int ls,
                                          T (*xs)[kRows + 1],
                                          uint8_t (*is)[kIdxPitch]) {
    const uint32_t* ig = reinterpret_cast<const uint32_t*>(idx + r0 * 128);
    for (int e = threadIdx.x; e < kRows * 32; e += kThreads) {
        *reinterpret_cast<uint32_t*>(&is[e >> 5][(e & 31) * 4]) = ig[e];
    }
    for (int e = threadIdx.x; e < kRows * 128; e += kThreads) {
        int j, a;
        const int64_t off = tile_elem(e, r0, ls, j, a);
        xs[a][j] = x[off];
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
benes_pass_kernel(const T* __restrict__ x, const uint8_t* __restrict__ idx,
                  T* __restrict__ out, int ls) {
    __shared__ T xs[128][kRows + 1];
    __shared__ __align__(16) uint8_t is[kRows][kIdxPitch];
    const int64_t r0 = (int64_t)blockIdx.x * kRows;
    load_tile(x, idx, r0, ls, xs, is);
    __syncthreads();
    for (int e = threadIdx.x; e < kRows * 128; e += kThreads) {
        int j, a;
        const int64_t off = tile_elem(e, r0, ls, j, a);
        out[off] = xs[is[j][a]][j];
    }
}

// C: the same tile, then sums of Kp consecutive w of every (p, a).  The
// sum of the group starting at row r lands at y[F / Kp] with F the flat
// slot of (p, a, w).  Kp < kRows: a tile holds kRows/Kp whole groups per
// a.  Kp >= kRows: a block walks Kp/kRows tiles and thread a carries its
// running sum across them (summation order: w ascending, in runs of
// kRows).
template <typename T>
__global__ void __launch_bounds__(kThreads)
benes_pass_rowsum_kernel(const T* __restrict__ x,
                         const uint8_t* __restrict__ idx,
                         T* __restrict__ y, int ls, int lkp) {
    __shared__ T xs[128][kRows + 1];
    __shared__ __align__(16) uint8_t is[kRows][kIdxPitch];
    const int kp = 1 << lkp;
    const int ntile = kp > kRows ? kp / kRows : 1;
    const int64_t rb = (int64_t)blockIdx.x * kRows * ntile;
    const int64_t smask = (int64_t(1) << ls) - 1;
    T acc = T(0);
    for (int t = 0; t < ntile; ++t) {
        const int64_t r0 = rb + (int64_t)t * kRows;
        load_tile(x, idx, r0, ls, xs, is);
        __syncthreads();
        if (kp >= kRows) {
            if (threadIdx.x < 128) {
                const int a = threadIdx.x;
                T s = T(0);
                for (int j = 0; j < kRows; ++j) s += xs[is[j][a]][j];
                acc += s;
            }
        } else {
            const int gpt = kRows >> lkp;               // groups per a
            for (int o = threadIdx.x; o < 128 * gpt; o += kThreads) {
                const int a = o / gpt;
                const int j0 = (o % gpt) << lkp;
                T s = T(0);
                for (int jj = 0; jj < kp; ++jj) {
                    const int j = j0 + jj;
                    s += xs[is[j][a]][j];
                }
                const int64_t r = r0 + j0;
                const int64_t F = ((r >> ls) << (ls + 7))
                                  + ((int64_t)a << ls) + (r & smask);
                y[F >> lkp] = s;
            }
        }
        __syncthreads();
    }
    if (kp >= kRows && threadIdx.x < 128) {
        const int64_t F = ((rb >> ls) << (ls + 7))
                          + ((int64_t)threadIdx.x << ls) + (rb & smask);
        y[F >> lkp] = acc;
    }
}

// ---------------------------------------------------------------------------
// D: a run of passes with s in {1, 128} never moves a value out of its
// aligned 16384-slot tile T[a][w] (slot = b*16384 + a*128 + w).  An s = 1
// pass gathers within row a (T[a][w] <- T[a][idx[b*128+a][w]]), an
// s = 128 pass within column w (T[a][w] <- T[idx[b*128+w][a]][w]).
//
// Bound: bytes (one read of x, one of each pass's idx, one write).  The
// design keeps the memory pipe busy while the passes run out of shared
// memory:
//
// - a persistent grid, one block of 1024 threads per SM, walks tiles
//   b = blockIdx.x, blockIdx.x + gridDim.x, ...;
// - the tile is an unpadded 128 x 128 array brought in by bulk
//   asynchronous copies that report to an mbarrier.  There is one tile
//   buffer (an f64 tile is 128 KB): the next tile's load starts the
//   moment the last pass has read the tile, and overlaps that pass's
//   stores;
// - the idx bytes of the next kRunSlots passes (of this tile and the
//   next) sit in a ring in shared memory, filled by 4-byte cp.async into
//   rows of pitch 132 B, so the pass loop reads no global memory.  The
//   odd pitch lets a column pass read idx[w][a] with lanes along w without
//   a bank conflict;
// - in every pass warp q owns rows a = 4q .. 4q+3 and lane l the columns
//   w = l, l+32, l+64, l+96.  A thread gathers its 16 values into
//   registers (row pass: tile[a][idx[a][w]]; column pass:
//   tile[idx[w][a]][w], lanes on distinct banks), the block meets at one
//   barrier, and the values go back to tile[a][w].  The last pass does not
//   write back: its registers go straight to coalesced global stores, or
//   into the Kp row sums.
//
// Row sums: the Kp consecutive w of a group are summed as a pairwise tree
// over w (lanes at distance 1, 2, 4, ... by warp shuffles, then
// (k0 + k1) + (k2 + k3) over a lane's four columns for Kp = 64 and 128), a
// fixed order that differs from the plain version's.
// ---------------------------------------------------------------------------
constexpr int kRunThreads = 1024;
constexpr int kRunRows = 4;         // rows a per warp: 128 / 32 warps
constexpr int kRunSlots = 5;        // idx ring depth, in passes
constexpr int kTile = 16384;
constexpr int kRunPitch = 132;      // idx row pitch in the ring, bytes
constexpr int kRunSlotBytes = 128 * kRunPitch;
constexpr int kRunChunk = 16384;    // bytes per bulk copy
constexpr int kMaxRun = 8;

struct RunArgs {
    const uint8_t* idx[kMaxRun];
    int col[kMaxRun];               // 1: s = 128 (column pass), 0: s = 1
    int n;
};

// Dynamic shared memory of a run: the tile, the idx ring, the mbarrier.
template <typename T>
constexpr int kRunSmem = kTile * (int)sizeof(T) + kRunSlots * kRunSlotBytes
                         + 8;

// Row sums of a thread's last-pass values v[j][k] = T[a0 + j][lane + 32 k]
// into ob[(a * 128 + w) >> lkp] (ob: this tile's outputs).
template <typename T>
__device__ __forceinline__ void run_rowsum(const T (&v)[kRunRows][4],
                                           T* __restrict__ ob, int a0,
                                           int lane, int lkp) {
    const int span = lkp < 5 ? (1 << lkp) : 32;     // lanes per group
#pragma unroll
    for (int j = 0; j < kRunRows; ++j) {
        T r[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            T t = v[j][k];
            for (int d = 1; d < span; d <<= 1)
                t += __shfl_xor_sync(0xffffffffu, t, d);
            r[k] = t;
        }
        const int row = (a0 + j) * 128;
        if (lkp <= 5) {
            if ((lane & (span - 1)) == 0) {
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    ob[(row + lane + 32 * k) >> lkp] = r[k];
            }
        } else if (lane == 0) {
            if (lkp == 6) {
                ob[row >> 6] = r[0] + r[1];
                ob[(row >> 6) + 1] = r[2] + r[3];
            } else {
                ob[row >> 7] = (r[0] + r[1]) + (r[2] + r[3]);
            }
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kRunThreads, 1)
benes_small_run_kernel(const T* __restrict__ x,
                       const __grid_constant__ RunArgs run,
                       T* __restrict__ out, int lkp, int ntiles) {
    constexpr uint32_t kTileBytes = kTile * sizeof(T);
    extern __shared__ __align__(128) unsigned char smem[];
    T* tile = reinterpret_cast<T*>(smem);
    uint8_t* ring = smem + kTileBytes;
    uint64_t* bar = reinterpret_cast<uint64_t*>(ring
                                                + kRunSlots * kRunSlotBytes);

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int a0 = (tid >> 5) * kRunRows;
    const int n = run.n;
    const int step = gridDim.x;
    // tiles of this block: blockIdx.x + i * step, i < mine (grid <= ntiles)
    const int mine = (ntiles - (int)blockIdx.x + step - 1) / step;
    const int total = mine * n;         // pass instances q = i * n + p

    // Thread 0 arms the barrier and starts the bulk copies of this
    // block's i-th tile.
    auto load_tile = [&](int i) {
        const unsigned char* src = reinterpret_cast<const unsigned char*>(
            x + ((int64_t)blockIdx.x + (int64_t)i * step) * kTile);
        lis_mbar_expect_tx(bar, kTileBytes);
        for (uint32_t o = 0; o < kTileBytes; o += kRunChunk)
            lis_bulk_g2s(smem + o, src + o, kRunChunk, bar);
    };

    // Every thread copies its share of pass instance pf_q's idx tile into
    // ring slot pf_q % kRunSlots and commits one group (an empty one past
    // the end, so that the group count stays uniform).
    int pf_q = 0, pf_p = 0, pf_slot = 0;
    int64_t pf_tile = blockIdx.x;
    auto stage_idx = [&]() {
        if (pf_q < total) {
            const uint8_t* src = run.idx[pf_p] + pf_tile * kTile;
            uint8_t* dst = ring + pf_slot * kRunSlotBytes;
            for (int e = tid; e < kTile / 4; e += kRunThreads)
                lis_cp_async4(dst + (e >> 5) * kRunPitch + (e & 31) * 4,
                              src + e * 4);
            if (++pf_p == n) {
                pf_p = 0;
                pf_tile += step;
            }
        }
        ++pf_q;
        if (++pf_slot == kRunSlots) pf_slot = 0;
        lis_cp_async_commit();
    };

    if (tid == 0) {
        lis_mbar_init(bar, 1);
        lis_fence_mbar_init();
    }
    __syncthreads();
    if (tid == 0) load_tile(0);
    for (int q = 0; q < kRunSlots; ++q) stage_idx();

    int slot = 0;
    for (int i = 0; i < mine; ++i) {
        const int64_t b = (int64_t)blockIdx.x + (int64_t)i * step;
        for (int p = 0; p < n; ++p) {
            // this thread's copies of the pass's idx, and (first pass) the
            // tile; the barrier then makes every thread's copies visible
            // and orders the previous pass's write-back before the gather
            lis_cp_async_wait<kRunSlots - 1>();
            if (p == 0) lis_mbar_wait(bar, i & 1);
            __syncthreads();
            const uint8_t* is = ring + slot * kRunSlotBytes;
            T v[kRunRows][4];
            const bool last = p == n - 1;
            if (run.col[p]) {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int w = lane + 32 * k;
                    // idx[w][a0 .. a0+3] as one word
                    const uint32_t word = *reinterpret_cast<const uint32_t*>(
                        is + w * kRunPitch + a0);
#pragma unroll
                    for (int j = 0; j < kRunRows; ++j)
                        v[j][k] = tile[((word >> (8 * j)) & 255u) * 128 + w];
                }
            } else {
#pragma unroll
                for (int j = 0; j < kRunRows; ++j) {
                    const uint8_t* ia = is + (a0 + j) * kRunPitch;
                    const T* ta = tile + (a0 + j) * 128;
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        v[j][k] = ta[ia[lane + 32 * k]];
                }
            }
            // the tile's next contents arrive through the asynchronous
            // proxy: order this thread's accesses to the tile before it
            if (last) lis_fence_proxy_async();
            __syncthreads();        // every gather done: tile and slot free
            stage_idx();
            if (++slot == kRunSlots) slot = 0;
            if (!last) {
#pragma unroll
                for (int j = 0; j < kRunRows; ++j)
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        tile[(a0 + j) * 128 + lane + 32 * k] = v[j][k];
                continue;
            }
            if (tid == 0 && i + 1 < mine) load_tile(i + 1);
            if (lkp < 0) {
                T* ob = out + b * kTile;
#pragma unroll
                for (int j = 0; j < kRunRows; ++j)
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        ob[(a0 + j) * 128 + lane + 32 * k] = v[j][k];
            } else {
                run_rowsum<T>(v, out + b * (kTile >> lkp), a0, lane, lkp);
            }
        }
    }
}

template <typename T>
void launch_pass(const void* x, const void* idx, void* out, int64_t M,
                 int64_t s, cudaStream_t st) {
    const int64_t blocks = M / 128 / kRows;
    benes_pass_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const uint8_t*>(idx),
        static_cast<T*>(out), lis_ilog2(s));
}

template <typename T>
void launch_rowsum(const void* x, const void* idx, void* y, int64_t M,
                   int64_t s, int64_t kp, cudaStream_t st) {
    const int64_t rows_per_block = kp > kRows ? kp : kRows;
    const int64_t blocks = M / 128 / rows_per_block;
    benes_pass_rowsum_kernel<T><<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const uint8_t*>(idx),
        static_cast<T*>(y), lis_ilog2(s), lis_ilog2(kp));
}

// Kernel D's launch geometry: one persistent block per SM, and the
// opt-in to its dynamic shared memory, both set once per device and type.
template <typename T>
int run_grid_limit() {
    static int sms[64];
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < 0 || dev >= 64) return 0;
    if (sms[dev] == 0) {
        int count = 0;
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
        if (cudaFuncSetAttribute(benes_small_run_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kRunSmem<T>) != cudaSuccess)
            return 0;
        sms[dev] = count;
    }
    return sms[dev];
}

// Returns the error of the set-up or of the launch.
template <typename T>
cudaError_t launch_run(const void* x, const RunArgs& run, void* out,
                       int64_t M, int lkp, cudaStream_t st) {
    const int64_t ntiles = M / kTile;
    const int limit = run_grid_limit<T>();
    if (limit <= 0) {
        const cudaError_t e = cudaGetLastError();
        return e != cudaSuccess ? e : cudaErrorInvalidDevice;
    }
    const unsigned grid = (unsigned)(ntiles < limit ? ntiles : limit);
    benes_small_run_kernel<T><<<grid, kRunThreads, kRunSmem<T>,
                                st>>>(static_cast<const T*>(x), run,
                                      static_cast<T*>(out), lkp,
                                      (int)ntiles);
    return cudaGetLastError();
}

}  // namespace

// x, out (M,); idx (M/128, 128).  s is a power of two, M/128 a multiple
// of 32.
LIS_EXPORT int lis_benes_pass(int dtype, const void* x, const void* idx,
                              void* out, int64_t M, int64_t s,
                              void* stream) {
    LIS_DISPATCH(dtype, launch_pass, x, idx, out, M, s,
                 static_cast<cudaStream_t>(stream));
}

// y (M/Kp,).  Kp is a power of two dividing s; M/128 a multiple of
// max(32, Kp).
LIS_EXPORT int lis_benes_pass_rowsum(int dtype, const void* x,
                                     const void* idx, void* y, int64_t M,
                                     int64_t s, int64_t kp, void* stream) {
    LIS_DISPATCH(dtype, launch_rowsum, x, idx, y, M, s, kp,
                 static_cast<cudaStream_t>(stream));
}

// idxs: host array of n device pointers (each (M/128, 128)); ss: host
// array of n strides, each 1 or 128; lkp = log2(Kp) or -1 for no row sum.
// M is a multiple of 16384 below 2^45.
LIS_EXPORT int lis_benes_small_run(int dtype, const void* x,
                                   const void* idxs, const void* ss, int n,
                                   void* out, int64_t M, int lkp,
                                   void* stream) {
    if (n < 1 || n > kMaxRun || lkp > 7 || M < kTile || M % kTile
        || M / kTile > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    RunArgs run{};
    for (int i = 0; i < n; ++i) {
        const int s = static_cast<const int*>(ss)[i];
        if (s != 1 && s != 128) return (int)cudaErrorInvalidValue;
        run.idx[i] = static_cast<const uint8_t* const*>(idxs)[i];
        run.col[i] = s == 128;
    }
    run.n = n;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)launch_run<float>(x, run, out, M, lkp, st);
    if (dtype == 1) return (int)launch_run<double>(x, run, out, M, lkp, st);
    return (int)cudaErrorInvalidValue;
}
