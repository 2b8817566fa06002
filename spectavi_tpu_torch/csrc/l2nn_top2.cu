// Exact top-2 squared-L2 nearest neighbours of byte descriptors.
//
// Replaces spectavi_tpu/ops/l2nn_pallas.py::l2_topk2_pallas (kernel body
// _fused_kernel): for every query row y_j of Y (Y, D) it returns the two
// database rows of X (X, D) with the smallest squared L2 distance, in
// ascending order of (distance, index), so ties go to the lower index.
// Inputs are int8 or uint8; accumulation is int32 and the result is
// bit-exact.
//
// What bounds it on an H100: operations, of two kinds.  The work is
// 2*X*Y*D int8 multiply-adds against X*D + Y*D input bytes (28k x 28k x
// 144: 226 Gop on ~8 MB), far above the card's ops:byte ridge, and
// behind every product row stands one candidate (query, database row)
// that has to pass the top-2 filter on the CUDA cores: X*Y candidates at
// ~3 integer operations each.  Measured at X = Y = 28000, D = 144 on
// an H100 80GB HBM3 at 700 W: the wgmma pipeline alone (filter cut out)
// 0.161 ms, which is the tensor cores' rate at this grid's 83% fill; the
// filter alone (wgmma cut out) 0.16-0.30 ms depending on its form; both
// together 0.313 ms.  The two overlap only in part: 384 integer
// operations a tile that touch no accumulator, started while the
// warpgroup's own wgmma ran, still added 0.21 ms to 0.161 ms where they
// cost 0.28 ms alone.  So the kernel is bound by tensor-core time plus
// most of the filter's own time.
//
// Design of the tensor-core route (D padded to KB <= 256 bytes):
//  * products on the int8 tensor cores: wgmma.mma_async m64n128k32 with
//    s32 accumulators, both operands K-major in shared memory.  uint8
//    input uses the .u8.u8 form on the raw bytes, int8 the .s8.s8 form:
//    no conversion touches the data, and d2 = yy - 2 y.x + xx with the
//    norms of the raw values is the same integer either way;
//  * a first small kernel (make_tiles) writes both matrices once more in
//    the layout the tensor cores read: tiles of 128 rows stored
//    [16-byte K chunk][row][16 bytes] over KB bytes (the no-swizzle
//    core-matrix layout of wgmma: 8 rows x 16 bytes contiguous, the next
//    8 rows 128 bytes on, the next K chunk 2048 bytes on), zeros past D
//    and past the last row (they add 0 to every product and norm), and
//    the rows' norms behind them.  A tile is then one contiguous block
//    that a single bulk copy (cp.async.bulk, completion on an mbarrier)
//    brings into shared memory.  The first version filled the same
//    layout with 16-byte cp.async copies straight from the row-major
//    input: a warp's copy touched 32 rows, and the kernel took 0.567 ms;
//  * queries on M, database on N.  A block of two consumer warpgroups
//    (64 queries each) and one producer warp keeps its 128 queries in
//    shared memory for the whole kernel; database tiles stream through a
//    ring of 4 stages with a full and an empty mbarrier each.  The k32
//    steps of a tile are a template parameter, so its wgmmas go out back
//    to back (a runtime loop made the compiler fence between them);
//  * 105 KB of shared memory and 96 registers put two blocks (four
//    consumer warpgroups) on an SM, so one warpgroup's filter runs
//    beside another's wgmma.  Two accumulator sets in one warpgroup
//    (the next tile's wgmma in flight during the filter, one block an
//    SM) measured 0.418 ms, and warpgroups taking turns at the tensor
//    cores through named barriers 0.336 ms against 0.323 ms without;
//  * the filter works in the accumulator's register layout: a thread
//    holds 2 query rows x 32 database columns of a tile and keeps a
//    running (best, second) per row on the key xx - 2 y.x (yy is added
//    at the end).  A thread meets its candidates in ascending index, so
//    a strict < keeps ties on the lower index; four candidates a lane
//    are tested against a threshold with one warp-wide branch, which is
//    rarely taken.  After each tile the threshold drops to the
//    second-best key the 4 lanes that share a row have seen together
//    (0.314 against 0.338 ms).  A first pass of one add-and-max
//    (__viaddmax_s32) a candidate before the exact test measured 0.303
//    against 0.314 ms over 2 groups of 4 and 0.321 to 0.447 ms over 4
//    to 16, and was left out.  At the end those 4 lanes merge by
//    shuffles under the total order (key, index): the result does not
//    depend on the schedule.  The (Y, X) distance matrix never reaches
//    device memory.
//
// Larger D (KB > 256: the resident query tile and the ring no longer
// fit) runs the CUDA-core route at the end of this file, products with
// __dp4a on values shifted by -128 (that route took 5.74 ms at the shape
// above).  The route is chosen by the shape alone.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int INF = 0x7fffffff;

__device__ __forceinline__ bool less(int d, int i, int bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

__device__ __forceinline__ void insert(int d, int i, int& d1, int& i1, int& d2, int& i2) {
  if (less(d, i, d1, i1)) {
    d2 = d1; i2 = i1; d1 = d; i1 = i;
  } else if (less(d, i, d2, i2)) {
    d2 = d; i2 = i;
  }
}

// byte as the int8 value the CUDA-core route works on: uint8 shifted by -128
__device__ __forceinline__ int load_byte(const uint8_t* __restrict__ p, int is_u8) {
  int v = (int)(*p);
  return is_u8 ? v - 128 : (int)(int8_t)(uint8_t)v;
}

// one warp per row of X, then of Y: squared norms of the shifted values
__global__ void row_norms(const uint8_t* __restrict__ x, int X, const uint8_t* __restrict__ y,
                          int Y, int D, int is_u8, int* __restrict__ xx,
                          int* __restrict__ yy) {
  int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (warp >= X + Y) return;
  const bool is_x = warp < X;
  const int row = is_x ? warp : warp - X;
  const uint8_t* p = (is_x ? x : y) + (size_t)row * D;
  int s = 0;
  for (int c = lane; c < D; c += 32) {
    int v = load_byte(p + c, is_u8);
    s += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if (lane == 0) (is_x ? xx : yy)[row] = s;
}

// ---------------------------------------------------------------------
// tensor-core route
// ---------------------------------------------------------------------

constexpr int TR = 128;       // rows of a tile: queries per block (64 per
                              // warpgroup) and database rows per step (the wgmma N)
constexpr int STAGES = 4;
constexpr int NT_TC = 288;    // two consumer warpgroups and one producer warp
constexpr int KB_MAX = 256;

// bytes of one tile: TR rows of KB bytes, then their TR norms
__host__ __device__ constexpr int tile_bytes(int KB) { return TR * KB + TR * 4; }

// Tiles of a (rows, D) byte matrix as the main kernel wants them in
// shared memory, so that one bulk copy brings a tile in: tile i holds
// rows [128 i, 128 i + 128) as [16-byte K chunk][row][16 bytes] over KB
// bytes (zeros past D and past the last row), then the rows' norms (INF
// past the last row: such a row beats nothing).  One warp per row, one
// lane per chunk.
__global__ void make_tiles(const uint8_t* __restrict__ x, int X, int xtiles,
                           const uint8_t* __restrict__ y, int Y, int ytiles, int D, int KB,
                           int is_u8, uint8_t* __restrict__ xt, uint8_t* __restrict__ yt) {
  int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const bool is_x = warp < xtiles * TR;
  if (!is_x) warp -= xtiles * TR;
  if (!is_x && warp >= ytiles * TR) return;
  const uint8_t* src = is_x ? x : y;
  const int rows = is_x ? X : Y;
  uint8_t* tile = (is_x ? xt : yt) + (size_t)(warp / TR) * tile_bytes(KB);
  const int r = warp % TR;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (warp < rows && 16 * lane < D)
    v = *reinterpret_cast<const uint4*>(src + (size_t)warp * D + 16 * lane);
  int s = 0;
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int u = (int)((w[i] >> (8 * b)) & 0xffu);
      const int e = is_u8 ? u : (int)(int8_t)(uint8_t)u;
      s += e * e;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if (16 * lane < KB) *reinterpret_cast<uint4*>(tile + (lane * TR + r) * 16) = v;
  if (lane == 0) reinterpret_cast<int*>(tile + TR * KB)[r] = warp < rows ? s : INF;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// waits until the barrier's phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// bulk copy of `bytes` contiguous bytes into shared memory; completion
// counts on the barrier, which is told to expect them first
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// shared-memory matrix descriptor, no swizzle, K-major: lbo = bytes
// between the two 16-byte K chunks of a k32 step, sbo = bytes between
// groups of 8 rows
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

#define ACC4(d, i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define ACC16(d, i) ACC4(d, i), ACC4(d, i + 4), ACC4(d, i + 8), ACC4(d, i + 12)
#define ACC64(d) ACC16(d, 0), ACC16(d, 16), ACC16(d, 32), ACC16(d, 48)
#define WGMMA_N128(types)                                              \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                         \
  "wgmma.mma_async.sync.aligned.m64n128k32.s32." types " "             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                                  \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                             \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                           \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                           \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                           \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                           \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                           \
  "%56, %57, %58, %59, %60, %61, %62, %63}, "                          \
  "%64, %65, p;\n}\n"

// d (64 x 128, s32) = or += A (64 x 32 bytes) . B (128 x 32 bytes)^T
template <bool U8>
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  if (U8) {
    asm volatile(WGMMA_N128("u8.u8") : ACC64(d) : "l"(da), "l"(db), "r"(accumulate));
  } else {
    asm volatile(WGMMA_N128("s8.s8") : ACC64(d) : "l"(da), "l"(db), "r"(accumulate));
  }
}

// candidate (key k, index i) of a thread that meets its candidates in
// ascending index: strict < leaves ties with the earlier, lower index
__device__ __forceinline__ void push(int k, int i, int& k1, int& i1, int& k2, int& i2) {
  if (k < k2) {
    if (k < k1) {
      k2 = k1; i2 = i1; k1 = k; i1 = i;
    } else {
      k2 = k; i2 = i;
    }
  }
}

// running top-2 of a thread's two query rows (h = 0: row lane / 4 of
// the warp's 16, h = 1: that row + 8) over the columns it has met
struct Top2 {
  int k1[2], i1[2], k2[2], i2[2];
  int thr[2];  // key a candidate of the row has to beat to matter
};

// One tile's accumulators through the filter.  d[4j + 2h + e] is query
// row h, database column 8j + 2 quad + e of the tile; n points at the
// tile's norms, col0 is the tile's first database row.
__device__ __forceinline__ void filter_tile(const int (&d)[64], const int* n, int col0,
                                            int quad, Top2& b) {
  n += 2 * quad;
#pragma unroll
  for (int j = 0; j < TR / 8; ++j) {
    const int2 xn = *reinterpret_cast<const int2*>(n + 8 * j);
    const int a0 = (int)((unsigned)xn.x - 2u * (unsigned)d[4 * j]);
    const int a1 = (int)((unsigned)xn.y - 2u * (unsigned)d[4 * j + 1]);
    const int b0 = (int)((unsigned)xn.x - 2u * (unsigned)d[4 * j + 2]);
    const int b1 = (int)((unsigned)xn.y - 2u * (unsigned)d[4 * j + 3]);
    // one warp-wide branch for 4 candidates a lane; rarely taken
    const bool hit = a0 < b.thr[0] || a1 < b.thr[0] || b0 < b.thr[1] || b1 < b.thr[1];
    if (__builtin_expect(__any_sync(0xffffffffu, hit), 0)) {
      const int c = col0 + 2 * quad + 8 * j;
      push(a0, c, b.k1[0], b.i1[0], b.k2[0], b.i2[0]);
      push(a1, c + 1, b.k1[0], b.i1[0], b.k2[0], b.i2[0]);
      push(b0, c, b.k1[1], b.i1[1], b.k2[1], b.i2[1]);
      push(b1, c + 1, b.k1[1], b.i1[1], b.k2[1], b.i2[1]);
      b.thr[0] = min(b.thr[0], b.k2[0]);
      b.thr[1] = min(b.thr[1], b.k2[1]);
    }
  }
  // tighten the thresholds to the second-best key the whole quad has
  // seen for the row.  A later candidate with an equal key has a higher
  // index than that one, so a strict < stays exact
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int m1 = b.k1[h], m2 = b.k2[h];
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const int o1 = __shfl_xor_sync(0xffffffffu, m1, o);
      const int o2 = __shfl_xor_sync(0xffffffffu, m2, o);
      m2 = min(max(m1, o1), min(m2, o2));
      m1 = min(m1, o1);
    }
    b.thr[h] = min(b.thr[h], m2);
  }
}

// KSTEPS: k32 steps of a row, KB / 32; a template parameter so that a
// tile's wgmmas go out back to back with nothing between them
template <bool U8, int KSTEPS>
__global__ void __launch_bounds__(NT_TC, 2) top2_wgmma_kernel(
    const uint8_t* __restrict__ xt, const uint8_t* __restrict__ yt, int X, int Y,
    int* __restrict__ out_idx, int* __restrict__ out_dist) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int KB = 32 * KSTEPS;
  constexpr int tb = tile_bytes(KB);
  uint8_t* sQ = smem;             // the block's query tile
  uint8_t* sX = smem + tb;        // STAGES database tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(sX + STAGES * tb);
  const uint32_t bar_q = smem_u32(bars);
  const uint32_t bar_full = smem_u32(bars + 1);
  const uint32_t bar_empty = smem_u32(bars + 1 + STAGES);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ntiles = (X + TR - 1) / TR;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      bulk_load(smem_u32(sQ), yt + (size_t)blockIdx.x * tb, tb, bar_q);
      for (int t = 0; t < ntiles; ++t) {
        const int st = t % STAGES;
        mbar_wait(bar_empty + 8 * st, ((t / STAGES) & 1) ^ 1);
        bulk_load(smem_u32(sX + st * tb), xt + (size_t)t * tb, tb, bar_full + 8 * st);
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const int quad = lane & 3;
  Top2 best;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    best.k1[h] = INF; best.i1[h] = INF; best.k2[h] = INF; best.i2[h] = INF; best.thr[h] = INF;
  }
  const uint64_t descA = smem_desc(smem_u32(sQ) + wg * 64 * 16, TR * 16, 128);

  int d[64];
  mbar_wait(bar_q, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int st = t % STAGES;
    mbar_wait(bar_full + 8 * st, (t / STAGES) & 1);
    const uint64_t descB = smem_desc(smem_u32(sX + st * tb), TR * 16, 128);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      // a k32 step is two K chunks: 2 * TR * 16 bytes, in 16-byte units
      wgmma_m64n128k32<U8>(d, descA + (uint64_t)(s * 2 * TR), descB + (uint64_t)(s * 2 * TR),
                           s > 0);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    // no read of d may move above the wait
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
    filter_tile(d, reinterpret_cast<const int*>(sX + st * tb + TR * KB), t * TR, quad, best);
    // this warp is done with the stage: its wgmma has completed and its
    // lanes have read the norms
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * st);
  }

  // the 4 lanes of a quad hold disjoint columns of the same rows: merge
  // under the total order (key, index)
  const int* yn = reinterpret_cast<const int*>(sQ + TR * KB);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int k1 = best.k1[h], i1 = best.i1[h], k2 = best.k2[h], i2 = best.i2[h];
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const int ok1 = __shfl_xor_sync(0xffffffffu, k1, o);
      const int oi1 = __shfl_xor_sync(0xffffffffu, i1, o);
      const int ok2 = __shfl_xor_sync(0xffffffffu, k2, o);
      const int oi2 = __shfl_xor_sync(0xffffffffu, i2, o);
      insert(ok1, oi1, k1, i1, k2, i2);
      insert(ok2, oi2, k1, i1, k2, i2);
    }
    const int ql = wg * 64 + (warp & 3) * 16 + (lane >> 2) + 8 * h;
    const int q = blockIdx.x * TR + ql;
    if (quad == 0 && q < Y) {
      const int yq = yn[ql];
      out_idx[2 * q] = i1;
      out_idx[2 * q + 1] = i2;
      out_dist[2 * q] = k1 + yq;
      out_dist[2 * q + 1] = k2 + yq;
    }
  }
}

template <bool U8, int KSTEPS>
cudaError_t launch_wgmma(const uint8_t* xt, const uint8_t* yt, int X, int Y, int* out_idx,
                         int* out_dist, cudaStream_t s) {
  const int smem = (1 + STAGES) * tile_bytes(32 * KSTEPS) + (1 + 2 * STAGES) * 8;
  cudaError_t e = cudaFuncSetAttribute(top2_wgmma_kernel<U8, KSTEPS>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  top2_wgmma_kernel<U8, KSTEPS><<<(Y + TR - 1) / TR, NT_TC, smem, s>>>(xt, yt, X, Y, out_idx,
                                                                       out_dist);
  return cudaGetLastError();
}

template <bool U8>
cudaError_t launch_wgmma_ksteps(int ksteps, const uint8_t* xt, const uint8_t* yt, int X, int Y,
                                int* out_idx, int* out_dist, cudaStream_t s) {
  switch (ksteps) {
#define CASE(K) case K: return launch_wgmma<U8, K>(xt, yt, X, Y, out_idx, out_dist, s)
    CASE(1); CASE(2); CASE(3); CASE(4); CASE(5); CASE(6); CASE(7); CASE(8);
#undef CASE
  }
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------
// CUDA-core route (any D)
// ---------------------------------------------------------------------
//  * one block per tile of 64 queries; 256 threads, each owning a 4x4
//    (query, database row) micro-tile; database tiles of 64 rows and D
//    in chunks of 128 bytes stream through shared memory (row stride 33
//    words, so the 16 database rows a warp reads fall in 16 banks);
//  * each thread keeps a running (best, second) per query in registers
//    under the total order (d2, idx); the 16 partial lists of a query
//    are merged in shared memory at the end under the same order.

constexpr int TQ = 64;        // queries per block
constexpr int TX = 64;        // database rows per tile
constexpr int DW = 32;        // 4-byte words per D chunk (128 bytes)
constexpr int STRIDE = DW + 1;
constexpr int NT = 256;

// word w of row r, columns [c0 + 4w, c0 + 4w + 4), zero-padded past D / rows
__device__ __forceinline__ int load_word(const uint8_t* __restrict__ base, int rows,
                                         int D, int r, int c, int is_u8) {
  if (r >= rows) return 0;
  const uint8_t* p = base + (size_t)r * D;
  uint32_t w = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int col = c + k;
    int v = col < D ? load_byte(p + col, is_u8) : 0;
    w |= ((uint32_t)(v & 0xff)) << (8 * k);
  }
  return (int)w;
}

__global__ void __launch_bounds__(NT) top2_dp4a_kernel(
    const uint8_t* __restrict__ x, const uint8_t* __restrict__ y, int X, int Y, int D,
    int is_u8, const int* __restrict__ xx, const int* __restrict__ yy,
    int* __restrict__ out_idx, int* __restrict__ out_dist) {
  __shared__ int sQ[TQ * STRIDE];
  __shared__ int sX[TX * STRIDE];
  __shared__ int sD[TQ][16][2];
  __shared__ int sI[TQ][16][2];

  const int tid = threadIdx.x;
  const int ty = tid / 16;   // queries ty*4 .. ty*4+3 of the tile
  const int tx = tid % 16;   // database rows tx + 16*j of each tile
  const int q0 = blockIdx.x * TQ;

  int b1d[4], b1i[4], b2d[4], b2i[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) { b1d[a] = INF; b1i[a] = INF; b2d[a] = INF; b2i[a] = INF; }

  int yq[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    int q = q0 + ty * 4 + a;
    yq[a] = q < Y ? yy[q] : 0;
  }

  for (int x0 = 0; x0 < X; x0 += TX) {
    int acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0;

    for (int c0 = 0; c0 < D; c0 += 4 * DW) {
      const int nw = min(DW, (D - c0 + 3) / 4);  // words of this chunk holding data
      __syncthreads();
      for (int e = tid; e < TQ * nw; e += NT) {
        int r = e / nw, w = e % nw;
        sQ[r * STRIDE + w] = load_word(y, Y, D, q0 + r, c0 + 4 * w, is_u8);
        sX[r * STRIDE + w] = load_word(x, X, D, x0 + r, c0 + 4 * w, is_u8);
      }
      __syncthreads();
#pragma unroll 4
      for (int w = 0; w < nw; ++w) {
        int qv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) qv[a] = sQ[(ty * 4 + a) * STRIDE + w];
#pragma unroll
        for (int b = 0; b < 4; ++b) xv[b] = sX[(tx + 16 * b) * STRIDE + w];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = __dp4a(qv[a], xv[b], acc[a][b]);
      }
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      int r = x0 + tx + 16 * b;
      if (r < X) {
        int xn = xx[r];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          int dd = yq[a] - 2 * acc[a][b] + xn;
          insert(dd, r, b1d[a], b1i[a], b2d[a], b2i[a]);
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    int ql = ty * 4 + a;
    sD[ql][tx][0] = b1d[a]; sI[ql][tx][0] = b1i[a];
    sD[ql][tx][1] = b2d[a]; sI[ql][tx][1] = b2i[a];
  }
  __syncthreads();
  if (tid < TQ) {
    int q = q0 + tid;
    if (q < Y) {
      int d1 = INF, i1 = INF, d2 = INF, i2 = INF;
      for (int t = 0; t < 16; ++t)
        for (int s = 0; s < 2; ++s) insert(sD[tid][t][s], sI[tid][t][s], d1, i1, d2, i2);
      out_idx[2 * q] = i1;
      out_idx[2 * q + 1] = i2;
      out_dist[2 * q] = d1;
      out_dist[2 * q + 1] = d2;
    }
  }
}

}  // namespace

// bytes of scratch the tensor-core route needs for its tiles
extern "C" long long l2nn_top2_scratch_bytes(int X, int Y, int D) {
  const int KB = (D + 31) / 32 * 32;
  return (long long)((X + TR - 1) / TR + (Y + TR - 1) / TR) * tile_bytes(KB);
}

// route 1: tensor cores (D a multiple of 16, at most 256; x and y
// 16-byte aligned; scratch of l2nn_top2_scratch_bytes); route 0: CUDA
// cores (any D; scratch of X + Y ints)
extern "C" int l2nn_top2(const void* x, const void* y, int X, int Y, int D, int is_u8,
                         int route, void* scratch, void* out_idx, void* out_dist,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* xb = (const uint8_t*)x;
  const uint8_t* yb = (const uint8_t*)y;
  if (route == 1) {
    if (D % 16 != 0 || D > KB_MAX) return (int)cudaErrorInvalidValue;
    const int KB = (D + 31) / 32 * 32;
    const int xtiles = (X + TR - 1) / TR, ytiles = (Y + TR - 1) / TR;
    uint8_t* xt = (uint8_t*)scratch;
    uint8_t* yt = xt + (size_t)xtiles * tile_bytes(KB);
    make_tiles<<<((xtiles + ytiles) * TR * 32 + 255) / 256, 256, 0, s>>>(
        xb, X, xtiles, yb, Y, ytiles, D, KB, is_u8, xt, yt);
    return (int)(is_u8 ? launch_wgmma_ksteps<true>(KB / 32, xt, yt, X, Y, (int*)out_idx,
                                                   (int*)out_dist, s)
                       : launch_wgmma_ksteps<false>(KB / 32, xt, yt, X, Y, (int*)out_idx,
                                                    (int*)out_dist, s));
  }
  int* xx = (int*)scratch;
  int* yy = xx + X;
  row_norms<<<((X + Y) * 32 + 255) / 256, 256, 0, s>>>(xb, X, yb, Y, D, is_u8, xx, yy);
  top2_dp4a_kernel<<<(Y + TQ - 1) / TQ, NT, 0, s>>>(xb, yb, X, Y, D, is_u8, xx, yy,
                                                  (int*)out_idx, (int*)out_dist);
  return (int)cudaGetLastError();
}
