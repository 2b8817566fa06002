// Exact top-2 squared-L2 nearest neighbours of byte descriptors.
//
// Replaces spectavi_tpu/ops/l2nn_pallas.py::l2_topk2_pallas (kernel body
// _fused_kernel): for every query row y_j of Y (Y, D) it returns the two
// database rows of X (X, D) with the smallest squared L2 distance, in
// ascending order of (distance, index), so ties go to the lower index.
// Inputs are int8, or uint8 shifted by -128 (the shift cancels in every
// distance); accumulation is int32 and the result is bit-exact.
//
// What bounds it on an H100: operations.  The work is 2*X*Y*D int8
// multiply-adds against X*D + Y*D input bytes (28k x 28k x 144: 226 Gop
// on ~8 MB), far above the card's ops:byte ridge.  This first version
// runs the products on the CUDA cores with __dp4a (4 int8 MACs per
// instruction), not on the int8 tensor cores, so it sits well above the
// tensor-core bound; the next step is mma.sync/wgmma s8.
//
// Design:
//  * one block per tile of 64 queries; 256 threads, each owning a 4x4
//    (query, database row) micro-tile; database tiles of 64 rows and D
//    in chunks of 128 bytes stream through shared memory (row stride 33
//    words, so the 16 database rows a warp reads fall in 16 banks);
//  * the Pallas packed key 256*d2 + row8 (an int32 trick that capped D
//    at 168) is gone: (d2, idx) stay unpacked, so any D is exact while
//    D*255^2 < 2^31;
//  * each thread keeps a running (best, second) per query in registers
//    under the total order (d2, idx); the 16 partial lists of a query
//    are merged in shared memory at the end under the same order, so the
//    result does not depend on which thread saw which row.  The (Y, X)
//    distance matrix never reaches device memory;
//  * row norms ||x||^2 and ||y||^2 come from a small first kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;        // queries per block
constexpr int TX = 64;        // database rows per tile
constexpr int DW = 32;        // 4-byte words per D chunk (128 bytes)
constexpr int STRIDE = DW + 1;
constexpr int NT = 256;
constexpr int INF = 0x7fffffff;

__device__ __forceinline__ int load_byte(const uint8_t* __restrict__ p, int is_u8) {
  int v = (int)(*p);
  return is_u8 ? v - 128 : (int)(int8_t)(uint8_t)v;
}

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

__global__ void row_norms(const uint8_t* __restrict__ a, int rows, int D, int is_u8,
                          int* __restrict__ out) {
  int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (warp >= rows) return;
  const uint8_t* p = a + (size_t)warp * D;
  int s = 0;
  for (int c = lane; c < D; c += 32) {
    int v = load_byte(p + c, is_u8);
    s += v * v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if (lane == 0) out[warp] = s;
}

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

__global__ void __launch_bounds__(NT) top2_kernel(
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
          int d = yq[a] - 2 * acc[a][b] + xn;
          insert(d, r, b1d[a], b1i[a], b2d[a], b2i[a]);
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

extern "C" int l2nn_top2(const void* x, const void* y, int X, int Y, int D, int is_u8,
                         void* xx, void* yy, void* out_idx, void* out_dist, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* xb = (const uint8_t*)x;
  const uint8_t* yb = (const uint8_t*)y;
  row_norms<<<(X * 32 + 255) / 256, 256, 0, s>>>(xb, X, D, is_u8, (int*)xx);
  row_norms<<<(Y * 32 + 255) / 256, 256, 0, s>>>(yb, Y, D, is_u8, (int*)yy);
  top2_kernel<<<(Y + TQ - 1) / TQ, NT, 0, s>>>(xb, yb, X, Y, D, is_u8, (const int*)xx,
                                             (const int*)yy, (int*)out_idx, (int*)out_dist);
  return (int)cudaGetLastError();
}
