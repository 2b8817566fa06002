// SIFT descriptors (vlfeat 4x4x8) with normalization and uint8 output,
// one block per (keypoint, angle) row, one warp per spatial cell.
//
// Replaces spectavi_tpu/ops/sift_desc.py::sift_descriptors_pallas (kernel
// body _desc_kernel), with finish_descriptors and the min(floor(512 d),
// 255) step of features/sift.py::_describe_jobs_dev fused in.  For row k
// on level l of one octave's gradient images mod, ang (L, H, W): pixels of
// the square window of radius R centred on round(kp), clipped to the
// octave, with offsets rotated by theta0 and scaled by SBP = magnif sigma;
// Gaussian window of sigma 2 SBP; box |dx|, |dy| <= 2.5 sqrt(2) SBP + 0.5;
// bilinear spatial bins at centres -1.5..1.5; 8 circular orientation bins
// with linear interpolation; layout desc[(by*4+bx)*8+o].  Then normalize,
// clamp at 0.2, renormalize, quantize.  Invalid rows give zeros.  Unlike
// the Pallas kernel, whose 104x256 patch caps the window at 43.7 px, this
// reads the exact window of the plain route (features/sift.py::descriptors,
// radius 49 px).
//
// What bounds it on an H100: by the count of bytes it is a memory-bound
// function (one window of two float levels per row, <= 80 KB, mostly
// shared with neighbouring rows through L2), but what it spends is
// CUDA-core dispatch slots per visited (pixel, cell) pair: offsets,
// rotation, the bilinear weights, the Gaussian window and the two bin
// updates, ~60 operations, of which fewer than half the lanes do
// useful work (the rotated support fills 50-100% of its box).  With both
// loads replaced by constants the kernel was 15% faster (0.328 against
// 0.385 ms, 10663 rows of octave -1, H100 80GB HBM3 at 700 W), so the
// memory side is not what holds it.
//
// Design:
//  * a pixel's trilinear weight is nonzero in at most 2 x 2 x 2 of the
//    128 bins, so work follows the pixel's bins.  A warp owns a spatial
//    cell (by, bx) (4 warps take 4 cells each; 8 and 16 warps a row
//    measured within 3% of that) and walks only the axis-aligned
//    bounding box of the cell's support |nx - cx| < 1, |ny - cy| < 1: a
//    square of side 2 SBP rotated by theta0, so the box has half-side
//    SBP (|cos| + |sin|) around the rotated cell centre
//    (ops/sift_desc.py::cell_boxes is the same formula in PyTorch),
//    intersected with the row's window and the octave: ~6 SBP^2 pixels
//    a cell against ~50 SBP^2 in the window, each pixel visited by the
//    <= 4 cells it touches and not by 128 bins;
//  * lanes take the box's pixels in raster order, lane-strided; a lane
//    adds c wy wx (1 - f) and c wy wx f to bins floor(nt) and
//    floor(nt) + 1 mod 8 of its own 8 bins, which live in shared memory
//    ([bin][lane], conflict-free) because the bin index is dynamic:
//    keeping them in registers costs 16 compares and 16 selects a pixel
//    and measured 0.529 ms against 0.433 ms.  The 8 sums are reduced
//    over the warp by a fixed xor-shuffle tree.  Every bin has one
//    summation order: no float atomics, two launches give the same
//    bytes;
//  * mod and ang are read straight from device memory through L1/L2: the
//    boxes of neighbouring cells and rows overlap.  A window staged in
//    shared memory (up to 2 x 39 KB a row) was not built: the ablation
//    above caps its gain at 15%, and it would cut the rows in flight on
//    an SM;
//  * 128 threads, 51 registers and 4.6 KB of shared memory a block.
//    Capping the registers for 12 or 16 blocks an SM was slower (0.430
//    and 0.435 ms), and so was packing the pixels inside the support
//    through a shared-memory ring so that the costly part runs on full
//    warps (0.455 ms): the kernel is short of dispatch slots, not of warps
//    to hide latency.  The L2 norms are block reductions over a fixed
//    tree;
//  * compiled with -fmad=false like the other float kernel; sums and
//    products round as the plain PyTorch version's do, but divisions by
//    per-row values are multiplications by their reciprocals.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 4;  // warps a block: each takes 4 of the 16 cells
constexpr float TWO_PI_F = 6.283185307179586f;
constexpr float SQRT2_F = 1.4142135623730951f;

// torch.remainder(a, b) for b > 0; |a| < b in all but degenerate input
__device__ __forceinline__ float remainder_f(float a, float b) {
  float r = fabsf(a) < b ? a : fmodf(a, b);
  if (r < 0.0f) r += b;
  return r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum of v over the block's 4 warps; all threads call
__device__ float block_sum(float v, float* s_red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = ((s_red[0] + s_red[1]) + s_red[2]) + s_red[3];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(NW * 32) desc_kernel(
    const float* __restrict__ mod, const float* __restrict__ ang, int L, int H, int W,
    const float* __restrict__ kxs, const float* __restrict__ kys,
    const float* __restrict__ sigmas, const int* __restrict__ levels,
    const float* __restrict__ thetas, const uint8_t* __restrict__ valids, int K, int R,
    float magnif, uint8_t* __restrict__ out, float* __restrict__ out_raw) {
  __shared__ float s_desc[128];
  __shared__ float s_red[NW];
  __shared__ float s_bins[NW][8][32];

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float kx = kxs[k], ky = kys[k], sigma = sigmas[k];
  const int lvl = levels[k];
  const float th0 = thetas[k];
  if (!valids[k]) {
    out[(size_t)k * 128 + tid] = 0;
    if (out_raw) out_raw[(size_t)k * 128 + tid] = 0.0f;
    return;
  }
  const int yi = (int)rintf(ky);
  const int xi = (int)rintf(kx);
  const float SBP = magnif * sigma;
  const float wsigma = 2.0f * SBP;
  const float Wr = ((SBP * 5.0f) / 2.0f) * SQRT2_F + 0.5f;
  const float den = 2.0f * (wsigma * wsigma);
  const float ct = cosf(th0), st = sinf(th0);
  // the plain version divides by SBP, by den and by 2 pi at every
  // pixel; a reciprocal a row (and a constant) moves a weight by an
  // ulp or two, far inside the tolerance
  const float inv_den = 1.0f / den;
  const float rc = ct / SBP, rs = st / SBP;
  const int r = min(R, (int)floorf(Wr + 0.5f) + 1);
  const float* modl = mod + (size_t)lvl * H * W;
  const float* angl = ang + (size_t)lvl * H * W;
  // half-side of a cell's bounding box, with a margin far above the
  // rounding of the pixel coordinates
  const float ext = (SBP * (fabsf(ct) + fabsf(st))) * 1.0001f + 0.01f;

  for (int cell = warp; cell < 16; cell += NW) {
    const float cy = (float)(cell >> 2) - 1.5f;
    const float cx = (float)(cell & 3) - 1.5f;
    const float bcx = kx + SBP * (ct * cx - st * cy);
    const float bcy = ky + SBP * (st * cx + ct * cy);
    const int x0 = max(max(xi - r, 0), (int)floorf(bcx - ext));
    const int x1 = min(min(xi + r, W - 1), (int)ceilf(bcx + ext));
    const int y0 = max(max(yi - r, 0), (int)floorf(bcy - ext));
    const int y1 = min(min(yi + r, H - 1), (int)ceilf(bcy + ext));
    // this lane's 8 orientation bins of the cell
    float* bins = &s_bins[warp][0][lane];
#pragma unroll
    for (int o = 0; o < 8; ++o) bins[32 * o] = 0.0f;

    const int bw = x1 - x0 + 1;
    if (bw > 0 && y1 >= y0) {
      // raster walk over the box, 32 pixels a step; the offsets from
      // the keypoint are small integers plus one fraction and step
      // exactly in float
      const int ystep = 32 / bw, xstep = 32 % bw;
      int y = y0 + lane / bw;
      int x = x0 + lane % bw;
      const float fystep = (float)ystep, fxstep = (float)xstep, fbw = (float)bw;
      float dy = (float)y - ky, dx = (float)x - kx;
      const float* pm = modl + (size_t)y * W + x;
      const float* pa = angl + (size_t)y * W + x;
      const int pstep = ystep * W + xstep, pwrap = W - bw;
      while (y <= y1) {
        if (fabsf(dx) <= Wr && fabsf(dy) <= Wr) {
          const float nx = rc * dx + rs * dy;
          const float ny = rc * dy - rs * dx;
          const float wy = fmaxf(0.0f, 1.0f - fabsf(ny - cy));
          const float wx = fmaxf(0.0f, 1.0f - fabsf(nx - cx));
          if (wy > 0.0f && wx > 0.0f) {
            const float win = expf(-(dx * dx + dy * dy) * inv_den);
            const float c = __ldg(pm) * win;
            const float theta = remainder_f(__ldg(pa) - th0, TWO_PI_F);
            const float nt = theta * (8.0f / TWO_PI_F);
            // the two orientation bins within 1 of nt: floor(nt) at
            // distance nt - fl, and the next (circularly) at fl + 1 - nt
            const float fl = floorf(nt);
            const float v = (c * wy) * wx;
            const int o0 = (int)fl & 7;
            const int o1 = (o0 + 1) & 7;
            bins[32 * o0] += v * (1.0f - (nt - fl));
            bins[32 * o1] += v * (1.0f - ((fl + 1.0f) - nt));
          }
        }
        y += ystep; dy += fystep;
        x += xstep; dx += fxstep;
        pm += pstep; pa += pstep;
        if (x > x1) {
          x -= bw; dx -= fbw;
          ++y; dy += 1.0f;
          pm += pwrap; pa += pwrap;
        }
      }
    }
    float acc[8];
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[o] = bins[32 * o];
#pragma unroll
    for (int o = 0; o < 8; ++o) acc[o] = warp_sum(acc[o]);
    if (lane == 0) {
#pragma unroll
      for (int o = 0; o < 8; ++o) s_desc[cell * 8 + o] = acc[o];
    }
  }
  __syncthreads();

  const float raw = s_desc[tid];
  if (out_raw) out_raw[(size_t)k * 128 + tid] = raw;
  float nrm = sqrtf(block_sum(raw * raw, s_red));
  float d = raw / fmaxf(nrm, 1e-12f);
  d = fminf(d, 0.2f);
  nrm = sqrtf(block_sum(d * d, s_red));
  d = d / fmaxf(nrm, 1e-12f);
  out[(size_t)k * 128 + tid] = (uint8_t)fminf(floorf(512.0f * d), 255.0f);
}

}  // namespace

extern "C" int sift_desc(const void* mod, const void* ang, int L, int H, int W,
                         const void* kx, const void* ky, const void* sigma,
                         const void* level, const void* theta0, const void* valid, int K,
                         int R, float magnif, void* out, void* out_raw, void* stream) {
  desc_kernel<<<K, NW * 32, 0, (cudaStream_t)stream>>>(
      (const float*)mod, (const float*)ang, L, H, W, (const float*)kx, (const float*)ky,
      (const float*)sigma, (const int*)level, (const float*)theta0, (const uint8_t*)valid, K,
      R, magnif, (uint8_t*)out, (float*)out_raw);
  return (int)cudaGetLastError();
}
