// SIFT orientation histograms (vlfeat semantics), one block per keypoint.
//
// Replaces spectavi_tpu/ops/sift_orient.py::sift_orient_hist_pallas
// (kernel body _orient_kernel).  For keypoint k on level l of one octave's
// gradient images mod, ang (L, H, W): a 36-bin histogram over the square
// window of radius R centred on round(kp), clipped to the octave; weight
// mod * exp(-r^2 / (2 sw^2)) with sw = 1.5 sigma, pixels counted while
// r^2 < Wr^2 + 0.6 with Wr = max(floor(3 sw), 1), bin floor(36 ang / 2pi)
// mod 36.  Invalid rows give zeros.  Unlike the Pallas kernel, whose
// DMA-aligned 56x256 patch can cut the largest windows by a pixel, this
// reads the exact window of the plain route (features/sift.py::orientations).
//
// What bounds it on an H100: memory latency more than bandwidth or
// arithmetic.  Each keypoint reads (2R+1)^2 = 1849 pixels of two float
// levels (~15 KB) scattered over rows of the level, and does one exp
// plus ~20 flops per pixel; 50k keypoints move ~0.7 GB, a fraction of a
// millisecond at the card's bandwidth.
//
// Design:
//  * 256 threads stage the window's contribution and bin in shared memory
//    (each thread a strided subset of pixels, rows read as contiguous runs);
//  * each of the 8 warps then owns bins b = warp, warp + 8, ...: its lanes
//    sum the contributions of that bin over the window in a fixed strided
//    order and reduce by a fixed shuffle tree.  No float atomics, so the
//    histogram is identical from run to run; orientation_peaks compares
//    bins against 0.8 max, where run-to-run jitter would flip angles;
//  * compiled with -fmad=false, so every operation rounds as the plain
//    PyTorch version's one-op-per-rounding does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NBINS = 36;
constexpr int NT = 256;
constexpr float TWO_PI_F = 6.283185307179586f;

__global__ void __launch_bounds__(NT) orient_kernel(
    const float* __restrict__ mod, const float* __restrict__ ang, int L, int H, int W,
    const float* __restrict__ meta, int K, int R, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int n = 2 * R + 1;
  const int P = n * n;
  float* s_c = smem;
  uint8_t* s_b = reinterpret_cast<uint8_t*>(smem + P);

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const float* m = meta + (size_t)k * 5;
  const float kx = m[0], ky = m[1], sigma = m[2];
  const int lvl = (int)m[3];
  const bool valid = m[4] > 0.0f;
  if (!valid) {
    if (tid < NBINS) out[(size_t)k * NBINS + tid] = 0.0f;
    return;
  }
  const int yi = (int)rintf(ky);
  const int xi = (int)rintf(kx);
  const float sigmaw = 1.5f * sigma;
  const float Wr = fmaxf(floorf(3.0f * sigmaw), 1.0f);
  const float lim = Wr * Wr + 0.6f;
  const float den = 2.0f * (sigmaw * sigmaw);
  const float* modl = mod + (size_t)lvl * H * W;
  const float* angl = ang + (size_t)lvl * H * W;

  for (int p = tid; p < P; p += NT) {
    const int y = yi + p / n - R;
    const int x = xi + p % n - R;
    float c = 0.0f;
    int b = 0;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const float dy = (float)y - ky;
      const float dx = (float)x - kx;
      const float r2 = dx * dx + dy * dy;
      if (r2 < lim) {
        c = modl[(size_t)y * W + x] * expf(-r2 / den);
        const float a = angl[(size_t)y * W + x];
        b = (int)floorf((36.0f * a) / TWO_PI_F);
        b = ((b % NBINS) + NBINS) % NBINS;
      }
    }
    s_c[p] = c;
    s_b[p] = (uint8_t)b;
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  for (int b = warp; b < NBINS; b += NT / 32) {
    float s = 0.0f;
    for (int p = lane; p < P; p += 32) s += (s_b[p] == b) ? s_c[p] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) out[(size_t)k * NBINS + b] = s;
  }
}

}  // namespace

extern "C" int sift_orient_hist(const void* mod, const void* ang, int L, int H, int W,
                                const void* meta, int K, int R, void* out, void* stream) {
  const int n = 2 * R + 1;
  const size_t smem = (size_t)n * n * (sizeof(float) + 1);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(orient_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  orient_kernel<<<K, NT, smem, (cudaStream_t)stream>>>(
      (const float*)mod, (const float*)ang, L, H, W, (const float*)meta, K, R, (float*)out);
  return (int)cudaGetLastError();
}
