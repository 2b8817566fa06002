// SIFT orientation histograms (vlfeat semantics), one warp per keypoint.
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
// What bounds it on an H100: by the count of bytes it is a memory-bound
// function (a few hundred pixels of two float levels a row), and misses to
// device memory are a third of its time: the rows' boxes are short runs
// (2 Wr + 1 pixels, ~4 sectors of 32 bytes) scattered over levels far larger
// than the L2 cache.  On 10404 rows of octave -1 (levels 3x4096x6144, H100
// 80GB HBM3 at 700 W) it takes 0.056 ms; the same rows on levels that stay
// in L2 0.037 ms; with the loads replaced by constants 0.031 ms; with expf
// and both divisions cut out as well 0.023 ms, which is the zeroing, the
// walk, the shared-memory adds, the shuffle reduction and the launch.
//
// Design:
//  * a pixel counts only while r^2 < Wr^2 + 0.6, so its offset from
//    round(kp) is at most Wr in x and in y (|offset| <= |dx| + 0.5 <
//    sqrt(Wr^2 + 0.6) + 0.5 < Wr + 1).  A warp owns a keypoint and walks
//    only the box of radius min(Wr, R) about round(kp), clipped to the
//    octave (ops/sift_orient.py::window_box is the same formula in
//    PyTorch): (2 Wr + 1)^2 pixels, 578 a row on average at octave -1,
//    against the (2R + 1)^2 = 1849 of the full window;
//  * one pass over the pixels and none per bin: lanes take the box's
//    pixels in raster order, lane-strided, so that a warp's loads run along
//    image rows, and a lane adds each counted pixel into its own 36 bins in
//    shared memory ([bin][lane]: a lane's bins sit in its own bank, no
//    conflicts, 4.6 KB a warp).  The 32 private histograms are then summed
//    bin by bin over the warp by a fixed xor-shuffle tree.  Pixel to lane
//    and the order inside a lane depend on the row alone: no float atomics,
//    two launches give the same bytes (orientation_peaks compares bins
//    against 0.8 max, where run-to-run jitter would flip angles);
//  * 8 keypoints a block of 256 threads, 40 registers, 36 KB of shared
//    memory.  Measured within 3% of that and left out: 4 or 2 keypoints a
//    block, 2 warps a keypoint (4 were 35% slower), a lane's loads of 2 or
//    4 pixels started before their arithmetic (8: 15% slower), loads made
//    before the r^2 test, rows sorted by level and y, -r^2 times a per-row
//    reciprocal.  A transposed shared-memory sum in place of the shuffle
//    tree with 2 warps a keypoint and 4 keypoints a block gave 7% (0.052
//    against 0.056 ms) and was not kept for its code;
//  * rows are read through five pointers and valid, which may be null (all
//    rows valid), so the caller stacks nothing between launches;
//  * compiled with -fmad=false, so every operation rounds as the plain
//    PyTorch version's one-op-per-rounding does; expf and both divisions
//    are the exact ones (the bin's division decides which bin a pixel
//    falls in).  The sum order differs from the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NBINS = 36;
constexpr int NT = 256;
constexpr int NWARPS = NT / 32;  // keypoints a block
constexpr float TWO_PI_F = 6.283185307179586f;

__global__ void __launch_bounds__(NT) orient_kernel(
    const float* __restrict__ mod, const float* __restrict__ ang, int L, int H, int W,
    const float* __restrict__ kx_, const float* __restrict__ ky_,
    const float* __restrict__ sigma_, const int* __restrict__ level_,
    const uint8_t* __restrict__ valid_, int K, int R, float* __restrict__ out) {
  __shared__ float s_h[NWARPS][NBINS * 32];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * NWARPS + warp;
  if (k >= K) return;
  float acc0 = 0.0f, acc1 = 0.0f;  // bins lane and lane + 32 after the reduction

  if (valid_ == nullptr || valid_[k] != 0) {
    float* h = s_h[warp] + lane;  // this lane's bin b is h[32 b]
#pragma unroll
    for (int b = 0; b < NBINS; ++b) h[b * 32] = 0.0f;

    const float kx = kx_[k], ky = ky_[k], sigma = sigma_[k];
    const int lvl = level_[k];
    const int yi = (int)rintf(ky);
    const int xi = (int)rintf(kx);
    const float sigmaw = 1.5f * sigma;
    const float Wr = fmaxf(floorf(3.0f * sigmaw), 1.0f);
    const float lim = Wr * Wr + 0.6f;
    const float den = 2.0f * (sigmaw * sigmaw);
    const int r = (int)fminf(Wr, (float)R);
    const int x0 = max(xi - r, 0), x1 = min(xi + r, W - 1);
    const int y0 = max(yi - r, 0), y1 = min(yi + r, H - 1);
    const int nx = x1 - x0 + 1, ny = y1 - y0 + 1;
    const int P = (nx > 0 && ny > 0) ? nx * ny : 0;
    const float* modl = mod + (size_t)lvl * H * W;
    const float* angl = ang + (size_t)lvl * H * W;

    // pixel p of the box in raster order is (y0 + yy, x0 + xx)
    int yy = lane / max(nx, 1);
    int xx = lane - yy * nx;
    for (int p = lane; p < P; p += 32) {
      const int y = y0 + yy, x = x0 + xx;
      const float dy = (float)y - ky;
      const float dx = (float)x - kx;
      const float r2 = dx * dx + dy * dy;
      if (r2 < lim) {
        const size_t off = (size_t)y * W + x;
        const float c = modl[off] * expf(-r2 / den);
        int b = (int)floorf((36.0f * angl[off]) / TWO_PI_F);
        b = ((b % NBINS) + NBINS) % NBINS;
        h[b * 32] += c;
      }
      xx += 32;
      while (xx >= nx) {
        xx -= nx;
        ++yy;
      }
    }

#pragma unroll
    for (int b = 0; b < NBINS; ++b) {
      float v = h[b * 32];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if ((b & 31) == lane) {
        if (b < 32) acc0 = v; else acc1 = v;
      }
    }
  }
  out[(size_t)k * NBINS + lane] = acc0;
  if (lane < NBINS - 32) out[(size_t)k * NBINS + 32 + lane] = acc1;
}

}  // namespace

extern "C" int sift_orient_hist(const void* mod, const void* ang, int L, int H, int W,
                                const void* kx, const void* ky, const void* sigma,
                                const void* level, const void* valid, int K, int R,
                                void* out, void* stream) {
  orient_kernel<<<(K + NWARPS - 1) / NWARPS, NT, 0, (cudaStream_t)stream>>>(
      (const float*)mod, (const float*)ang, L, H, W, (const float*)kx, (const float*)ky,
      (const float*)sigma, (const int*)level, (const uint8_t*)valid, K, R, (float*)out);
  return (int)cudaGetLastError();
}
