// SIFT descriptors (vlfeat 4x4x8) with normalization and uint8 output,
// one block per (keypoint, angle) row.
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
// What bounds it on an H100: arithmetic on the CUDA cores.  The input is
// small (one window of two float levels per row, ~80 KB at the largest
// scale), but every window pixel meets all 128 output bins: ~20 flops per
// pixel and bin, about 60 Mflop for a mid-scale row.
//
// Design:
//  * pixels outside the box have weight exactly 0, so a row only visits
//    the sub-window of radius min(R, floor(Wr + 0.5) + 1); skipping zeros
//    leaves every sum bit-identical;
//  * 128 threads stage 1024 pixels at a time (contribution, rotated x, y,
//    orientation coordinate) in shared memory, then each thread owns one of
//    the 128 bins and adds that chunk's pixels in raster order.  Every sum
//    has one fixed order, so the kernel is deterministic by construction,
//    and the chunked staging keeps shared memory at 16 KB, so many rows
//    share an SM;
//  * the L2 norms are block reductions over a fixed tree;
//  * compiled with -fmad=false, so every operation rounds as the plain
//    PyTorch version's one-op-per-rounding does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr int CHUNK = 1024;
constexpr float TWO_PI_F = 6.283185307179586f;
constexpr float SQRT2_F = 1.4142135623730951f;

__device__ __forceinline__ float remainder_f(float a, float b) {
  float r = fmodf(a, b);
  if (r != 0.0f && ((b < 0.0f) != (r < 0.0f))) r += b;
  return r;
}

__device__ float block_sum(float v, float* s_red) {
  const int tid = threadIdx.x;
  s_red[tid] = v;
  __syncthreads();
  for (int o = NT / 2; o > 0; o >>= 1) {
    if (tid < o) s_red[tid] = s_red[tid] + s_red[tid + o];
    __syncthreads();
  }
  float r = s_red[0];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(NT) desc_kernel(
    const float* __restrict__ mod, const float* __restrict__ ang, int L, int H, int W,
    const float* __restrict__ meta, int K, int R, float magnif, uint8_t* __restrict__ out,
    float* __restrict__ out_raw) {
  __shared__ float s_c[CHUNK], s_nx[CHUNK], s_ny[CHUNK], s_nt[CHUNK];
  __shared__ float s_red[NT];

  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const float* m = meta + (size_t)k * 6;
  const float kx = m[0], ky = m[1], sigma = m[2];
  const int lvl = (int)m[3];
  const float th0 = m[4];
  const bool valid = m[5] > 0.0f;
  if (!valid) {
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
  const int r = min(R, (int)floorf(Wr + 0.5f) + 1);
  const int n = 2 * r + 1;
  const int P = n * n;
  const float* modl = mod + (size_t)lvl * H * W;
  const float* angl = ang + (size_t)lvl * H * W;

  // bin owned by this thread: desc[(by*4+bx)*8+o]
  const int by = tid >> 5, bx = (tid >> 3) & 3, o = tid & 7;
  const float cy = (float)by - 1.5f, cx = (float)bx - 1.5f, co = (float)o;
  float acc = 0.0f;

  for (int base = 0; base < P; base += CHUNK) {
    const int cnt = min(CHUNK, P - base);
    for (int j = tid; j < cnt; j += NT) {
      const int p = base + j;
      const int y = yi + p / n - r;
      const int x = xi + p % n - r;
      float c = 0.0f, nx = 0.0f, ny = 0.0f, nt = 0.0f;
      if (y >= 0 && y < H && x >= 0 && x < W) {
        const float dy = (float)y - ky;
        const float dx = (float)x - kx;
        if (fabsf(dx) <= Wr && fabsf(dy) <= Wr) {
          const float win = expf(-(dx * dx + dy * dy) / den);
          c = modl[(size_t)y * W + x] * win;
          nx = (ct * dx + st * dy) / SBP;
          ny = (-st * dx + ct * dy) / SBP;
          const float theta = remainder_f(angl[(size_t)y * W + x] - th0, TWO_PI_F);
          nt = (8.0f * theta) / TWO_PI_F;
        }
      }
      s_c[j] = c;
      s_nx[j] = nx;
      s_ny[j] = ny;
      s_nt[j] = nt;
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      const float c = s_c[j];
      if (c == 0.0f) continue;  // uniform across the block: every thread reads j
      const float wy = fmaxf(0.0f, 1.0f - fabsf(s_ny[j] - cy));
      const float wx = fmaxf(0.0f, 1.0f - fabsf(s_nx[j] - cx));
      float dth = fabsf(s_nt[j] - co);
      dth = fminf(dth, 8.0f - dth);
      const float wo = fmaxf(0.0f, 1.0f - dth);
      acc = acc + ((c * wy) * wx) * wo;
    }
    __syncthreads();
  }

  if (out_raw) out_raw[(size_t)k * 128 + tid] = acc;
  float nrm = sqrtf(block_sum(acc * acc, s_red));
  float d = acc / fmaxf(nrm, 1e-12f);
  d = fminf(d, 0.2f);
  nrm = sqrtf(block_sum(d * d, s_red));
  d = d / fmaxf(nrm, 1e-12f);
  out[(size_t)k * 128 + tid] = (uint8_t)fminf(floorf(512.0f * d), 255.0f);
}

}  // namespace

extern "C" int sift_desc(const void* mod, const void* ang, int L, int H, int W,
                         const void* meta, int K, int R, float magnif, void* out,
                         void* out_raw, void* stream) {
  desc_kernel<<<K, NT, 0, (cudaStream_t)stream>>>(
      (const float*)mod, (const float*)ang, L, H, W, (const float*)meta, K, R, magnif,
      (uint8_t*)out, (float*)out_raw);
  return (int)cudaGetLastError();
}
