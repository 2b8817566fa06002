// Sampson inlier counts of essential-matrix hypotheses (K4), one launch for
// every (pair, trial, root) of a RANSAC batch.
//
// Replaces no TPU kernel.  The JAX package scores hypotheses with fused XLA
// einsums (spectavi_tpu/mvg/ransac.py::_sampson_counts), which keep the
// per-row terms out of memory on the TPU.  The port's plain PyTorch route
// (ops/sampson.py::count_plain) runs the same einsums eagerly: it writes and
// reads (pairs, trials, 3, N, 3) float32 intermediates and has to cut the
// trials into chunks to bound them, so a 55-pair batch of 8192 trials over
// ~21k rows took ~630 chunks of ~233 launches each.  This kernel keeps every
// intermediate in registers and scores the whole batch in one launch.
//
// For hypothesis h = 3 t + r of problem p, with E = E[p, h] (3x3, row-major)
// and each row n with point_mask[p, n] set, x0h = (x0, 1), x1h = (x1, 1):
//   Ex0  = E x0h,  Etx1 = E^T x1h,  xEx = x1h . Ex0,
//   den  = Ex0_0^2 + Ex0_1^2 + Etx1_0^2 + Etx1_1^2, clamped below at 1e-30,
//   the row is an inlier when (xEx * xEx) / den <= thr2;
// out[p, h] is the count of inlier rows, or -1 where valid[p, h] is not set.
//
// What bounds it on an H100: operations.  A (hypothesis, row) test is ~35
// float32 operations (12 for Ex0, 8 for the two components of Etx1 the
// denominator uses, 4 for xEx, 7 for den, clamp, square, quotient, compare)
// on 16 bytes of row that every hypothesis of the problem shares: the rows
// of one problem (21k x 16 bytes at the largest) stay in L2, and the E of a
// hypothesis (36 bytes) is read once.  At fountain-P11's pair step, 1.06M
// valid hypotheses over ~15k real rows each, that is ~0.57 TFLOP: ~8.5 ms
// at the 67 TFLOP/s float32 peak, which counts a fused multiply-add as two;
// with contraction off (below) every operation is its own instruction, so
// the kernel can reach at most half of that peak.
//
// Design:
//  * a block of 128 threads takes one problem and 128 of its hypotheses,
//    one a thread: the grid is (hypotheses / 128, problems), ~10.6k blocks
//    at fountain-P11's pair step, 48 at a castle-size RANSAC block.  A
//    thread holds its E in registers (46 registers, no spills) and counts
//    in a register.  Counts are integers written once, with no atomics: the
//    result does not depend on scheduling.  Two or four hypotheses a thread
//    (reusing each row read from shared memory) were measured and left out:
//    1.7x and 1.9x slower at fountain-P11's shape (56 and 72 registers, the
//    latter spilling), 4.7x and 9x at a castle block, whose 48 blocks leave
//    most multiprocessors idle already;
//  * the problem's rows stream through a double-buffered ring of 256 rows in
//    shared memory: each thread loads two rows of the next stage into
//    registers before it computes on the current stage, and stores them
//    after, so the loads are in flight during the arithmetic; one barrier a
//    stage.  Every thread then reads the same row, a broadcast with no bank
//    conflicts;
//  * a row whose mask is not set (and a row past N) is stored with NaN
//    coordinates.  NaN propagates through every product and sum, and
//    NaN <= thr2 is false, so such a row counts exactly as the plain route's
//    `& point_mask` does, with no test in the inner loop.  A stage with no
//    real row is skipped (the barrier is a __syncthreads_or), so the tail
//    that the pair step's compaction leaves behind its survivors costs only
//    its loads;
//  * a thread whose hypothesis is invalid writes -1 and computes nothing; a
//    block whose hypotheses are all invalid returns at once;
//  * the float operations are the plain route's, in its order, each rounded
//    on its own: compiled with -fmad=false (no contraction), the quotient an
//    IEEE division (__fdiv_rn), the clamp passing NaN on as torch.clamp
//    does.  The plain route's products go through cuBLAS (or MKL) in an order
//    and with contractions of the library's choosing, so a count may differ
//    from it only where a row lies on the threshold.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;
constexpr int ROWS = 2 * NT;  // rows a stage of the ring

struct Rows {
  float4 a, b;  // (x0, y0, x1, y1) of the thread's two rows of a stage
  bool live;    // either row is real
};

__device__ __forceinline__ float4 load_row(const float* __restrict__ x0,
                                           const float* __restrict__ x1,
                                           const uint8_t* __restrict__ mask, int N,
                                           int r, bool& real) {
  real = r < N && mask[r] != 0;
  if (!real) return make_float4(NAN, NAN, NAN, NAN);
  return make_float4(x0[2 * r], x0[2 * r + 1], x1[2 * r], x1[2 * r + 1]);
}

__device__ __forceinline__ Rows load_stage(const float* __restrict__ x0,
                                           const float* __restrict__ x1,
                                           const uint8_t* __restrict__ mask, int N,
                                           int stage) {
  Rows s;
  bool ra, rb;
  const int r = stage * ROWS + threadIdx.x;
  s.a = load_row(x0, x1, mask, N, r, ra);
  s.b = load_row(x0, x1, mask, N, r + NT, rb);
  s.live = ra || rb;
  return s;
}

__global__ void __launch_bounds__(NT) sampson_count_kernel(
    const float* __restrict__ E, const uint8_t* __restrict__ valid,
    const float* __restrict__ x0, const float* __restrict__ x1,
    const uint8_t* __restrict__ mask, int H, int N, float thr2, int* __restrict__ out) {
  __shared__ float4 s_rows[2][ROWS];

  const int p = blockIdx.y;
  const int h = blockIdx.x * NT + threadIdx.x;
  x0 += (size_t)p * N * 2;
  x1 += (size_t)p * N * 2;
  mask += (size_t)p * N;
  const size_t ph = (size_t)p * H + h;

  const bool ok = h < H && valid[ph] != 0;
  float m[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) m[j] = ok ? E[ph * 9 + j] : 0.0f;
  int cnt = 0;

  if (__syncthreads_or(ok)) {
    const int stages = (N + ROWS - 1) / ROWS;
    Rows next = load_stage(x0, x1, mask, N, 0);
    s_rows[0][threadIdx.x] = next.a;
    s_rows[0][threadIdx.x + NT] = next.b;
    bool live = __syncthreads_or(next.live);
    for (int st = 0; st < stages; ++st) {
      const bool more = st + 1 < stages;
      if (more) next = load_stage(x0, x1, mask, N, st + 1);
      if (live && ok) {
        const float4* rows = s_rows[st & 1];
#pragma unroll 2
        for (int i = 0; i < ROWS; ++i) {
          const float4 v = rows[i];
          const float a0 = m[0] * v.x + m[1] * v.y + m[2];
          const float a1 = m[3] * v.x + m[4] * v.y + m[5];
          const float a2 = m[6] * v.x + m[7] * v.y + m[8];
          const float b0 = m[0] * v.z + m[3] * v.w + m[6];
          const float b1 = m[1] * v.z + m[4] * v.w + m[7];
          const float xex = v.z * a0 + v.w * a1 + a2;
          float den = a0 * a0 + a1 * a1 + b0 * b0 + b1 * b1;
          den = den < 1e-30f ? 1e-30f : den;  // NaN stays NaN
          cnt += __fdiv_rn(xex * xex, den) <= thr2;
        }
      }
      if (more) {
        s_rows[(st + 1) & 1][threadIdx.x] = next.a;
        s_rows[(st + 1) & 1][threadIdx.x + NT] = next.b;
      }
      live = __syncthreads_or(more && next.live);
    }
  }
  if (h < H) out[ph] = ok ? cnt : -1;
}

}  // namespace

// E (P, H, 9) float32, valid (P, H) bool bytes, x0 and x1 (P, N, 2) float32,
// mask (P, N) bool bytes, out (P, H) int32
extern "C" int sampson_count(const void* E, const void* valid, const void* x0, const void* x1,
                             const void* mask, int P, int H, int N, float thr2, void* out,
                             void* stream) {
  if (P > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((H + NT - 1) / NT, P);
  sampson_count_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const float*)E, (const uint8_t*)valid, (const float*)x0, (const float*)x1,
      (const uint8_t*)mask, H, N, thr2, (int*)out);
  return (int)cudaGetLastError();
}
