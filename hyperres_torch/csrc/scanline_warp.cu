// Scanline resample: one pass of the two-pass (Catmull-Smith) warp.
//
//   out[p, q, c] = sum_s k(pos[p, q] - s) * src(p, q, s, c)
//
// k is the cubic-convolution profile (a = -0.5, GDAL's default) or the
// bilinear profile; samples s outside [0, S) contribute zero. The source
// element of (p, q, s, c) lies at  p*sp + q*sq + s*ss + c  (element
// strides, channels contiguous), so one kernel serves both passes:
//
//   pass 1: src (N, S, C), pos (N, D)  -> out (N, D, C)
//           sp = S*C, sq = 0,   ss = C      (contract axis 1)
//   pass 2: src (S, M, C), pos (D, M)  -> out (D, M, C)
//           sp = 0,   sq = C,   ss = M*C    (contract axis 0, reading
//           pass 1's natural layout: no transpose)
//
// Replaces the TPU kernels _banded_pass1 / _banded_pass2 behind
// pallas_banded_two_pass (hyperres/kernels/pallas_ops.py:390-581). Those
// contract a 384-sample window per 128-sample tile on the MXU; here the
// at most four non-zero taps, at s = floor(pos) - 1 ... floor(pos) + 2,
// are evaluated directly, so no window, no feasibility check and no
// nodata for a wide tile.
//
// It also replaces the dense one-pass kernel pallas_scanline_resample
// (hyperres/kernels/pallas_ops.py:189), which sums k(pos - s) * src over
// the WHOLE source axis in 128-sample tiles (bf16x3 or f32 on the MXU).
// k vanishes outside the four taps evaluated here, so for finite src the
// two sums are equal; here in exact f32. (For a non-finite src the dense
// sum makes a whole output row non-finite, 0 * NaN = NaN; the taps poison
// only the outputs that read it.) The reference warp transposes pass 1's
// output for its second dense pass and transposes the result back; the
// same launches as pass 2 above compute that without either transpose.
//
// What bounds it on Hopper: memory. Each output element costs four f32
// FMAs and four source reads (neighbouring destinations share taps, so
// most reads hit L2); the write is one f32. What the design does about
// it: a block owns one p and kTileQ consecutive q, so its output is one
// contiguous run of kTileQ*C floats; threads walk that run, so reads of
// each tap row (C contiguous floats) and the writes are coalesced. The
// taps' offsets and weights are computed once per (p, q) into shared
// memory. Offsets are 64-bit: a 1510 x 1534 x 286 f32 array is 2.65 GB.
//
// C interface (built with nvcc into a shared library, loaded by ctypes):
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 8;      // destination samples per block
constexpr int kThreads = 256;  // threads per block, along (q, c)

__device__ __forceinline__ float cubic_profile(float x) {
  const float a = -0.5f;
  const float ax = fabsf(x);
  const float ax2 = ax * ax;
  const float ax3 = ax * ax2;
  if (ax <= 1.0f) return (a + 2.0f) * ax3 - (a + 3.0f) * ax2 + 1.0f;
  if (ax < 2.0f) return a * ax3 - 5.0f * a * ax2 + 8.0f * a * ax - 4.0f * a;
  return 0.0f;
}

__device__ __forceinline__ float linear_profile(float x) {
  return fmaxf(0.0f, 1.0f - fabsf(x));
}

__global__ void __launch_bounds__(kThreads)
scanline_resample_kernel(const float* __restrict__ src,
                         const float* __restrict__ pos,
                         float* __restrict__ out, int64_t Q, int64_t C,
                         int64_t S, int64_t sp, int64_t sq, int64_t ss,
                         int64_t tiles_q, int cubic) {
  __shared__ int64_t tap_off[kTileQ][4];  // source row offset, -1: none
  __shared__ float tap_w[kTileQ][4];

  const int64_t p = blockIdx.x / tiles_q;
  const int64_t q0 = (blockIdx.x % tiles_q) * kTileQ;
  const int64_t rem = Q - q0;
  const int nq = rem < kTileQ ? (int)rem : kTileQ;

  if (threadIdx.x < nq * 4) {
    const int lq = threadIdx.x / 4;
    const int t = threadIdx.x % 4;
    const float x = pos[p * Q + q0 + lq];
    int64_t off = -1;
    float w = 0.0f;
    // a tap can land in [0, S) only for -2 <= x < S + 1; this also
    // rejects NaN and the +-1e6 padding positions
    if (x >= -2.0f && x < (float)S + 1.0f) {
      const int64_t s = (int64_t)floorf(x) - 1 + t;
      if (s >= 0 && s < S) {
        const float d = x - (float)s;
        w = cubic ? cubic_profile(d) : linear_profile(d);
        off = p * sp + (q0 + lq) * sq + s * ss;
      }
    }
    tap_off[lq][t] = off;
    tap_w[lq][t] = w;
  }
  __syncthreads();

  const int n = nq * (int)C;
  float* o = out + (p * Q + q0) * C;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int lq = i / (int)C;
    const int c = i - lq * (int)C;
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int64_t off = tap_off[lq][t];
      if (off >= 0) acc = fmaf(tap_w[lq][t], __ldg(src + off + c), acc);
    }
    o[i] = acc;
  }
}

}  // namespace

extern "C" int scanline_resample_f32(const float* src, const float* pos,
                                     float* out, long long P, long long Q,
                                     long long C, long long S, long long sp,
                                     long long sq, long long ss, int cubic,
                                     void* stream) {
  if (P <= 0 || Q <= 0 || C <= 0) return (int)cudaSuccess;
  const long long tiles_q = (Q + kTileQ - 1) / kTileQ;
  const long long blocks = P * tiles_q;
  if (blocks > 0x7fffffffLL || (long long)kTileQ * C > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  scanline_resample_kernel<<<(unsigned int)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      src, pos, out, Q, C, S, sp, sq, ss, tiles_q, cubic);
  return (int)cudaGetLastError();
}
