// Scanline resample: the passes of the two-pass (Catmull-Smith) warp.
//
//   out[p, q, c] = sum_s k(pos[p, q] - s) * src(p, q, s, c)
//
// k is the cubic-convolution profile (a = -0.5, GDAL's default) or the
// bilinear profile; samples s outside [0, S) contribute zero. Three
// kernels evaluate the at most four non-zero taps, at s = floor(pos) - 1
// ... floor(pos) + 2, each one fused multiply-add in tap order from 0,
// with weights from one function (tap_weight), so all three round alike:
//
// 1. scanline_resample_kernel, one pass over any (P, Q, C) source. The
//    source element of (p, q, s, c) lies at  p*sp + q*sq + s*ss + c
//    (element strides, channels contiguous), so it serves both passes:
//
//      pass 1: src (N, S, C), pos (N, D)  -> out (N, D, C)
//              sp = S*C, sq = 0,   ss = C      (contract axis 1)
//      pass 2: src (S, M, C), pos (D, M)  -> out (D, M, C)
//              sp = 0,   sq = C,   ss = M*C    (contract axis 0, reading
//              pass 1's natural layout: no transpose)
//
//    It replaces the TPU kernels _banded_pass1 / _banded_pass2 behind
//    pallas_banded_two_pass (hyperres/kernels/pallas_ops.py:390-581),
//    which contract a 384-sample window per 128-sample tile on the MXU,
//    and the dense one-pass kernel pallas_scanline_resample
//    (pallas_ops.py:189), which sums k(pos - s) * src over the WHOLE
//    source axis. k vanishes outside the four taps, so for finite src the
//    sums are equal; here in exact f32. (For a non-finite src the dense
//    sum makes a whole output row non-finite, 0 * NaN = NaN; the taps
//    poison only the outputs that read it.) A block owns one p and kTileQ
//    consecutive q; threads walk its output run of kTileQ*C floats.
//
// 2. scanline_resample_kernel_glt: pass 1 of the fused GLT + two-pass
//    ortho warp. Its source is [raw[glt] * valid, valid] (H_o, W_o, B + 1)
//    read in place: channel c < B of sample (p, s) is
//    raw[flat[p, s] * ps + c] * valid[p, s] (one f32 multiply, as the
//    eager product rounds it, so a non-finite raw value under an invalid
//    GLT cell poisons what it poisons there), channel B is valid[p, s].
//    Out: the (H_o, W_d, B + 1) intermediate, equal bit for bit to
//    kernel 1's pass 1 over the eager source.
//
// 3. scanline_resample_kernel_renorm: pass 2 of that warp with the
//    renormalisation in its epilogue. For each destination (d, m) the
//    validity channel's sum (den) first, then each band's sum divided by
//    it (IEEE division) where |den| > 1e-6 and the centre
//    (rows[d, m], cols[d, m]) lies inside the H_o x W_o source, else
//    fill. Out: the (H_d, W_d, B) result, equal bit for bit to kernel 1's
//    pass 2 followed by the eager divide and masked fill.
//
// What bounds them on Hopper: memory. A tap costs one FMA; each output
// element is written once. A block owns one line (p; d) and a run of
// consecutive destination samples (kernel 1: kTileQ; kernels 2 and 3:
// about kTileElems / C, at most kMaxTileQ, so a 3- or 11-band warp keeps
// every thread busy), so its output is one contiguous run of floats that
// its threads walk; reads of each tap row (C contiguous floats) and the
// writes are coalesced. The taps' offsets and weights (kernel 2: and the
// GLT offsets and validity; kernel 3: and den and the keep bit) are
// computed once per destination into shared memory. Kernels 2 and 3 keep
// each thread's (sample, channel) place by additions (struct Walk): an
// integer division per element cost more than the taps' loads. Neither
// the gathered cube, the extended source, the extended result nor a
// divide or fill pass is written, so the fused warp moves the raw cube,
// the (H_o, W_d, B + 1) intermediate twice and the result once. Offsets
// are 64-bit: a 1510 x 1550 x 286 f32 array is 2.68 GB.
//
// C interface (built with nvcc into a shared library, loaded by ctypes):
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 8;      // destination samples per block (kernel 1)
constexpr int kThreads = 256;  // threads per block, every kernel
constexpr int kTileElems = 2304;  // elements a tile, kernels 2 and 3
constexpr int kMaxTileQ = 512;    // their destination samples a tile, at most

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

// The weight of source sample s at position x, in every kernel (the card
// tests hold their weights and results equal bit for bit). Inlined: a
// call in kernel 1's prologue cost it 7-11 %.
__device__ __forceinline__ float tap_weight(float x, int64_t s, int cubic) {
  const float d = x - (float)s;
  return cubic ? cubic_profile(d) : linear_profile(d);
}

// The taps of position x over S samples: bit t of the result is set
// where s = *base + t lies in [0, S), *base = floor(x) - 1. A tap can
// land there only for -2 <= x < S + 1; outside (NaN and the +-1e6
// padding positions included) there is none.
__device__ __forceinline__ int tap_mask(float x, int64_t S, int64_t* base) {
  *base = 0;
  if (!(x >= -2.0f && x < (float)S + 1.0f)) return 0;
  const int64_t b = (int64_t)floorf(x) - 1;
  int mask = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (b + t >= 0 && b + t < S) mask |= 1 << t;
  }
  *base = b;
  return mask;
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
    int64_t b;
    const int mask = tap_mask(x, S, &b);
    int64_t off = -1;
    float w = 0.0f;
    if (mask >> t & 1) {
      w = tap_weight(x, b + t, cubic);
      off = p * sp + (q0 + lq) * sq + (b + t) * ss;
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

// A thread's place (sample q, channel c) in a tile's run of samples of
// n channels as it strides by kThreads elements: kept by additions, with
// no division in the loop.
struct Walk {
  int q, c, dq, dc, n;
  __device__ Walk(int i, int n_) : q(i / n_), c(i % n_), dq(kThreads / n_),
                                   dc(kThreads % n_), n(n_) {}
  __device__ void next() {
    q += dq;
    c += dc;
    if (c >= n) {
      c -= n;
      ++q;
    }
  }
};

// Pass 1 of the fused ortho warp (kernel 2 of the header): kernel 1's
// pass 1 over the source [raw[flat] * valid, valid] read in place, with
// a tile of tile_q destination samples (tile_of_channels). The taps' raw
// pixel offsets and validity are staged with their weights in dynamic
// shared memory: tile_q * 4 offsets, then weights, then validity.
template <typename Idx>
__global__ void __launch_bounds__(kThreads)
scanline_resample_kernel_glt(const float* __restrict__ raw, int64_t ps,
                             const Idx* __restrict__ flat,
                             const float* __restrict__ valid,
                             const float* __restrict__ cstar,
                             float* __restrict__ out, int64_t Q, int64_t S,
                             int64_t B, int tile_q, int64_t tiles_q,
                             int cubic) {
  extern __shared__ int64_t tap_off[];  // raw pixel offset, -1: none
  float* tap_w = reinterpret_cast<float*>(tap_off + tile_q * 4);
  float* tap_v = tap_w + tile_q * 4;

  const int64_t p = blockIdx.x / tiles_q;
  const int64_t q0 = (blockIdx.x % tiles_q) * tile_q;
  const int64_t rem = Q - q0;
  const int nq = rem < tile_q ? (int)rem : tile_q;

  for (int j = threadIdx.x; j < nq * 4; j += kThreads) {
    const int t = j % 4;
    const float x = cstar[p * Q + q0 + j / 4];
    int64_t b;
    const int mask = tap_mask(x, S, &b);
    int64_t off = -1;
    float w = 0.0f, v = 0.0f;
    if (mask >> t & 1) {
      w = tap_weight(x, b + t, cubic);
      off = (int64_t)flat[p * S + b + t] * ps;
      v = valid[p * S + b + t];
    }
    tap_off[j] = off;
    tap_w[j] = w;
    tap_v[j] = v;
  }
  __syncthreads();

  const int C = (int)B + 1;
  const int n = nq * C;
  float* o = out + (p * Q + q0) * C;
  Walk it(threadIdx.x, C);
  for (int i = threadIdx.x; i < n; i += kThreads, it.next()) {
    const int k = it.q * 4;
    float acc = 0.0f;
    if (it.c < C - 1) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int64_t off = tap_off[k + t];
        if (off >= 0) {
          acc = fmaf(tap_w[k + t],
                     __fmul_rn(__ldg(raw + off + it.c), tap_v[k + t]), acc);
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (tap_off[k + t] >= 0) acc = fmaf(tap_w[k + t], tap_v[k + t], acc);
      }
    }
    o[i] = acc;
  }
}

// The kept bit of destination (d, m): |den| > 1e-6 and the centre (x, y)
// inside the source.
__device__ __forceinline__ bool keep_of(float den, float x, float y,
                                        float row_hi, float col_hi) {
  return fabsf(den) > 1e-6f && x >= -0.5f && x <= row_hi && y >= -0.5f
         && y <= col_hi;
}

// Pass 2 of the fused ortho warp with the renormalisation (kernel 3 of
// the header): kernel 1's pass 2 over the (S, M, B + 1) intermediate
// with a tile of tile_q destination columns, the validity channel's sum
// (den) of each destination first, then each band divided by it, or
// fill; out (D, M, B). Dynamic shared memory: tile_q * 4 offsets, then
// weights, den and the kept bits.
__global__ void __launch_bounds__(kThreads)
scanline_resample_kernel_renorm(const float* __restrict__ src,
                                const float* __restrict__ rows,
                                const float* __restrict__ cols,
                                float* __restrict__ out, int64_t M,
                                int64_t S, int64_t B, int tile_q,
                                int64_t tiles_q, float row_hi, float col_hi,
                                float fill, int cubic) {
  extern __shared__ int64_t tap_off[];  // source row offset, -1: none
  float* tap_w = reinterpret_cast<float*>(tap_off + tile_q * 4);
  float* den_s = tap_w + tile_q * 4;
  int* keep_s = reinterpret_cast<int*>(den_s + tile_q);

  const int64_t d = blockIdx.x / tiles_q;
  const int64_t m0 = (blockIdx.x % tiles_q) * tile_q;
  const int64_t rem = M - m0;
  const int nq = rem < tile_q ? (int)rem : tile_q;
  const int64_t C = B + 1;

  for (int j = threadIdx.x; j < nq * 4; j += kThreads) {
    const int t = j % 4;
    const float x = rows[d * M + m0 + j / 4];
    int64_t b;
    const int mask = tap_mask(x, S, &b);
    int64_t off = -1;
    float w = 0.0f;
    if (mask >> t & 1) {
      w = tap_weight(x, b + t, cubic);
      off = ((b + t) * M + m0 + j / 4) * C;
    }
    tap_off[j] = off;
    tap_w[j] = w;
  }
  __syncthreads();
  for (int lq = threadIdx.x; lq < nq; lq += kThreads) {
    float den = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int64_t off = tap_off[lq * 4 + t];
      if (off >= 0) den = fmaf(tap_w[lq * 4 + t], __ldg(src + off + B), den);
    }
    const int64_t at = d * M + m0 + lq;
    den_s[lq] = den;
    keep_s[lq] = keep_of(den, rows[at], cols[at], row_hi, col_hi);
  }
  __syncthreads();

  const int nb = (int)B;
  const int n = nq * nb;
  float* o = out + (d * M + m0) * B;
  Walk it(threadIdx.x, nb);
  for (int i = threadIdx.x; i < n; i += kThreads, it.next()) {
    const int k = it.q * 4;
    float res = fill;
    if (keep_s[it.q]) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int64_t off = tap_off[k + t];
        if (off >= 0) acc = fmaf(tap_w[k + t], __ldg(src + off + it.c), acc);
      }
      res = __fdiv_rn(acc, den_s[it.q]);
    }
    o[i] = res;
  }
}

// The destination samples a block of kernel 2 or 3 takes for C channels
// a sample: about kTileElems elements, at most kMaxTileQ samples.
int tile_of_channels(long long C) {
  const long long q = kTileElems / C;
  return (int)(q < 1 ? 1 : (q > kMaxTileQ ? kMaxTileQ : q));
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

// Pass 1 of the fused ortho warp: raw (H, W, B) f32, pixel (r, c) at
// (r * W + c) * ps (unit channel stride); flat (P, S) int32 or int64
// (idx64) raw pixel indices in [0, H * W); valid (P, S) f32; cstar (P, Q)
// f32; out (P, Q, B + 1) f32.
extern "C" int orthowarp_pass1_f32(const float* raw, long long ps,
                                   const void* flat, int idx64,
                                   const float* valid, const float* cstar,
                                   float* out, long long P, long long S,
                                   long long Q, long long B, int cubic,
                                   void* stream) {
  if (P <= 0 || Q <= 0) return (int)cudaSuccess;
  if (B < 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const int tile_q = tile_of_channels(B + 1);
  const long long tiles_q = (Q + tile_q - 1) / tile_q;
  const long long blocks = P * tiles_q;
  if (blocks > 0x7fffffffLL || tile_q * (B + 1) > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const size_t smem = (size_t)tile_q * 4 * (8 + 4 + 4);
  cudaStream_t st = (cudaStream_t)stream;
  if (idx64) {
    scanline_resample_kernel_glt<int64_t><<<(unsigned int)blocks, kThreads,
                                            smem, st>>>(
        raw, ps, (const int64_t*)flat, valid, cstar, out, Q, S, B, tile_q,
        tiles_q, cubic);
  } else {
    scanline_resample_kernel_glt<int32_t><<<(unsigned int)blocks, kThreads,
                                            smem, st>>>(
        raw, ps, (const int32_t*)flat, valid, cstar, out, Q, S, B, tile_q,
        tiles_q, cubic);
  }
  return (int)cudaGetLastError();
}

// Pass 2 of the fused ortho warp: src (S, M, B + 1) f32, pass 1's
// output; rows / cols (D, M) f32; out (D, M, B) f32; row_hi / col_hi the
// source's H_o - 0.5 / W_o - 0.5; fill the value outside.
extern "C" int orthowarp_pass2_f32(const float* src, const float* rows,
                                   const float* cols, float* out,
                                   long long D, long long M, long long S,
                                   long long B, float row_hi, float col_hi,
                                   float fill, int cubic, void* stream) {
  if (D <= 0 || M <= 0 || B <= 0) return (int)cudaSuccess;
  if (S <= 0) return (int)cudaErrorInvalidValue;
  const int tile_q = tile_of_channels(B + 1);
  const long long tiles_q = (M + tile_q - 1) / tile_q;
  const long long blocks = D * tiles_q;
  if (blocks > 0x7fffffffLL || tile_q * B > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const size_t smem = (size_t)tile_q * (4 * (8 + 4) + 4 + 4);
  scanline_resample_kernel_renorm<<<(unsigned int)blocks, kThreads, smem,
                                    (cudaStream_t)stream>>>(
      src, rows, cols, out, M, S, B, tile_q, tiles_q, row_hi, col_hi, fill,
      cubic);
  return (int)cudaGetLastError();
}
