// The fused plan's 10 m apply: the valid-mass-renormalised bilinear
// 60 m -> 10 m upsample, the per-channel polynomial, the clamp and the
// mask, in one pass that writes the (Hd, Wd, 3) product once.
//
// For destination pixel (r, c), with r = kr*fr + pr and c = kc*fc + pc
// (the phases of the integer-aligned bilinear specs, separable_fast_spec):
//
//   row pass, source columns j = c0 and c0 + 1, c0 = r0c[pc] + kc:
//     R(j)  = where(valid(a, j), x(a, j), 0) * w0r[pr]
//           + where(valid(a+1, j), x(a+1, j), 0) * w1r[pr],  a = r0r[pr] + kr
//     V(j)  = valid(a, j) * w0r[pr] + valid(a+1, j) * w1r[pr]
//   column pass:
//     num   = R(c0) * w0c[pc] + R(c0 + 1) * w1c[pc]     (per channel)
//     den   = V(c0) * w0c[pc] + V(c0 + 1) * w1c[pc]
//   renormalise: v = num / den where |den| > 1e-6 and r in [rlo, rhi),
//     c in [clo, chi); else NaN
//   mask: a pixel with any non-finite channel is NaN in all three
//   apply: y = ((0 + p0) * v + p1) * v + ... (Horner, highest power
//     first, coefficients (3, ncoef) read from the device), clamped to
//     [0, 1] with NaN kept
//
// w0 = f32(1 - t) and w1 = t are the eager path's weights
// (kernels/warp.py _fast_pass, which lerps rows first, then columns).
// Out-of-range taps read 0, as that path's zero padding does. Every
// multiply, add and divide is an _rn intrinsic and the build uses no
// --use_fast_math, so nvcc contracts nothing into an FMA and the product
// is the eager chain's, bit for bit (kernels/upsample_apply.py).
//
// What bounds it on Hopper: the one write of the product, 12 bytes a
// pixel (9140 x 9309 x 3 f32 is 1.02 GB, 0.30 ms at 3.35 TB/s), and the
// instructions that make a pixel (the lerps, three IEEE divides, the
// Horner chains). The 60 m source (28 MB of RGB and 2.4 MB of validity at
// the plan's granule) stays in L2. The design:
//
// - a block owns a segment of one destination row, kSegPeriods column
//   periods long (6144 pixels at f = 6), so its row taps (a, a + 1, their
//   weights) are one pair and its prologue is paid once per segment;
// - the row pass depends on the source column alone: the block computes
//   it once per source column the segment reads (kSegPeriods + 2 at
//   most: the specs' first taps advance by 0 or 1 a column, which the
//   host checks) into shared memory, reading the source coalesced and
//   branch-free;
// - then, kChunk pixels at a time, each thread takes four pixels
//   kThreads apart (its column phase advances by a fixed step, with no
//   division), reads their two row-pass results, and stages the three
//   floats in shared memory (stride 3 words: no bank conflicts), at the
//   offset that puts the staged run on the product's 16-byte grid; the
//   block writes it with coalesced float4 stores;
// - the polynomial's coefficients sit in registers, unrolled, for the
//   plan's two cases (degree 4, and linear's degree 1); other degrees
//   take a loop over shared memory.
//
// Indices are 32-bit: the host refuses a source or a product of 2^31
// floats or more.
//
// C interface (built with nvcc into a shared library, loaded by ctypes):
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it does not
// take) so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;                       // pixels per thread and chunk
constexpr int kChunk = kThreads * kPix;       // pixels staged at a time
constexpr int kSegPeriods = 1024;             // column periods per block
constexpr int kRows = kSegPeriods + 3;        // row-pass entries per block
constexpr int kMaxPhases = 32;                // bilinear phases per axis
constexpr int kMaxCoeffs = 16;                // polynomial degree <= 15
constexpr int kChannels = 3;

struct AxisSpec {
  int f;
  int r0[kMaxPhases];
  float w0[kMaxPhases];
  float w1[kMaxPhases];
};

struct Params {
  AxisSpec row, col;
  int hs, ws, hd, wd;
  int rlo, rhi, clo, chi;
  int ncoef;
  int seg;   // destination columns per block (kSegPeriods * col.f)
  int segs;  // blocks per destination row
};

__device__ __forceinline__ float lerp_rn(float a, float b, float w0,
                                         float w1) {
  return __fadd_rn(__fmul_rn(a, w0), __fmul_rn(b, w1));
}

// One source pixel as the upsample reads it: where(valid, x, 0) in three
// channels and the valid mass; 0 outside the source.
__device__ __forceinline__ float4 tap(const float* __restrict__ x,
                                      const uint8_t* __restrict__ valid,
                                      int hs, int ws, int a, int j) {
  if (a < 0 || a >= hs || j < 0 || j >= ws) {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const int i = a * ws + j;
  const bool ok = __ldg(valid + i) != 0;
  const float v0 = __ldg(x + 3 * i);
  const float v1 = __ldg(x + 3 * i + 1);
  const float v2 = __ldg(x + 3 * i + 2);
  return ok ? make_float4(v0, v1, v2, 1.0f)
            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Horner's rule, highest power first, rounded as polyval's eager ops:
// (0 + c[0]) * v + c[1], ... One channel's kN coefficients from `c`
// (registers); kN == 0: `n` of them from `cs` (shared memory).
template <int kN>
__device__ __forceinline__ float horner(const float* c, const float* cs,
                                        int n, float v) {
  float y;
  if (kN > 0) {
    y = __fadd_rn(0.0f, c[0]);
#pragma unroll
    for (int i = 1; i < kN; ++i) y = __fadd_rn(__fmul_rn(y, v), c[i]);
  } else {
    y = __fadd_rn(0.0f, cs[0]);
    for (int i = 1; i < n; ++i) y = __fadd_rn(__fmul_rn(y, v), cs[i]);
  }
  return y;
}

template <int kN>
__global__ void __launch_bounds__(kThreads)
upsample_apply_kernel(const float* __restrict__ x,
                      const uint8_t* __restrict__ valid,
                      const float* __restrict__ coeffs,
                      float* __restrict__ out,
                      const __grid_constant__ Params p) {
  __shared__ float4 rows[kRows];  // row pass, by source column
  __shared__ float4 stage4[(kChunk * kChannels + 8) / 4];
  __shared__ float coef[kChannels][kMaxCoeffs];
  __shared__ int c_r0[kMaxPhases];
  __shared__ float c_w0[kMaxPhases];
  __shared__ float c_w1[kMaxPhases];
  float* stage = reinterpret_cast<float*>(stage4);

  const int tid = threadIdx.x;
  const int r = blockIdx.x / p.segs;
  const int c_a = (blockIdx.x - r * p.segs) * p.seg;
  const int n_seg = min(p.seg, p.wd - c_a);
  const int fc = p.col.f;
  if (tid < kChannels * p.ncoef) {
    coef[tid / p.ncoef][tid % p.ncoef] = coeffs[tid];
  }
  if (tid < fc) {
    c_r0[tid] = p.col.r0[tid];
    c_w0[tid] = p.col.w0[tid];
    c_w1[tid] = p.col.w1[tid];
  }

  // the segment's row taps, and its source columns [ja, jb]
  const int kr = r / p.row.f;
  const int pr = r - kr * p.row.f;
  const int a = p.row.r0[pr] + kr;
  const float rw0 = p.row.w0[pr];
  const float rw1 = p.row.w1[pr];
  const int kc_a = c_a / fc;
  const int c_b = c_a + n_seg - 1;
  const int kc_b = c_b / fc;
  const int ja = p.col.r0[c_a - kc_a * fc] + kc_a;
  const int jb = p.col.r0[c_b - kc_b * fc] + kc_b + 1;
  for (int k = tid; k <= jb - ja; k += kThreads) {
    const float4 s0 = tap(x, valid, p.hs, p.ws, a, ja + k);
    const float4 s1 = tap(x, valid, p.hs, p.ws, a + 1, ja + k);
    rows[k] = make_float4(lerp_rn(s0.x, s1.x, rw0, rw1),
                          lerp_rn(s0.y, s1.y, rw0, rw1),
                          lerp_rn(s0.z, s1.z, rw0, rw1),
                          lerp_rn(s0.w, s1.w, rw0, rw1));
  }
  __syncthreads();

  float cf[kChannels][kN > 0 ? kN : 1];
#pragma unroll
  for (int ch = 0; ch < kChannels; ++ch) {
#pragma unroll
    for (int i = 0; i < (kN > 0 ? kN : 1); ++i) {
      cf[ch][i] = kN > 0 ? coef[ch][i] : 0.0f;
    }
  }

  const float kNaN = __int_as_float(0x7fc00000);
  const bool row_in = r >= p.rlo && r < p.rhi;
  int c = c_a + tid;
  int kc = c / fc;
  int pc = c - kc * fc;
  const int dk = kThreads / fc;
  const int dp = kThreads - dk * fc;
  for (int chunk = 0; chunk < n_seg; chunk += kChunk) {
    // the chunk's first float in the product, and where it is staged
    const unsigned int g0 =
        ((unsigned int)r * (unsigned int)p.wd + c_a + chunk) * kChannels;
    const int shift = (int)(g0 & 3u);
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      const int lc = tid + q * kThreads;
      if (chunk + lc < n_seg) {
        const int jl = c_r0[pc] + kc - ja;
        const float4 R0 = rows[jl];
        const float4 R1 = rows[jl + 1];
        const float cw0 = c_w0[pc];
        const float cw1 = c_w1[pc];
        const float den = lerp_rn(R0.w, R1.w, cw0, cw1);
        float v[kChannels];
        v[0] = __fdiv_rn(lerp_rn(R0.x, R1.x, cw0, cw1), den);
        v[1] = __fdiv_rn(lerp_rn(R0.y, R1.y, cw0, cw1), den);
        v[2] = __fdiv_rn(lerp_rn(R0.z, R1.z, cw0, cw1), den);
        const bool ok = row_in && c >= p.clo && c < p.chi &&
                        fabsf(den) > 1e-6f && isfinite(v[0]) &&
                        isfinite(v[1]) && isfinite(v[2]);
#pragma unroll
        for (int ch = 0; ch < kChannels; ++ch) {
          float y = kNaN;
          if (ok) {
            y = horner<kN>(cf[ch], coef[ch], p.ncoef, v[ch]);
            // torch.clamp: NaN passes through
            if (!isnan(y)) y = fminf(fmaxf(y, 0.0f), 1.0f);
          }
          stage[shift + lc * kChannels + ch] = y;
        }
      }
      // the next pixel, kThreads columns on
      c += kThreads;
      kc += dk;
      pc += dp;
      if (pc >= fc) {
        pc -= fc;
        ++kc;
      }
    }
    __syncthreads();
    // staged floats [shift, shift + nf) are the product's [g0, g0 + nf);
    // slot m of four is 16-byte aligned there
    const int nf = min(kChunk, n_seg - chunk) * kChannels;
    float* dst = out + (g0 - shift);
    for (int m = tid; 4 * m < shift + nf; m += kThreads) {
      if (4 * m >= shift && 4 * m + 4 <= shift + nf) {
        reinterpret_cast<float4*>(dst)[m] = stage4[m];
      } else {
        for (int i = max(4 * m, shift); i < min(4 * m + 4, shift + nf); ++i) {
          dst[i] = stage[i];
        }
      }
    }
    __syncthreads();
  }
}

// A bilinear axis as the kernel takes it: 1 <= f <= kMaxPhases, and the
// first tap advancing by 0 or 1 from one destination index to the next
// (r0[p + 1] - r0[p] and r0[0] + 1 - r0[f - 1] in {0, 1}), as
// separable_fast_spec's increasing index fields give.
bool axis_ok(int f, const int* r0, const float* w0, const float* w1,
             AxisSpec* ax) {
  if (f < 1 || f > kMaxPhases) return false;
  for (int i = 0; i < f; ++i) {
    const int step = i + 1 < f ? r0[i + 1] - r0[i] : r0[0] + 1 - r0[i];
    if (step != 0 && step != 1) return false;
  }
  ax->f = f;
  for (int i = 0; i < kMaxPhases; ++i) {
    ax->r0[i] = i < f ? r0[i] : 0;
    ax->w0[i] = i < f ? w0[i] : 0.0f;
    ax->w1[i] = i < f ? w1[i] : 0.0f;
  }
  return true;
}

}  // namespace

// x (hs, ws, 3) f32 and valid (hs, ws) bytes, contiguous, on the card;
// coeffs (3, ncoef) f32 contiguous on the card; out (hd, wd, 3) f32
// contiguous. The axis tables (fr / fc phases: source row or column of
// the first tap, and the two weights) and the destination ranges whose
// centres lie in the source are host arrays and numbers.
extern "C" int upsample_apply_f32(
    const float* x, const unsigned char* valid, const float* coeffs,
    float* out, long long hs, long long ws, long long hd, long long wd,
    int fr, const int* r0r, const float* w0r, const float* w1r, int fc,
    const int* r0c, const float* w0c, const float* w1c, long long rlo,
    long long rhi, long long clo, long long chi, int ncoef, void* stream) {
  if (hd <= 0 || wd <= 0) return (int)cudaSuccess;
  const long long lim = 0x7fffffffLL;
  Params p;
  if (hs < 0 || ws < 0 || hs > lim || ws > lim ||
      hs * ws * kChannels > lim || hd * wd * kChannels > lim ||
      ncoef < 1 || ncoef > kMaxCoeffs ||
      !axis_ok(fr, r0r, w0r, w1r, &p.row) ||
      !axis_ok(fc, r0c, w0c, w1c, &p.col)) {
    return (int)cudaErrorInvalidValue;
  }
  p.hs = (int)hs;
  p.ws = (int)ws;
  p.hd = (int)hd;
  p.wd = (int)wd;
  p.rlo = (int)(rlo < 0 ? 0 : rlo > hd ? hd : rlo);
  p.rhi = (int)(rhi < 0 ? 0 : rhi > hd ? hd : rhi);
  p.clo = (int)(clo < 0 ? 0 : clo > wd ? wd : clo);
  p.chi = (int)(chi < 0 ? 0 : chi > wd ? wd : chi);
  p.ncoef = ncoef;
  p.seg = kSegPeriods * fc;
  p.segs = (int)((wd + p.seg - 1) / p.seg);
  const long long blocks = hd * (long long)p.segs;
  if (blocks > lim) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned int nb = (unsigned int)blocks;
  if (ncoef == 5) {
    upsample_apply_kernel<5><<<nb, kThreads, 0, st>>>(x, valid, coeffs, out, p);
  } else if (ncoef == 2) {
    upsample_apply_kernel<2><<<nb, kThreads, 0, st>>>(x, valid, coeffs, out, p);
  } else {
    upsample_apply_kernel<0><<<nb, kThreads, 0, st>>>(x, valid, coeffs, out, p);
  }
  return (int)cudaGetLastError();
}
