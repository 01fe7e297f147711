// The coregistration's deshift: the affine sampling positions, the
// 16-tap nodata-renormalised cubic (or 4-tap bilinear) gather and the
// cast to the product's dtype, in one pass that reads the (B, H, W)
// stack in its own dtype and writes the (B, H, W) product once.
//
// It replaces no TPU kernel: the JAX package's deshift
// (hyperres/coreg/local.py:356) calls its plain warp_interpolate, left to
// XLA. It was added because the port's eager form of that chain (the
// field in f64, the stack to an (H, W, B) f32 copy, sixteen taps of about
// twelve elementwise passes each over B * H * W values, the u16 cast)
// made ~40 passes over device memory and 3.4 GB of temporaries a tap.
//
// For output pixel (r, c), band k, as coreg/local.py deshift_hwb,
// kernels/warp.py warp_interpolate and coreg/granule.py's u16 cast
// compute it:
//
//   position: rows = f32(f64((A00 * r + A01 * c) + A02)) + f32(r), and
//     cols with A1.; or, with local residuals, rows = dy(r, c) + f32(r)
//     from the f32 field the caller made (shift_field), cols likewise
//   taps: r0 = floor(rows), tr = rows - r0; cubic: rows r0 - 1 .. r0 + 2
//     with the weights k(tr + 1), k(tr), k(1 - tr), k(2 - tr) of
//     host.cubic_kernel_weight (a = -0.5); bilinear: r0, r0 + 1 with
//     1 - tr, tr; the same along columns; a tap's weight wr * wc
//   per band, taps rows outer, columns inner: a tap counts where it lies
//     inside the stack and, with a nodata value, v != nodata and v is
//     finite; acc += v * w in one fused multiply-add (as addcmul_ rounds
//     on the card), mass += w (without a nodata value the mass is one for
//     all bands)
//   value: acc / mass where |mass| > 1e-6 and the centre lies in
//     [-0.5, H - 0.5] x [-0.5, W - 0.5], else fill
//   store: f32; or u16: NaN to code_nan, clamped to [0, 65535], truncated
//
// Every multiply, add, fused multiply-add and divide is an _rn intrinsic
// (the build uses no --use_fast_math), so nvcc contracts nothing else
// into an FMA and the product is the eager chain's on the card, bit for
// bit (tests_gpu).
//
// What bounds it on Hopper: one read of the stack and one write of the
// product. At the coregistration cell's 10 x 9140 x 9309 u16 that is
// 1.70 + 1.70 GB, 1.02 ms at 3.35 TB/s. The arithmetic (16 taps of a
// fused multiply-add a band-pixel, ~27 GFLOP) is far below the card's
// rate. Next come the instructions a band-pixel issues (16 gathers, two
// to make each u16 a float, a nodata test each, 16 FMAs, the IEEE
// divide and the cast: ~140, ~3.6 ms over the 851 M band-pixels at one
// warp instruction a scheduler and clock) and the gathers' latency. The
// design:
//
// - one thread a pixel, 32 x 8 threads a block over a tile of the
//   product, four blocks an SM (at most 64 registers a thread: 32 warps
//   hide the gathers' latency; two blocks at the ~120 registers nvcc
//   would take run 1.5 x slower); the band loop inside the thread;
// - once a pixel: the position, the floors, the 16 weights, which taps
//   lie inside the stack (rows and columns clamped, so every load is
//   unconditional) and the mass where every tap counts;
// - per band, a pixel whose 16 taps all lie inside loads its 4 x 4
//   neighbourhood through four row pointers and immediate column
//   offsets; where all 16 values count (no nodata, or a float not
//   finite, among them: one compare each) the sum is 16 FMAs and the
//   mass the precomputed one; elsewhere every tap takes the eager
//   chain's where(ok, v, 0) * where(ok, w, 0), branch-free;
// - the shift is smooth (a few px, and nearly the same across a tile),
//   so a warp's 16 gathers read neighbouring source pixels, and a tile's
//   4 x 4 neighbourhoods overlap in L1 and L2: the stack comes from
//   device memory about once;
// - a pixel whose centre lies outside the stack, or whose shared mass
//   fails (no nodata value), writes fill without a load;
// - a u16 code becomes a float through the float whose low mantissa bits
//   it fills (two full-rate instructions, where I2F runs at a quarter of
//   the rate); each band's store is one coalesced row of 32 values a
//   warp.
//
// Offsets are 64-bit: B * H * W may pass 2^31. The host refuses H or W
// of 2^24 or more (r and c must be exact in f32).
//
// C interface (built with nvcc into a shared library, loaded by ctypes):
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it does not
// take) so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int kMinBlocks = 4;   // blocks an SM: at most 64 registers
constexpr long long kMaxSide = 1LL << 24;

struct Params {
  long long b;
  int h, w;
  unsigned int tiles_x;
  double a[2][3];      // the affine, rows (dy, dx)
  const float* dy;     // (H, W) f32 fields, or null: the affine
  const float* dx;
  float nodata;
  int has_nodata;
  float fill;
  float code_nan;
  int out_u16;
};

// host.cubic_kernel_weight(x, a=-0.5) as its torch ops round it:
// ax**3 = (ax * ax) * ax, w1 = (1.5 ax^3 - 2.5 ax^2) + 1,
// w2 = ((-0.5 ax^3 - (-2.5 ax^2)) + (-4 ax)) - (-2)
__device__ __forceinline__ float cubic(float x) {
  const float ax = fabsf(x);
  const float ax2 = __fmul_rn(ax, ax);
  const float ax3 = __fmul_rn(ax2, ax);
  const float w1 = __fadd_rn(
      __fsub_rn(__fmul_rn(1.5f, ax3), __fmul_rn(2.5f, ax2)), 1.0f);
  const float w2 = __fadd_rn(
      __fadd_rn(__fsub_rn(__fmul_rn(-0.5f, ax3), __fmul_rn(-2.5f, ax2)),
                __fmul_rn(-4.0f, ax)),
      2.0f);
  return ax <= 1.0f ? w1 : (ax < 2.0f ? w2 : 0.0f);
}

// The kTaps weights at fraction t (warp.py _tap_fields).
template <int kTaps>
__device__ __forceinline__ void axis_weights(float t, float* wt) {
  if (kTaps == 4) {
    wt[0] = cubic(__fadd_rn(t, 1.0f));
    wt[1] = cubic(t);
    wt[2] = cubic(__fsub_rn(1.0f, t));
    wt[3] = cubic(__fsub_rn(2.0f, t));
  } else {
    wt[0] = __fsub_rn(1.0f, t);
    wt[1] = t;
  }
}

// A source value as float32, exactly: a u16 code through the float
// whose low mantissa bits it fills (two full-rate instructions, where
// I2F runs at a quarter of the rate).
__device__ __forceinline__ float load(const uint16_t* p) {
  return __fsub_rn(__uint_as_float(0x4B000000u | __ldg(p)), 8388608.0f);
}

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ void store(void* out, long long i, float v,
                                      const Params& p) {
  if (p.out_u16) {
    float q = isnan(v) ? p.code_nan : v;
    q = fminf(fmaxf(q, 0.0f), 65535.0f);
    static_cast<uint16_t*>(out)[i] = (uint16_t)__float2int_rz(q);
  } else {
    static_cast<float*>(out)[i] = v;
  }
}

// A value that counts where the stack has a nodata value: not nodata
// and, for floats, finite (a u16 code always is).
template <typename Src>
__device__ __forceinline__ bool good(float x, const Params& p) {
  return x != p.nodata && (sizeof(Src) == 2 || isfinite(x));
}

template <typename Src, int kTaps>
__global__ void __launch_bounds__(kBlockX * kBlockY, kMinBlocks)
deshift_warp_kernel(const Src* __restrict__ src, void* __restrict__ out,
                    const __grid_constant__ Params p) {
  constexpr unsigned int kAll = (1u << (kTaps * kTaps)) - 1u;
  const unsigned int ty = blockIdx.x / p.tiles_x;
  const unsigned int tx = blockIdx.x - ty * p.tiles_x;
  const int r = (int)(ty * kBlockY + threadIdx.y);
  const int c = (int)(tx * kBlockX + threadIdx.x);
  if (r >= p.h || c >= p.w) return;
  const long long plane = (long long)p.h * p.w;
  const long long o = (long long)r * p.w + c;
  const float rf = (float)r;
  const float cf = (float)c;

  float pr, pc;
  if (p.dy != nullptr) {
    pr = __fadd_rn(__ldg(p.dy + o), rf);
    pc = __fadd_rn(__ldg(p.dx + o), cf);
  } else {
    const double rd = (double)r, cd = (double)c;
    pr = __fadd_rn(__double2float_rn(__dadd_rn(
                       __dadd_rn(__dmul_rn(p.a[0][0], rd),
                                 __dmul_rn(p.a[0][1], cd)),
                       p.a[0][2])),
                   rf);
    pc = __fadd_rn(__double2float_rn(__dadd_rn(
                       __dadd_rn(__dmul_rn(p.a[1][0], rd),
                                 __dmul_rn(p.a[1][1], cd)),
                       p.a[1][2])),
                   cf);
  }
  const float hi_r = (float)((double)p.h - 0.5);
  const float hi_c = (float)((double)p.w - 0.5);
  const bool inside =
      pr >= -0.5f && pr <= hi_r && pc >= -0.5f && pc <= hi_c;
  if (!inside) {
    for (long long k = 0; k < p.b; ++k) store(out, k * plane + o, p.fill, p);
    return;
  }

  // inside: the floors lie in [-1, H - 1] and [-1, W - 1]
  const float fr = floorf(pr), fc = floorf(pc);
  float wr[kTaps], wc[kTaps];
  axis_weights<kTaps>(__fsub_rn(pr, fr), wr);
  axis_weights<kTaps>(__fsub_rn(pc, fc), wc);
  const int d0 = kTaps == 4 ? -1 : 0;
  const int r0 = (int)fr + d0, c0 = (int)fc + d0;
  // tap (i, j) is bit i * kTaps + j; its offset in a band plane, the
  // row and column clamped into the stack
  unsigned int in_range = 0;
  long long roff[kTaps];
  int ccl[kTaps];
#pragma unroll
  for (int i = 0; i < kTaps; ++i) {
    const int ri = r0 + i, ci = c0 + i;
    roff[i] = (long long)min(max(ri, 0), p.h - 1) * p.w;
    ccl[i] = min(max(ci, 0), p.w - 1);
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      const int cj = c0 + j;
      if (ri >= 0 && ri < p.h && cj >= 0 && cj < p.w) {
        in_range |= 1u << (i * kTaps + j);
      }
    }
  }
  float wt[kTaps][kTaps];
  float mass_all = 0.0f;   // the mass where every in-range tap counts
#pragma unroll
  for (int i = 0; i < kTaps; ++i) {
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      wt[i][j] = __fmul_rn(wr[i], wc[j]);
      if ((in_range >> (i * kTaps + j)) & 1u) {
        mass_all = __fadd_rn(mass_all, wt[i][j]);
      }
    }
  }
  // without a nodata value that is every band's mass
  if (!p.has_nodata && !(fabsf(mass_all) > 1e-6f)) {
    for (long long k = 0; k < p.b; ++k) store(out, k * plane + o, p.fill, p);
    return;
  }
  const bool interior = in_range == kAll;

  for (long long k = 0; k < p.b; ++k) {
    const Src* s = src + k * plane;
    float v[kTaps][kTaps];
    if (interior) {   // the columns c0 .. c0 + kTaps - 1, unclamped
#pragma unroll
      for (int i = 0; i < kTaps; ++i) {
        const Src* row = s + roff[i] + c0;
#pragma unroll
        for (int j = 0; j < kTaps; ++j) v[i][j] = load(row + j);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kTaps; ++i) {
#pragma unroll
        for (int j = 0; j < kTaps; ++j) v[i][j] = load(s + roff[i] + ccl[j]);
      }
    }
    // whether every value counts (not nodata and, for floats, finite)
    bool all_ok = true;
    if (p.has_nodata) {
#pragma unroll
      for (int i = 0; i < kTaps; ++i) {
#pragma unroll
        for (int j = 0; j < kTaps; ++j) all_ok = all_ok && good<Src>(v[i][j], p);
      }
    }
    float acc = 0.0f, mass;
    if (interior && all_ok) {
      // every tap counts: acc += v * w, and the mass is mass_all
#pragma unroll
      for (int i = 0; i < kTaps; ++i) {
#pragma unroll
        for (int j = 0; j < kTaps; ++j) acc = __fmaf_rn(v[i][j], wt[i][j], acc);
      }
      mass = mass_all;
    } else {
      // the eager chain's where(ok, v, 0) * where(ok, w, 0) at every tap
      mass = 0.0f;
#pragma unroll
      for (int i = 0; i < kTaps; ++i) {
#pragma unroll
        for (int j = 0; j < kTaps; ++j) {
          const bool t = ((in_range >> (i * kTaps + j)) & 1u) &&
                         (!p.has_nodata || good<Src>(v[i][j], p));
          const float wv = t ? wt[i][j] : 0.0f;
          acc = __fmaf_rn(t ? v[i][j] : 0.0f, wv, acc);
          mass = __fadd_rn(mass, wv);
        }
      }
    }
    const float val =
        fabsf(mass) > 1e-6f ? __fdiv_rn(acc, mass) : p.fill;
    store(out, k * plane + o, val, p);
  }
}

template <typename Src>
int launch(const Src* src, void* out, const Params& p, int cubic_taps,
           cudaStream_t st) {
  const long long tiles_y = (p.h + kBlockY - 1) / kBlockY;
  const long long blocks = tiles_y * (long long)p.tiles_x;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 block(kBlockX, kBlockY);
  if (cubic_taps) {
    deshift_warp_kernel<Src, 4><<<(unsigned int)blocks, block, 0, st>>>(
        src, out, p);
  } else {
    deshift_warp_kernel<Src, 2><<<(unsigned int)blocks, block, 0, st>>>(
        src, out, p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// src (b, h, w) u16 (src_u16) or f32, contiguous, on the card; out
// (b, h, w) u16 (out_u16) or f32, contiguous. affine: 6 host doubles,
// rows (dy, dx); dy / dx: (h, w) f32 on the card, or both null for the
// affine. cubic: 1 for cubic, 0 for bilinear.
extern "C" int deshift_warp(const void* src, int src_u16, void* out,
                            int out_u16, long long b, long long h,
                            long long w, const double* affine,
                            const float* dy, const float* dx, int cubic,
                            int has_nodata, float nodata, float fill,
                            float code_nan, void* stream) {
  if (b <= 0 || h <= 0 || w <= 0) return (int)cudaSuccess;
  if (h >= kMaxSide || w >= kMaxSide || (dy == nullptr) != (dx == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.b = b;
  p.h = (int)h;
  p.w = (int)w;
  p.tiles_x = (unsigned int)((w + kBlockX - 1) / kBlockX);
  for (int i = 0; i < 6; ++i) p.a[i / 3][i % 3] = affine[i];
  p.dy = dy;
  p.dx = dx;
  p.nodata = nodata;
  p.has_nodata = has_nodata;
  p.fill = fill;
  p.code_nan = code_nan;
  p.out_u16 = out_u16;
  cudaStream_t st = (cudaStream_t)stream;
  if (src_u16) {
    return launch(static_cast<const uint16_t*>(src), out, p, cubic, st);
  }
  return launch(static_cast<const float*>(src), out, p, cubic, st);
}
