// The same-CRS grid transfer of kernels/warp.py resample_tensor_to_grid
// for bilinear and cubic: the separable row pass, the column pass, the
// nodata mass through the same taps and the renormalisation, in one pass
// that reads the (Hs, Ws, B) source and writes the (Hd, Wd, B) f32
// result once.
//
// It replaces no TPU kernel: the JAX package leaves the same-CRS transfer
// to two XLA dots over dense (Dst, Src) weight matrices
// (hyperres/kernels/warp.py:1155). The port's dense route
// (separable_resample_matmul) made those products in f32 on the card,
// twice with a nodata value (values and valid mass): 614 GFLOP of SIMT
// GEMMs for the coregistration's 1523 x 1550 -> 9140 x 9309 cubic
// transfer, where 4 taps an axis are non-zero.
//
// For output (d, e), band k, as warp.py separable_resample_matmul and
// _renormalise compute it on the card:
//
//   taps: the host's per-axis taps (host.separable_tap_table, through
//     kernels/sep_resample.py): a start index s and T = 4 (cubic) or 2
//     (bilinear) f32 weights per destination index, tap-major, weight 0
//     for a dropped tap; taps outside the source are skipped (the dense
//     matrix has no such column)
//   row pass: t(d, c) = sum over row taps i, ascending, of
//     w_r(d, i) * x(s_r(d) + i, c), each term one fused multiply-add
//     from 0, as the GEMM's sequential f32 accumulation (its zero terms
//     add nothing); with a nodata value x is where(ok, v, 0) and the
//     mass m(d, c) is the same sum over ok (v != nodata and v finite)
//   column pass: num(d, e) = the same sum of w_c(e, j) * t(d, s_c(e) + j),
//     and the mass likewise; without a nodata value the mass is the
//     product of the two axes' weight sums (the host's, in f32)
//   value: num / mass (IEEE divide) where |mass| > 1e-6, else fill
//
// Every multiply and divide is an _rn intrinsic (the build uses no
// --use_fast_math), so nvcc contracts nothing else.
//
// What bounds it on Hopper: one write of the f32 result. At the
// coregistration's 9140 x 9309 x 1 that is 340 MB, ~0.10 ms at 3.35 TB/s;
// the source (9.4 MB) is read about once. Next come the instructions
// an output issues (two T-tap sums, the divide, the store: ~35) and the
// shared-memory reads of the row pass's results. The design:
//
// - a block of 256 threads takes a tile of TR destination rows x TE
//   destination columns x BC bands (TE * BC <= 256), and first makes the
//   row pass for the TR rows over the source columns its taps reach
//   (span columns from the tile's least start, the host's per-tile
//   table), into shared memory as (value, mass) pairs; so one kernel
//   serves an upsample (the cell's 6x: ~47 columns for 256) and a
//   downsample (~6 x 256) alike, the host choosing TE and TR so that
//   the stage fits 48 KB;
// - then each thread takes one (column, band) of the tile, keeps its
//   column taps in registers and walks down the TR rows: T paired
//   shared loads, 2 T fused multiply-adds, the divide and one store a
//   row; a warp's stores are 32 neighbouring floats (rows of 9309
//   floats are not 16-byte aligned, so no wider store);
// - the row pass's source loads are coalesced along the source row, and
//   their validity is tested once per load.
//
// Offsets into the source and the result are 64-bit. C interface (built
// with nvcc into a shared library, loaded by ctypes): launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 48 * 1024;

struct Params {
  int hs, ws, hd, wd, b;
  int bc, nbc;          // bands a block, band chunks
  int tr, te, span;     // tile rows, tile columns, staged source columns
  int tiles_c;
  const int* start_r;   // (hd) first row tap
  const int* start_c;   // (wd) first column tap
  const int* lo_c;      // (tiles_c) least column start of each tile
  const float* w_r;     // (T, hd), tap-major
  const float* w_c;     // (T, wd)
  const float* sum_r;   // (hd) weight sums (no nodata value)
  const float* sum_c;   // (wd)
  float nodata, fill;
};

template <int T, bool kMass>
__global__ void __launch_bounds__(kThreads)
sep_resample_kernel(const float* __restrict__ src, float* __restrict__ out,
                    const __grid_constant__ Params p) {
  extern __shared__ float2 stage[];   // (tr, span, bc): (value, mass)
  unsigned int blk = blockIdx.x;
  const int kc = (int)(blk % (unsigned int)p.nbc);
  blk /= (unsigned int)p.nbc;
  const int tc = (int)(blk % (unsigned int)p.tiles_c);
  const int d0 = (int)(blk / (unsigned int)p.tiles_c) * p.tr;
  const int e0 = tc * p.te;
  const int b0 = kc * p.bc;
  const int nb = min(p.bc, p.b - b0);
  const int nr = min(p.tr, p.hd - d0);
  const int ne = min(p.te, p.wd - e0);
  const int lo = p.lo_c[tc];

  // the row pass over the tile's source columns
  const int row_len = p.span * nb;
  const int n1 = nr * row_len;
  for (int i = threadIdx.x; i < n1; i += kThreads) {
    const int dr = i / row_len;
    const int j = i - dr * row_len;
    const int cl = j / nb;
    const int k = j - cl * nb;
    const int c = lo + cl;
    const int d = d0 + dr;
    float acc = 0.0f, mass = 0.0f;
    if (c >= 0 && c < p.ws) {
      const int r0 = __ldg(p.start_r + d);
      const float* col = src + (long long)c * p.b + b0 + k;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int r = r0 + t;
        if (r >= 0 && r < p.hs) {
          const float wt = __ldg(p.w_r + (long long)t * p.hd + d);
          const float v = __ldg(col + (long long)r * p.ws * p.b);
          if (kMass) {
            const bool ok = v != p.nodata && isfinite(v);
            acc = __fmaf_rn(wt, ok ? v : 0.0f, acc);
            mass = __fmaf_rn(wt, ok ? 1.0f : 0.0f, mass);
          } else {
            acc = __fmaf_rn(wt, v, acc);
          }
        }
      }
    }
    stage[(dr * p.span + cl) * p.bc + k] = make_float2(acc, mass);
  }
  __syncthreads();

  // the column pass: one (column, band) a thread, down the tile's rows
  const int q = threadIdx.x;
  if (q >= ne * nb) return;
  const int el = q / nb;
  const int k = q - el * nb;
  const int e = e0 + el;
  const int co = __ldg(p.start_c + e) - lo;
  float wc[T];
#pragma unroll
  for (int t = 0; t < T; ++t) wc[t] = __ldg(p.w_c + (long long)t * p.wd + e);
  const float csum = kMass ? 0.0f : __ldg(p.sum_c + e);
  float* dst = out + ((long long)d0 * p.wd + e) * p.b + b0 + k;
  const long long row_stride = (long long)p.wd * p.b;
  for (int dr = 0; dr < nr; ++dr) {
    const float2* s = stage + (dr * p.span + co) * p.bc + k;
    float num = 0.0f, mass = 0.0f;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float2 v = s[t * p.bc];
      num = __fmaf_rn(wc[t], v.x, num);
      if (kMass) mass = __fmaf_rn(wc[t], v.y, mass);
    }
    if (!kMass) mass = __fmul_rn(__ldg(p.sum_r + d0 + dr), csum);
    dst[dr * row_stride] = fabsf(mass) > 1e-6f ? __fdiv_rn(num, mass) : p.fill;
  }
}

template <int T>
int launch(const float* src, float* out, const Params& p, int has_nodata,
           unsigned int blocks, size_t smem, cudaStream_t st) {
  if (has_nodata) {
    sep_resample_kernel<T, true><<<blocks, kThreads, smem, st>>>(src, out, p);
  } else {
    sep_resample_kernel<T, false><<<blocks, kThreads, smem, st>>>(src, out, p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// src (hs, ws, b) f32, contiguous, on the card; out (hd, wd, b) f32,
// contiguous. taps: 2 (bilinear) or 4 (cubic). start_r, start_c, lo_c,
// w_r, w_c, sum_r, sum_c: the host's packed taps on the card (see
// Params). tr, te, bc, span: the tile the host chose.
extern "C" int sep_resample(const float* src, float* out, long long hs,
                            long long ws, long long hd, long long wd,
                            long long b, int taps, const int* start_r,
                            const int* start_c, const int* lo_c,
                            const float* w_r, const float* w_c,
                            const float* sum_r, const float* sum_c, int tr,
                            int te, int bc, int span, int has_nodata,
                            float nodata, float fill, void* stream) {
  if (hd <= 0 || wd <= 0 || b <= 0) return (int)cudaSuccess;
  const long long lim = 0x7fffffffLL;
  if (hs <= 0 || ws <= 0 || hs > lim || ws > lim || hd > lim || wd > lim ||
      b > lim || (taps != 2 && taps != 4) || tr < 1 || te < 1 || bc < 1 ||
      bc > b || span < taps || (long long)te * bc > kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)tr * span * bc * sizeof(float2);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  Params p;
  p.hs = (int)hs;
  p.ws = (int)ws;
  p.hd = (int)hd;
  p.wd = (int)wd;
  p.b = (int)b;
  p.bc = bc;
  p.nbc = (int)((b + bc - 1) / bc);
  p.tr = tr;
  p.te = te;
  p.span = span;
  p.tiles_c = (int)((wd + te - 1) / te);
  p.start_r = start_r;
  p.start_c = start_c;
  p.lo_c = lo_c;
  p.w_r = w_r;
  p.w_c = w_c;
  p.sum_r = sum_r;
  p.sum_c = sum_c;
  p.nodata = nodata;
  p.fill = fill;
  const long long blocks =
      ((hd + tr - 1) / tr) * (long long)p.tiles_c * p.nbc;
  if (blocks > lim) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (taps == 4) {
    return launch<4>(src, out, p, has_nodata, (unsigned int)blocks, smem, st);
  }
  return launch<2>(src, out, p, has_nodata, (unsigned int)blocks, smem, st);
}
