// Log-domain Sinkhorn duals: the sweeps of pallas_sinkhorn_duals.
//
// Mr (n, m) is the regularised negative cost -M / reg, log_a (n) and
// log_b (m) the log marginals. One sweep does, for every row i,
//
//   z = Mr[i] + g,  rmax = max z,  E = exp(z - rmax),  rowsum = sum E,
//   rlse = rmax + log rowsum,  a_i = exp(log_a_i),
//   err_i = |exp(f_i + rlse) - a_i|      (row marginal of the previous iterate)
//   f_i = log_a_i - rlse,
//   s_col += E * (a_i / rowsum),
//
// and then g = log_b - log(max(s_col, 1e-37)) + g. The host runs groups
// of sweeps and reads err = sum_i err_i of the last sweep of each group
// (kernels/sinkhorn_duals.py holds the loop, the stopping rule and the
// choice of route).
//
// Replaces the TPU kernel pallas_sinkhorn_duals
// (hyperres/kernels/pallas_ops.py:605), which keeps the whole cost matrix
// in VMEM (5120^2 f32 at most) and runs every sweep in one program, with
// the column sum reusing the row pass's exponentials held in vregs. The
// TPU pads n to 128-row blocks and m to 128 lanes with -1e30 entries that
// add exact zeros; here nothing is padded.
//
// What bounds it on Hopper: memory. At the fused plan's shape (n = m =
// 5000, OTConfig()) Mr is 100 MB, twice the 50 MB L2, so every sweep
// streams it from HBM: one read is ~30 us at 3.35 TB/s. The exps (n m
// expf per sweep) stay below that. Two routes, chosen by shape on the
// host (sinkhorn_duals.py:sinkhorn_route), and the earlier two-read
// kernels kept for timing beside them:
//
// One pass (m <= kOnePassCols): Mr is read once per sweep, as the TPU
// kernel reads it.
//   - one persistent block of 512 threads per SM owns a fixed contiguous
//     range of rows; it brings a group of 2 rows at a time into shared
//     memory through a ring of 4 buffers: the next 3 groups' copies are
//     in flight while this group is worked on (with one group ahead the
//     block waited on memory latency). A group is one contiguous span, so
//     it goes by 16-byte cp.async.cg (L2 only) whatever m is, with <= 3
//     4-byte copies at each end (4-byte cp.async.ca through L1, for every
//     element, reached ~1/4 of HBM peak);
//   - thread t owns columns j = t + 512 k (k < 12) for the arithmetic and
//     keeps g_j, its column partials and the group's z / E values in
//     registers, so shared memory is read once per element;
//   - per group: z = Mr + g and the rows' maxima (one block reduction for
//     all the group's rows), then E = exp(z - rmax) in place and the rows'
//     sums (one reduction), then f_i, err_i and u_i = a_i / rowsum_i as in
//     the row kernel below; then the column partials reuse E, s_j += E_ij
//     u_i: one expf per element (the two-read route takes two);
//   - at the end each block writes one row of partials (G x m, G = the
//     blocks, 2.6 MB at 5000^2 on 132 SMs) and sinkhorn_g_rows_kernel sums
//     them in a fixed order (8 contiguous runs of rows, then the 8 run
//     sums): two launches per sweep, HBM traffic one read of Mr plus the
//     partials.
// Long rows (the rest; few rows, each longer than a block can hold): the
// rows are cut into column slices so that the grid fills the card
// whatever n is. Two launches per sweep (three when the column pass is
// also cut along the rows):
//   - slice kernel: a block takes a slice of 4096 columns of a few rows;
//     each of its 8 warps owns 512 of the columns (16 per lane, 16-byte
//     loads when the rows are 16-byte aligned, g for them in registers)
//     and, per row, takes max and sum of exp in ONE read: the 16 values
//     stay in registers between the two, a butterfly each, no block
//     barrier; the next row's loads are issued before this row's
//     reductions. The warps' (max, sum) pairs of each row are merged in warp
//     order (sum_w s_w exp(m_w - max)) and written per (row, slice). The
//     block that finishes a group of rows last (one counter per group,
//     set back to 0 by that block) merges the slices' pairs of the
//     group's rows, a warp per row in a fixed order, into rmax_i and
//     rowsum_i, hence rlse_i, f_i, err_i and u_i = a_i / rowsum_i, in
//     global memory: no merge launch, and the column kernel has no
//     prologue;
//   - column kernel: a block of 8 warps takes 128 columns (4 per lane,
//     one 16-byte load per row where the rows are 16-byte aligned) and
//     all rows (or a chunk of them when the columns alone do not fill the
//     card). The warps take every 8th row, last row first (Mr is about an
//     L2 in size on this route and the slice kernel went first row to
//     last, so this read finds the later rows still in L2), s_j = sum_i
//     exp(Mr_ij + g_j - rmax_i) u_i, the warps' sums added in warp order;
//     with one chunk the block owns its columns whole and updates g_j
//     itself; with more, the partials go to the g kernel below.
// Two reads (kept for timing beside both routes): three launches per sweep.
//   - row kernel: one block per row, a max pass and an exp/sum pass,
//     reads along the row coalesced with 4-byte loads; it writes f_i,
//     rmax_i, u_i = a_i / rowsum_i and err_i. At n = 128 that is 128
//     blocks on 132 SMs, each streaming a 400 KB row twice: too little in
//     flight (116.82 us per sweep at 128 x 100,000 on an H100);
//   - column kernel: as above without the prologue, always into partials;
//   - g kernel: sums the chunks' partials in chunk order and updates g.
// Every reduction runs in a fixed order (no float atomics), so two runs
// on one card give the same bits; the one-pass result depends on the
// number of blocks (the card's SM count), so it is reproducible on one
// card model, not across SM counts. exp and log are the full-precision
// expf / logf.
//
// C interface (built with nvcc into a shared library, loaded by ctypes):
// launches on the caller's stream, allocates nothing, and returns the
// first launch error (cudaGetLastError) so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;
constexpr int kColThreads = 256;
constexpr int kSumThreads = 1024;
constexpr int kOneThreads = 512;               // one-pass block
constexpr int kOneWarps = kOneThreads / 32;
constexpr int kSlots = 12;                     // columns per thread
constexpr int kOnePassCols = kSlots * kOneThreads;   // 6144
constexpr int kMaxRows = 2;                    // rows per group
constexpr int kStages = 4;                     // groups in shared memory

template <bool kMax>
__device__ __forceinline__ float combine(float a, float b) {
  return kMax ? fmaxf(a, b) : a + b;
}

// Block-wide reduction in a fixed order: a butterfly inside each warp,
// then the warps' results by the first warp. Every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float v, float* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = combine<kMax>(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  __syncthreads();  // sh may still be read from an earlier reduction
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < n_warps ? sh[lane] : (kMax ? -INFINITY : 0.0f);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v = combine<kMax>(v, __shfl_xor_sync(0xffffffffu, v, o));
    }
    if (lane == 0) sh[32] = v;
  }
  __syncthreads();
  return sh[32];
}

__global__ void __launch_bounds__(kRowThreads)
sinkhorn_row_kernel(const float* __restrict__ Mr, const float* __restrict__ g,
                    const float* __restrict__ log_a, float* __restrict__ f,
                    float* __restrict__ rmax_out, float* __restrict__ u_out,
                    float* __restrict__ err_row, int64_t m) {
  __shared__ float sh[33];
  const int64_t i = blockIdx.x;
  const float* row = Mr + i * m;

  float mx = -INFINITY;
  for (int64_t j = threadIdx.x; j < m; j += kRowThreads) {
    mx = fmaxf(mx, row[j] + g[j]);
  }
  mx = block_reduce<true>(mx, sh);

  float s = 0.0f;
  for (int64_t j = threadIdx.x; j < m; j += kRowThreads) {
    s += expf((row[j] + g[j]) - mx);
  }
  s = block_reduce<false>(s, sh);

  if (threadIdx.x == 0) {
    const float rlse = mx + logf(s);
    const float la = log_a[i];
    const float a = expf(la);
    err_row[i] = fabsf(expf(f[i] + rlse) - a);
    f[i] = la - rlse;
    rmax_out[i] = mx;
    u_out[i] = a / s;
  }
}

__global__ void __launch_bounds__(kColThreads)
sinkhorn_col_kernel(const float* __restrict__ Mr, const float* __restrict__ g,
                    const float* __restrict__ rmax,
                    const float* __restrict__ u, float* __restrict__ partial,
                    int64_t n, int64_t m, int64_t rows_per_chunk) {
  const int64_t j = (int64_t)blockIdx.x * kColThreads + threadIdx.x;
  if (j >= m) return;
  const int64_t i0 = (int64_t)blockIdx.y * rows_per_chunk;
  const int64_t i1 = i0 + rows_per_chunk < n ? i0 + rows_per_chunk : n;
  const float gj = g[j];
  float s = 0.0f;
#pragma unroll 8
  for (int64_t i = i0; i < i1; ++i) {
    s += expf((Mr[i * m + j] + gj) - __ldg(rmax + i)) * __ldg(u + i);
  }
  partial[(int64_t)blockIdx.y * m + j] = s;
}

__global__ void __launch_bounds__(kColThreads)
sinkhorn_g_kernel(const float* __restrict__ partial,
                  const float* __restrict__ log_b, float* __restrict__ g,
                  int64_t m, int chunks) {
  const int64_t j = (int64_t)blockIdx.x * kColThreads + threadIdx.x;
  if (j >= m) return;
  float s = 0.0f;
  // unrolled so that the loads are in flight together; the sum keeps its
  // order
#pragma unroll 16
  for (int c = 0; c < chunks; ++c) s += partial[(int64_t)c * m + j];
  // the floor must be a normal f32 (1e-38 is subnormal)
  g[j] = (log_b[j] - logf(fmaxf(s, 1e-37f))) + g[j];
}

// ---- the long-rows route: column slices --------------------------------

constexpr int kSliceWarps = 8;
constexpr int kSliceThreads = 32 * kSliceWarps;
constexpr int kLaneCols = 16;                       // columns per lane
constexpr int kWarpCols = 32 * kLaneCols;           // 512 per warp
constexpr int kSliceCols = kSliceWarps * kWarpCols; // 4096 per block
constexpr int kSliceMaxRows = 64;                   // rows per block

// (max, sum of exp) of rows [blockIdx.y * rows_per_block, +rows_per_block)
// over the columns [blockIdx.x * kSliceCols, +kSliceCols) of Mr + g, one
// pair per row and slice into pmax / psum (n x gridDim.x). kVec: rows are
// 16-byte aligned (m % 4 == 0 and Mr aligned), lane l holds columns
// 4 (32 q + l) .. + 3 of its warp's 512 (q < 4); otherwise 32 q + l
// (q < 16).
// The block that finishes a row group last (a counter per group, left at
// 0 again) merges the group's pairs, a warp per row: each lane the slices
// lane, lane + 32, ... in order, then a butterfly over the lanes' pairs (a
// fixed order, whichever block runs it), into rmax_i, u_i = a_i / rowsum_i,
// err_i and f_i.
template <bool kVec>
__global__ void __launch_bounds__(kSliceThreads)
sinkhorn_slice_kernel(const float* __restrict__ Mr,
                      const float* __restrict__ g,
                      const float* __restrict__ log_a, float* pmax,
                      float* psum, float* __restrict__ f,
                      float* __restrict__ rmax_out, float* __restrict__ u_out,
                      float* __restrict__ err_row, unsigned int* counters,
                      int64_t n, int64_t m, int rows_per_block) {
  __shared__ float wmax[kSliceWarps][kSliceMaxRows];
  __shared__ float wsum[kSliceWarps][kSliceMaxRows];
  __shared__ bool last_block;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t c0 = (int64_t)blockIdx.x * kSliceCols + warp * kWarpCols;
  const int64_t i0 = (int64_t)blockIdx.y * rows_per_block;
  const int nr = (int)(n - i0 < rows_per_block ? n - i0 : rows_per_block);

  // column k of this lane, as an offset from c0
  auto col_of = [&](int k) {
    return kVec ? 4 * (32 * (k >> 2) + lane) + (k & 3) : 32 * k + lane;
  };
  const int left = (int)(m - c0 < kWarpCols ? m - c0 : kWarpCols);  // <= 0: none
  float gj[kLaneCols];
#pragma unroll
  for (int k = 0; k < kLaneCols; ++k) {
    gj[k] = col_of(k) < left ? g[c0 + col_of(k)] : 0.0f;
  }
  // a row's 16 values of this lane (0 past the row's end)
  auto load_row = [&](int r, float (&v)[kLaneCols]) {
    const float* row = Mr + (i0 + r) * m + c0;
    if (kVec) {
#pragma unroll
      for (int q = 0; q < kLaneCols / 4; ++q) {
        float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (col_of(4 * q) < left) {   // m % 4 == 0: all four or none
          t = *reinterpret_cast<const float4*>(row + col_of(4 * q));
        }
        v[4 * q] = t.x;
        v[4 * q + 1] = t.y;
        v[4 * q + 2] = t.z;
        v[4 * q + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kLaneCols; ++k) {
        v[k] = col_of(k) < left ? row[col_of(k)] : 0.0f;
      }
    }
  };
  float raw[kLaneCols];
  if (nr > 0) load_row(0, raw);
  for (int r = 0; r < nr; ++r) {
    float z[kLaneCols];
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < kLaneCols; ++k) {
      z[k] = col_of(k) < left ? raw[k] + gj[k] : -INFINITY;
      mx = fmaxf(mx, z[k]);
    }
    // the next row's loads are in flight while this one is reduced
    if (r + 1 < nr) load_row(r + 1, raw);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    float sum = 0.0f;
    if (left > 0) {   // else the warp holds no column: (-inf, 0)
#pragma unroll
      for (int k = 0; k < kLaneCols; ++k) sum += expf(z[k] - mx);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    }
    if (lane == 0) {
      wmax[warp][r] = mx;
      wsum[warp][r] = sum;
    }
  }
  __syncthreads();
  // the block's pair of each row: its warps' pairs in warp order (warp 0
  // always holds a column, so the max is finite; exp(-inf) adds 0)
  for (int r = threadIdx.x; r < nr; r += kSliceThreads) {
    float mx = wmax[0][r];
#pragma unroll
    for (int w = 1; w < kSliceWarps; ++w) mx = fmaxf(mx, wmax[w][r]);
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kSliceWarps; ++w) {
      sum += wsum[w][r] * expf(wmax[w][r] - mx);
    }
    pmax[(i0 + r) * gridDim.x + blockIdx.x] = mx;
    psum[(i0 + r) * gridDim.x + blockIdx.x] = sum;
  }
  // this block's pairs are out before its count is
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int before = atomicAdd(&counters[blockIdx.y], 1u);
    last_block = before == gridDim.x - 1;
    if (last_block) counters[blockIdx.y] = 0u;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const int n_slices = (int)gridDim.x;
  for (int r = warp; r < nr; r += kSliceWarps) {
    const int64_t i = i0 + r;
    const float* pm = pmax + i * n_slices;
    const float* ps = psum + i * n_slices;
    float mx = -INFINITY, sum = 0.0f;
    for (int c = lane; c < n_slices; c += 32) {
      // other blocks wrote these: read them past L1
      const float pmc = __ldcg(pm + c);
      const float nmx = fmaxf(mx, pmc);   // finite: every slice has columns
      sum = sum * expf(mx - nmx) + __ldcg(ps + c) * expf(pmc - nmx);
      mx = nmx;
    }
    float all = mx;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      all = fmaxf(all, __shfl_xor_sync(0xffffffffu, all, o));
    }
    sum = mx == -INFINITY ? 0.0f : sum * expf(mx - all);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    }
    if (lane == 0) {
      const float rlse = all + logf(sum);
      const float la = log_a[i];
      const float a = expf(la);
      err_row[i] = fabsf(expf(f[i] + rlse) - a);
      f[i] = la - rlse;
      rmax_out[i] = all;
      u_out[i] = a / sum;
    }
  }
}

constexpr int kColWarps = kColThreads / 32;
constexpr int kColCols = 128;   // columns per block: 4 per lane

// The column pass over rows [blockIdx.y * rows_per_chunk, +rows_per_chunk)
// for the columns [blockIdx.x * 128, +128): lane l holds 4 of them (4 l ..
// 4 l + 3 with kVec, one 16-byte load per row; else l, l + 32, ...), the 8
// warps take every 8th row, last row first, and their sums are added in
// warp order. kFinal (one chunk): g is updated here; otherwise the chunk's
// partial column sums are written.
template <bool kVec, bool kFinal>
__global__ void __launch_bounds__(kColThreads)
sinkhorn_col_sliced_kernel(const float* __restrict__ Mr, float* g,
                           const float* __restrict__ log_b,
                           const float* __restrict__ rmax,
                           const float* __restrict__ u,
                           float* __restrict__ partial, int64_t n, int64_t m,
                           int rows_per_chunk) {
  __shared__ float red[kColWarps][kColCols];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t j0 = (int64_t)blockIdx.x * kColCols;
  const int left = (int)(m - j0 < kColCols ? m - j0 : kColCols);
  const int64_t i0 = (int64_t)blockIdx.y * rows_per_chunk;
  const int nr = (int)(n - i0 < rows_per_chunk ? n - i0 : rows_per_chunk);
  auto col_of = [&](int q) { return kVec ? 4 * lane + q : lane + 32 * q; };
  float gj[4], acc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    gj[q] = col_of(q) < left ? g[j0 + col_of(q)] : 0.0f;
    acc[q] = 0.0f;
  }
  // last row first: the slice kernel ended on the last rows, so these
  // reads find in L2 what it still holds of them (and end on the first
  // rows, where the next sweep's slice kernel starts)
#pragma unroll 4
  for (int r = nr - 1 - warp; r >= 0; r -= kColWarps) {
    const float* row = Mr + (i0 + r) * m + j0;
    const float rm = __ldg(rmax + i0 + r);
    const float ur = __ldg(u + i0 + r);
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (kVec) {
      if (col_of(0) < left) {   // m % 4 == 0: all four or none
        const float4 t = *reinterpret_cast<const float4*>(row + col_of(0));
        v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (col_of(q) < left) v[q] = row[col_of(q)];
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += expf((v[q] + gj[q]) - rm) * ur;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) red[warp][col_of(q)] = acc[q];
  __syncthreads();
  if (threadIdx.x < left) {
    float s = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kColWarps; ++w) s += red[w][threadIdx.x];
    const int64_t j = j0 + threadIdx.x;
    if (kFinal) {
      g[j] = (log_b[j] - logf(fmaxf(s, 1e-37f))) + g[j];
    } else {
      partial[(int64_t)blockIdx.y * m + j] = s;
    }
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Shift (in floats, 0-3) at which a span starting at src is placed in a
// 16-byte-aligned buffer so that its 16-byte-aligned body stays aligned.
__device__ __forceinline__ int span_shift(const float* src) {
  return (int)(((uintptr_t)src >> 2) & 3);
}

// Copies the n floats at src into shared memory at dst + span_shift(src):
// the 16-byte-aligned body by 16-byte cp.async (through L2 only), the <= 3
// floats at each end by 4-byte ones. Every thread of the block takes part.
__device__ __forceinline__ void copy_span(float* dst, const float* src,
                                          int64_t n) {
  const int sh = span_shift(src);
  const int head = (int)((4 - sh) & 3) < n ? (4 - sh) & 3 : (int)n;
  const int64_t body = (n - head) / 4;
  const int64_t tail0 = head + 4 * body;
  dst += sh;
  if (threadIdx.x < head) cp_async4(dst + threadIdx.x, src + threadIdx.x);
  for (int64_t q = threadIdx.x; q < body; q += blockDim.x) {
    cp_async16(dst + head + 4 * q, src + head + 4 * q);
  }
  if (threadIdx.x < n - tail0) {
    cp_async4(dst + tail0 + threadIdx.x, src + tail0 + threadIdx.x);
  }
}

// A reduction of each of the group's rows over the block, in a fixed
// order: a butterfly inside each warp, the warps' results through shared
// memory, then a butterfly over those in every warp, so every thread gets
// the same result. `red` is kMaxRows x kOneWarps; a caller alternates two
// buffers so that one barrier per reduction suffices.
template <bool kMax>
__device__ __forceinline__ void reduce_rows(float (&v)[kMaxRows],
                                            float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v[r] = combine<kMax>(v[r], __shfl_xor_sync(0xffffffffu, v[r], o));
    }
    if (lane == 0) red[r * kOneWarps + warp] = v[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
    v[r] = red[r * kOneWarps + (lane & (kOneWarps - 1))];
#pragma unroll
    for (int o = kOneWarps / 2; o > 0; o >>= 1) {
      v[r] = combine<kMax>(v[r], __shfl_xor_sync(0xffffffffu, v[r], o));
    }
  }
}

// One sweep's row update and column partials from one read of Mr; rows
// [blockIdx.x * rows_per_block, +rows_per_block), `rows` (<= kMaxRows) of
// them per group.
__global__ void __launch_bounds__(kOneThreads, 1)
sinkhorn_onepass_kernel(const float* __restrict__ Mr,
                        const float* __restrict__ g,
                        const float* __restrict__ log_a,
                        float* __restrict__ f, float* __restrict__ err_row,
                        float* __restrict__ partial, int64_t n, int m,
                        int64_t rows_per_block, int rows) {
  extern __shared__ float sm[];
  float* red_max = sm;
  float* red_sum = red_max + kMaxRows * kOneWarps;
  // kStages buffers of rows * m + 4 floats, 16-byte aligned
  float* buf = red_sum + kMaxRows * kOneWarps;
  const int64_t buf_len = ((int64_t)rows * m + 4 + 3) / 4 * 4;
  const int tid = threadIdx.x;
  // the warp's first column: slot loops stop where it passes m (warp-
  // uniform), so no warp issues slots that hold no column
  const int warp_j0 = tid & ~31;
  const int64_t i0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t i1 = i0 + rows_per_block < n ? i0 + rows_per_block : n;
  const int64_t n_groups = i1 > i0 ? (i1 - i0 + rows - 1) / rows : 0;

  float gj[kSlots], acc[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int j = tid + k * kOneThreads;
    gj[k] = j < m ? g[j] : 0.0f;
    acc[k] = 0.0f;
  }
  // group q (rows [i0 + q rows, +rows), one contiguous span of Mr) into
  // buffer q % kStages, as one commit group (empty past the last group,
  // so that every iteration waits on the same count)
  auto issue = [&](int64_t q) {
    if (q < n_groups) {
      const int64_t r0 = i0 + q * rows;
      const int64_t nrows = i1 - r0 < rows ? i1 - r0 : rows;
      copy_span(buf + (q % kStages) * buf_len, Mr + r0 * m, nrows * m);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

#pragma unroll
  for (int q = 0; q < kStages - 1; ++q) issue(q);
  for (int64_t q = 0; q < n_groups; ++q) {
    // buffer (q - 1) % kStages held group q - 1, which every thread read
    // into registers before that group's first reduction barrier
    issue(q + kStages - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    __syncthreads();   // group q's copies, made by all threads, landed
    const int64_t r0 = i0 + q * rows;
    const int nr = (int)(i1 - r0 < rows ? i1 - r0 : rows);
    const float* grp = buf + (q % kStages) * buf_len + span_shift(Mr + r0 * m);
    // the group's log marginals and duals, loaded before the reductions
    // need them (a load after a barrier would stall every warp)
    float la[kMaxRows], fo[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      la[r] = r < nr ? log_a[r0 + r] : 0.0f;
      fo[r] = r < nr ? f[r0 + r] : 0.0f;
    }

    // z = Mr + g into registers, the rows' maxima
    float z[kMaxRows][kSlots], mx[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      mx[r] = -INFINITY;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int j = tid + k * kOneThreads;
        z[r][k] = -INFINITY;
        if (r < nr && warp_j0 + k * kOneThreads < m && j < m) {
          z[r][k] = grp[r * m + j] + gj[k];
          mx[r] = fmaxf(mx[r], z[r][k]);
        }
      }
    }
    reduce_rows<true>(mx, red_max);

    // E = exp(z - rmax) in place, the rows' sums
    float s[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      s[r] = 0.0f;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (r < nr && warp_j0 + k * kOneThreads < m) {
          z[r][k] = expf(z[r][k] - mx[r]);   // exp(-inf) = 0 off the row
          s[r] += z[r][k];
        }
      }
    }
    reduce_rows<false>(s, red_sum);

    // f_i, err_i, u_i per row, then the column partials from E
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) {
      if (r >= nr) break;
      const int64_t i = r0 + r;
      const float rlse = mx[r] + logf(s[r]);
      const float a = expf(la[r]);
      const float u = a / s[r];
      if (tid == 0) {
        err_row[i] = fabsf(expf(fo[r] + rlse) - a);
        f[i] = la[r] - rlse;
      }
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (warp_j0 + k * kOneThreads < m) acc[k] += z[r][k] * u;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int j = tid + k * kOneThreads;
    if (j < m) partial[(int64_t)blockIdx.x * m + j] = acc[k];
  }
}

// The one-pass route's g update: a block per 32 columns; warp w sums the
// partial rows [w c / 8, (w + 1) c / 8) for its lane's column, then warp 0
// adds the 8 warp sums in warp order.
__global__ void __launch_bounds__(256)
sinkhorn_g_rows_kernel(const float* __restrict__ partial,
                       const float* __restrict__ log_b, float* __restrict__ g,
                       int64_t m, int rows) {
  __shared__ float sh[8][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t j = (int64_t)blockIdx.x * 32 + lane;
  const int c0 = warp * rows / 8;
  const int c1 = (warp + 1) * rows / 8;
  float s = 0.0f;
  if (j < m) {
#pragma unroll 8
    for (int c = c0; c < c1; ++c) s += partial[(int64_t)c * m + j];
  }
  sh[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && j < m) {
    float t = sh[0][lane];
#pragma unroll
    for (int w = 1; w < 8; ++w) t += sh[w][lane];
    g[j] = (log_b[j] - logf(fmaxf(t, 1e-37f))) + g[j];
  }
}

__global__ void __launch_bounds__(kSumThreads)
sum_kernel(const float* __restrict__ x, int64_t n, float* __restrict__ out) {
  __shared__ float sh[33];
  float s = 0.0f;
  for (int64_t i = threadIdx.x; i < n; i += kSumThreads) s += x[i];
  s = block_reduce<false>(s, sh);
  if (threadIdx.x == 0) out[0] = s;
}

}  // namespace

// The current device's SM count and the shared memory a block may use,
// the inputs of the host's route rule.
extern "C" int sinkhorn_device_limits(int* sms, int* smem_per_block) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(smem_per_block,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  }
  return (int)e;
}

// Shared memory of a one-pass block holding `rows` rows per group.
static size_t onepass_smem(long long m, int rows) {
  return (size_t)(2 * kMaxRows * kOneWarps
                  + kStages * ((rows * m + 7) / 4 * 4)) * sizeof(float);
}

// The one-pass route: `sweeps` sweeps on f (n) and g (m) in place, then
// the last sweep's row-marginal error in err[0]. `blocks` blocks of
// rows_per_block rows (blocks * rows_per_block >= n, no block empty),
// `rows` rows per group. Scratch: err_row (n) and partial (blocks x m).
extern "C" int sinkhorn_duals_onepass_sweeps(
    const float* Mr, const float* log_a, const float* log_b, float* f,
    float* g, float* err_row, float* partial, float* err, long long n,
    long long m, int blocks, long long rows_per_block, int rows, int sweeps,
    void* stream) {
  if (n <= 0 || m <= 0 || m > kOnePassCols || blocks <= 0 || rows < 1
      || rows > kMaxRows || rows_per_block < 1
      || (long long)blocks * rows_per_block < n || sweeps < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = onepass_smem(m, rows);
  cudaError_t e = cudaFuncSetAttribute(
      sinkhorn_onepass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned int g_blocks = (unsigned int)((m + 31) / 32);
  for (int k = 0; k < sweeps; ++k) {
    sinkhorn_onepass_kernel<<<blocks, kOneThreads, smem, st>>>(
        Mr, g, log_a, f, err_row, partial, n, (int)m, rows_per_block, rows);
    sinkhorn_g_rows_kernel<<<g_blocks, 256, 0, st>>>(partial, log_b, g, m,
                                                     blocks);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  sum_kernel<<<1, kSumThreads, 0, st>>>(err_row, n, err);
  return (int)cudaGetLastError();
}

// The long-rows route: `sweeps` Sinkhorn sweeps on f (n) and g (m) in
// place, then the last sweep's row-marginal error in err[0]. The slice
// kernel runs on a grid of n_slices = ceil(m / 4096) by ceil(n /
// rows_per_block) blocks (rows_per_block <= 64), the column kernel on
// ceil(m / 128) by `chunks` blocks of rows_per_chunk = ceil(n / chunks)
// rows. Scratch: pmax, psum (n x n_slices each), rmax, u, err_row (n
// each), counters (ceil(n / rows_per_block) unsigned ints, zero before the
// first call and left zero) and partial (chunks x m, used only when
// chunks > 1).
template <bool kVec>
static cudaError_t sliced_sweep(const float* Mr, const float* log_a,
                                const float* log_b, float* f, float* g,
                                float* pmax, float* psum, float* rmax,
                                float* u, float* err_row,
                                unsigned int* counters, float* partial,
                                long long n, long long m, int n_slices,
                                int rows_per_block, int chunks,
                                cudaStream_t st) {
  const long long col_blocks = (m + kColCols - 1) / kColCols;
  const long long rows_per_chunk = (n + chunks - 1) / chunks;
  const long long row_groups = (n + rows_per_block - 1) / rows_per_block;
  const dim3 slice_grid((unsigned int)n_slices, (unsigned int)row_groups);
  const dim3 col_grid((unsigned int)col_blocks, (unsigned int)chunks);
  sinkhorn_slice_kernel<kVec><<<slice_grid, kSliceThreads, 0, st>>>(
      Mr, g, log_a, pmax, psum, f, rmax, u, err_row, counters, n, m,
      rows_per_block);
  if (chunks == 1) {
    sinkhorn_col_sliced_kernel<kVec, true><<<col_grid, kColThreads, 0, st>>>(
        Mr, g, log_b, rmax, u, partial, n, m, (int)rows_per_chunk);
  } else {
    sinkhorn_col_sliced_kernel<kVec, false><<<col_grid, kColThreads, 0, st>>>(
        Mr, g, log_b, rmax, u, partial, n, m, (int)rows_per_chunk);
    sinkhorn_g_kernel<<<(unsigned int)((m + kColThreads - 1) / kColThreads),
                        kColThreads, 0, st>>>(partial, log_b, g, m, chunks);
  }
  return cudaGetLastError();
}

extern "C" int sinkhorn_duals_sliced_sweeps(
    const float* Mr, const float* log_a, const float* log_b, float* f,
    float* g, float* pmax, float* psum, float* rmax, float* u,
    float* err_row, unsigned int* counters, float* partial, float* err,
    long long n, long long m, int n_slices, int rows_per_block, int chunks,
    int sweeps, void* stream) {
  if (n <= 0 || m <= 0 || chunks <= 0 || sweeps < 0 || rows_per_block < 1
      || rows_per_block > kSliceMaxRows
      || (long long)n_slices * kSliceCols < m
      || (long long)(n_slices - 1) * kSliceCols >= m) {
    return (int)cudaErrorInvalidValue;
  }
  if ((m + kColCols - 1) / kColCols > 0x7fffffffLL || chunks > 65535
      || (n + rows_per_block - 1) / rows_per_block > 65535) {
    return (int)cudaErrorInvalidConfiguration;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = m % 4 == 0 && ((uintptr_t)Mr & 15) == 0;
  for (int k = 0; k < sweeps; ++k) {
    const cudaError_t e =
        vec ? sliced_sweep<true>(Mr, log_a, log_b, f, g, pmax, psum, rmax, u,
                                 err_row, counters, partial, n, m, n_slices,
                                 rows_per_block, chunks, st)
            : sliced_sweep<false>(Mr, log_a, log_b, f, g, pmax, psum, rmax,
                                  u, err_row, counters, partial, n, m,
                                  n_slices, rows_per_block, chunks, st);
    if (e != cudaSuccess) return (int)e;
  }
  sum_kernel<<<1, kSumThreads, 0, st>>>(err_row, n, err);
  return (int)cudaGetLastError();
}

// The two-read kernels (kept for timing): `sweeps` Sinkhorn sweeps on f (n)
// and g (m) in place, then the last sweep's row-marginal error in err[0].
// Scratch: rmax, u, err_row (n each) and partial (chunks x m);
// rows_per_chunk = ceil(n / chunks).
extern "C" int sinkhorn_duals_sweeps(
    const float* Mr, const float* log_a, const float* log_b, float* f,
    float* g, float* rmax, float* u, float* err_row, float* partial,
    float* err, long long n, long long m, int chunks, int sweeps,
    void* stream) {
  if (n <= 0 || m <= 0 || chunks <= 0 || sweeps < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long col_blocks = (m + kColThreads - 1) / kColThreads;
  const long long rows_per_chunk = (n + chunks - 1) / chunks;
  if (n > 0x7fffffffLL || col_blocks > 0x7fffffffLL || chunks > 65535) {
    return (int)cudaErrorInvalidConfiguration;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 col_grid((unsigned int)col_blocks, (unsigned int)chunks);
  for (int k = 0; k < sweeps; ++k) {
    sinkhorn_row_kernel<<<(unsigned int)n, kRowThreads, 0, st>>>(
        Mr, g, log_a, f, rmax, u, err_row, m);
    sinkhorn_col_kernel<<<col_grid, kColThreads, 0, st>>>(
        Mr, g, rmax, u, partial, n, m, rows_per_chunk);
    sinkhorn_g_kernel<<<(unsigned int)col_blocks, kColThreads, 0, st>>>(
        partial, log_b, g, m, chunks);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  sum_kernel<<<1, kSumThreads, 0, st>>>(err_row, n, err);
  return (int)cudaGetLastError();
}
