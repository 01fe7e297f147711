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
// (kernels/sinkhorn_duals.py holds the loop and the stopping rule).
//
// Replaces the TPU kernel pallas_sinkhorn_duals
// (hyperres/kernels/pallas_ops.py:605), which keeps the whole cost matrix
// in VMEM (5120^2 f32 at most) and runs every sweep in one program, with
// the column sum reusing the row pass's exponentials held in vregs. The
// TPU pads n to 128-row blocks and m to 128 lanes with -1e30 entries that
// add exact zeros; here nothing is padded.
//
// What bounds it on Hopper: memory. At the fused plan's shape (n = m =
// 5000, OTConfig()) Mr is 100 MB, twice the 50 MB L2, so each sweep
// streams it from HBM: once for the row kernel (its second pass over a
// 20 KB row is an L2 hit) and once for the column kernel, ~200 MB, about
// 60 us at 3.35 TB/s. The exps (2 n m expf per sweep) stay below that.
// What the design does about it:
//   - row kernel: one block per row, a max pass and an exp/sum pass,
//     reads along the row coalesced; it writes f_i, rmax_i, u_i = a_i /
//     rowsum_i and err_i;
//   - column kernel: threads along j, each block loops over one chunk of
//     rows, so every warp reads 32 neighbouring floats of a row; it
//     recomputes exp(Mr_ij + g_j - rmax_i) * u_i (the same float
//     operations as the row kernel) and writes one partial column sum
//     per chunk; the chunks are sized to fill the card;
//   - g kernel: sums the chunks' partials in chunk order and updates g.
// Every reduction runs in a fixed order (no float atomics), so two runs
// give the same bits. exp and log are the full-precision expf / logf.
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
  for (int c = 0; c < chunks; ++c) s += partial[(int64_t)c * m + j];
  // the floor must be a normal f32 (1e-38 is subnormal)
  g[j] = (log_b[j] - logf(fmaxf(s, 1e-37f))) + g[j];
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

// Runs `sweeps` Sinkhorn sweeps on f (n) and g (m) in place, then writes
// the last sweep's row-marginal error to err[0]. Scratch: rmax, u, err_row
// (n each) and partial (chunks x m); rows_per_chunk = ceil(n / chunks).
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
