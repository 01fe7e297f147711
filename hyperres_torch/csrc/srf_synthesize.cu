// SRF band synthesis with the invalid-row fill:
//
//   out[n, s] = valid(n) ? sum_b x[n, b] * W[b, s] : fill        (float32)
//
// x (N, B) row-major, W (B, S) row-major, out (N, S) row-major; valid(n)
// is a byte mask, or every row when none is given. S <= 16 (the S2 bands
// of an SRF table: 13 at most).
//
// Replaces the TPU kernel pallas_srf_synthesize
// (hyperres/kernels/pallas_ops.py:70, pallas_call :107), which pads N to
// 1024-row tiles and B and S to 128 lanes so the MXU can take the product;
// at B = 285 and S = 13 that is 2.6x the rows' bytes and 10x the outputs'
// columns of padding. Here nothing is padded.
//
// What bounds it on Hopper: memory. Per row it reads B floats (1140 bytes
// at B = 285) and does B * S FMAs (3,705 at S = 13), so at the UTM cube's
// 2.36 M rows it reads ~2.7 GB (>= ~0.8 ms at 3.35 TB/s) against ~17.5
// GFLOP (~0.26 ms at the 67 TFLOP/s f32 rate). What the design does:
//   - W (B x S floats, <= 18 KB) sits in shared memory, loaded once per
//     block; its rows are padded to an odd stride, so the 32 lanes of a
//     warp, each on its own band, hit 32 different banks;
//   - a warp takes R rows at a time (R = 32 / S rounded up to a power of
//     two, at most 4) in a grid-stride loop: lane l reads x[n, l],
//     x[n, l + 32], ... of each row (coalesced runs), all of them before
//     any FMA, and keeps R x S partial sums in registers, so each W value
//     read from shared memory feeds R FMAs;
//   - the R x S sums are reduced across the warp by a reduce-scatter
//     (at each shuffle offset a lane keeps half of its sums and sends the
//     other half): 31 shuffles per R rows at S = 13, not 5 per sum;
//   - an invalid row is not read: its S outputs are the fill.
// The sum runs in another order than a library GEMM's (by lane, then the
// reduce-scatter), so results differ from torch.matmul by f32 rounding.
// B <= 384 (EMIT has 285 bands): a lane holds 12 values of each row.
//
// C interface (built with nvcc into a shared library, loaded by ctypes):
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not
// take) so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxS = 16;
constexpr int kMaxB = 384;
constexpr int kLoads = kMaxB / 32;            // x values a lane holds per row

// Per output width S: Sp = S rounded up to a power of two, R rows per warp
// step (R * Sp <= 32 partial sums per lane, so one reduce-scatter leaves
// one total per lane).
template <int S>
struct Shape {
  static constexpr int Sp = S <= 1 ? 1 : S <= 2 ? 2 : S <= 4 ? 4
                          : S <= 8 ? 8 : 16;
  static constexpr int R = 32 / Sp < 4 ? 32 / Sp : 4;
  static constexpr int V = R * Sp;            // partial sums per lane
};

// a where the mask is all ones, b where it is zero. A bit select rather
// than `m ? a : b`, which the compiler may turn into a load from a
// selected address of acc[] and so move acc[] out of the registers.
__device__ __forceinline__ float pick(unsigned m, float a, float b) {
  return __int_as_float((__float_as_int(a) & m) | (__float_as_int(b) & ~m));
}

// One step of the warp reduce-scatter at shuffle offset o, with C sums
// per lane before it: a template, so every index into acc is a constant
// (acc must stay in the registers).
template <int C>
__device__ __forceinline__ void reduce_step(float* acc, int lane, int o) {
  if constexpr (C > 1) {
    const unsigned upper = (lane & o) ? 0xffffffffu : 0u;
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      const float send = pick(upper, acc[i], acc[i + C / 2]);
      const float keep = pick(upper, acc[i + C / 2], acc[i]);
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  } else {
    acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], o);
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads)
srf_synthesize_kernel(const float* __restrict__ x,
                      const float* __restrict__ W,
                      const uint8_t* __restrict__ mask,
                      float* __restrict__ out, int64_t N, int B, float fill,
                      int stride) {
  constexpr int Sp = Shape<S>::Sp, R = Shape<S>::R, V = Shape<S>::V;
  extern __shared__ float w_s[];  // B rows of `stride` (odd) floats
  for (int i = threadIdx.x; i < B * S; i += kThreads) {
    w_s[(i / S) * stride + i % S] = W[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  // the partial sum this lane ends up holding after the reduce-scatter:
  // index j of acc[r * Sp + s]; lanes that differ only in the low bits
  // below 32 / V hold the same total, and the lowest of them writes it
  int j = 0;
#pragma unroll
  for (int step = 0; step < 5; ++step) {
    if ((V >> step) > 1 && (lane & (16 >> step))) j += (V >> step) / 2;
  }
  const int jr = j / Sp, js = j % Sp;
  const bool writer = (lane & (32 / V - 1)) == 0 && js < S;

  const int64_t warp = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t n_warps = (int64_t)gridDim.x * kWarps;
  for (int64_t n0 = warp * R; n0 < N; n0 += n_warps * R) {
    // every load of the R rows before any FMA
    unsigned ok_bits = 0;
    float xv[R][kLoads];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int64_t n = n0 + r;
      const bool ok = n < N && (mask == nullptr || mask[n] != 0);
      ok_bits |= (unsigned)ok << r;
      const float* xr = x + n * B;
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int b = lane + 32 * k;
        xv[r][k] = (ok && b < B) ? __ldg(xr + b) : 0.0f;
      }
    }
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int b = lane + 32 * k;
      if (b < B) {
        const float* wr = w_s + b * stride;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float w = wr[s];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r * Sp + s] = fmaf(xv[r][k], w, acc[r * Sp + s]);
          }
        }
      }
    }
    // reduce-scatter: at each offset a lane keeps half of its sums and
    // sends the other half to its partner, until one is left; then the
    // remaining offsets all-reduce it
    reduce_step<V>(acc, lane, 16);
    reduce_step<(V >> 1 > 1 ? V >> 1 : 1)>(acc, lane, 8);
    reduce_step<(V >> 2 > 1 ? V >> 2 : 1)>(acc, lane, 4);
    reduce_step<(V >> 3 > 1 ? V >> 3 : 1)>(acc, lane, 2);
    reduce_step<(V >> 4 > 1 ? V >> 4 : 1)>(acc, lane, 1);
    const int64_t n = n0 + jr;
    if (writer && n < N) {
      out[n * S + js] = (ok_bits >> jr) & 1u ? acc[0] : fill;
    }
  }
}

template <int S>
cudaError_t launch(const float* x, const float* W, const uint8_t* mask,
                   float* out, int64_t N, int B, float fill,
                   cudaStream_t stream) {
  const int stride = S | 1;
  const size_t smem = (size_t)B * stride * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      srf_synthesize_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, srf_synthesize_kernel<S>, kThreads, smem)) !=
      cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t rows_per_block = (int64_t)kWarps * Shape<S>::R;
  int64_t blocks = (N + rows_per_block - 1) / rows_per_block;
  const int64_t fill_card = (int64_t)sms * per_sm;
  if (blocks > fill_card) blocks = fill_card;
  srf_synthesize_kernel<S><<<(unsigned int)blocks, kThreads, smem, stream>>>(
      x, W, mask, out, N, B, fill, stride);
  return cudaGetLastError();
}

template <int S>
cudaError_t dispatch(int s, const float* x, const float* W,
                     const uint8_t* mask, float* out, int64_t N, int B,
                     float fill, cudaStream_t stream) {
  if (s == S) return launch<S>(x, W, mask, out, N, B, fill, stream);
  if constexpr (S < kMaxS) {
    return dispatch<S + 1>(s, x, W, mask, out, N, B, fill, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int srf_synthesize_f32(const float* x, const float* W,
                                  const unsigned char* mask, float* out,
                                  long long N, int B, int S, float fill,
                                  void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (B < 1 || B > kMaxB || S < 1 || S > kMaxS) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)dispatch<1>(S, x, W, mask, out, N, B, fill,
                          (cudaStream_t)stream);
}
