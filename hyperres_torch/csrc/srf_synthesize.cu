// SRF band synthesis with the invalid-row fill:
//
//   out[n, s] = valid(n) ? sum_b x[n, b] * W[b, s] : fill        (float32)
//
// x (N, B) row-major, W (B, S) row-major, out (N, S) row-major; valid(n)
// is a byte mask, or every row when none is given. Any B and S.
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
// GFLOP (~0.26 ms at the 67 TFLOP/s f32 rate). Three routes, chosen by
// shape on the host (kernels/srf.py:srf_route):
//
// Tiled (B with gcd(B, 32) <= 2 whose tiles fit shared memory; EMIT's 285
// bands): the design for this card.
//   - a persistent block of 8 consumer warps and one producer warp walks
//     tiles of 32 R rows (R = 2, or 1 for wide rows). A tile's rows are one
//     contiguous span of x, so the producer's lane 0 brings its 16-byte-
//     aligned body in with ONE bulk asynchronous copy (cp.async.bulk, the
//     TMA's 1-D form) that reports to an mbarrier; the <= 3 floats before
//     and after the body go by plain loads. The span lands at the shift
//     (0-3 floats) that keeps its alignment, so any B and any base address
//     work (a 2-D tensor map would need a row pitch that is a multiple of
//     16 bytes; 1140 is not). A ring of 2 tiles (32-row tiles and rings
//     of 3 to 5 measured slower on an H100): while the consumers work
//     on one, the next (73 KB at B = 285) is in flight, far more than the
//     ~15 KB per SM that covers HBM latency at 3.35 TB/s;
//   - consumers: a thread per row (R rows 32 apart), so the 32 lanes of a
//     warp read the same band of 32 neighbouring rows: pitch B words, odd,
//     32 banks. The 8 warps split the bands into 8 runs; W (zero-padded to
//     a multiple of 4 columns) sits in shared memory and W[b, :] is read as
//     broadcast float4s; R x S accumulators per thread in registers, no
//     cross-lane traffic. Per band a thread issues R + ceil(S / 4) shared
//     loads for R S FMAs (6 for 26 at S = 13: the LSU and the FMA pipes are
//     about level; with R = 1 the loads would bind);
//   - the 8 warps' partial sums go through shared memory and are added in
//     warp order (fixed), the tile's outputs stored coalesced; S > 16 runs
//     16 output bands at a time over the same tile;
//   - the producer reads the tile's mask bytes first: a tile with no valid
//     row is not copied, an invalid row in a mixed tile costs its bytes
//     and writes the fill.
// Warp (other B <= 384 with S <= 16: an even band count, say): this
// file's first kernel, also timed beside the tiled route (chip_smoke.py):
// a warp takes R rows, lanes along the bands with 4-byte loads, all loads
// of a step before any FMA, then a reduce-scatter of the R x S sums (31
// shuffles per R rows at S = 13). Load, math and shuffles do not overlap
// inside a warp, which held it at 41 % of the bound at B = 285, S = 13.
// Generic (any other B and S): a warp per row, lanes along the bands
// (coalesced), 16 output bands at a time, a butterfly per sum. Simple and
// slow; x is read once per 16 output bands.
// Sums run in another order than a library GEMM's, so results differ from
// torch.matmul by f32 rounding.
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



// ---- the tiled route ------------------------------------------------------

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kTiledThreads = kConsumers + 32;   // + the producer warp
constexpr int kRing = 2;                          // tiles in shared memory
constexpr int kMaxSmem = 232448;                  // bytes a block may use

// Shared-memory plan of the tiled kernel for rows of B floats, S outputs
// and R rows per thread (mirrored by kernels/srf.py:_tiled_smem_bytes).
struct TiledPlan {
  int tr;          // rows per tile
  int sp;          // floats per W row in shared memory
  int n_st;        // tiles of 16 output bands (1 when S <= 16)
  int slot;        // floats per ring slot
  int off_valid, off_pvalid, off_w, off_partial, off_ring;   // bytes
  int bytes;
};

__host__ __device__ inline TiledPlan tiled_plan(int B, int S, int R) {
  TiledPlan p;
  p.tr = 32 * R;
  p.n_st = S <= 16 ? 1 : (S + 15) / 16;
  p.sp = S <= 16 ? (S + 3) / 4 * 4 : 16 * p.n_st;
  p.slot = (p.tr * B + 8 + 3) / 4 * 4;
  // 2 kRing mbarriers (8 bytes each) and kRing shift words come first
  p.off_valid = 64;
  p.off_pvalid = p.off_valid + kRing * p.tr;
  p.off_w = (p.off_pvalid + p.tr + 15) / 16 * 16;
  p.off_partial = p.off_w + B * p.sp * 4;
  p.off_ring = (p.off_partial + kConsumerWarps * p.tr * S * 4 + 15) / 16 * 16;
  p.bytes = p.off_ring + kRing * p.slot * 4;
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned; completion is reported to `bar` as transaction bytes
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// SW: FMAs per band and row of one pass (S when S <= 16, else 16: the
// passes cover 16 output bands each); R: rows per thread.
template <int SW, int R>
__global__ void __launch_bounds__(kTiledThreads, 1)
srf_tiled_kernel(const float* __restrict__ x, const float* __restrict__ W,
                 const uint8_t* __restrict__ mask, float* __restrict__ out,
                 int64_t N, int B, int S, float fill, int64_t n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TiledPlan p = tiled_plan(B, S, R);
  constexpr int TR = 32 * R;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);   // full[], empty[]
  int* shift_s = reinterpret_cast<int*>(smem + 16 * kRing);
  uint8_t* valid_s = smem + p.off_valid;      // per slot, by the producer
  uint8_t* pvalid_s = smem + p.off_pvalid;    // the tile being reduced
  float* w_s = reinterpret_cast<float*>(smem + p.off_w);
  float* partial = reinterpret_cast<float*>(smem + p.off_partial);
  float* ring = reinterpret_cast<float*>(smem + p.off_ring);
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = smem_u32(bars + kRing);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < B * p.sp; i += kTiledThreads) {
    const int b = i / p.sp, s = i - b * p.sp;
    w_s[i] = s < S ? W[(int64_t)b * S + s] : 0.0f;
  }
  if (threadIdx.x == 0) {
    for (int q = 0; q < kRing; ++q) {
      mbar_init(full0 + 8 * q, 1);                  // the producer's lane 0
      mbar_init(empty0 + 8 * q, kConsumerWarps);    // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: one tile ahead of the consumers, round the ring ----
    int slot = 0, phase = 0;
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      mbar_wait(empty0 + 8 * slot, phase ^ 1);
      const int64_t row0 = tile * TR;
      const int rows = (int)(N - row0 < TR ? N - row0 : TR);
      bool any = false;
      for (int r = lane; r < TR; r += 32) {
        const bool ok = r < rows && (mask == nullptr || mask[row0 + r] != 0);
        valid_s[slot * TR + r] = ok;
        any = any || ok;
      }
      any = __any_sync(0xffffffffu, any);
      // the span of `n` floats at src lands at dst = slot + sh, so that
      // its 16-byte-aligned body stays aligned
      const float* src = x + row0 * B;
      const int n = rows * B;
      const int sh = (int)(((uintptr_t)src >> 2) & 3);
      const int head = ((4 - sh) & 3) < n ? (4 - sh) & 3 : n;
      const int body = (n - head) / 4 * 4;
      float* dst = ring + (size_t)slot * p.slot + sh;
      if (any) {
        if (lane < head) dst[lane] = src[lane];
        if (lane < n - head - body) {
          dst[head + body + lane] = src[head + body + lane];
        }
      }
      if (lane == 0) shift_s[slot] = any ? sh : -1;
      __syncwarp();
      if (lane == 0) {
        const uint32_t bar = full0 + 8 * slot;
        if (any && body > 0) {
          mbar_arrive_expect_tx(bar, (uint32_t)body * 4);
          bulk_copy(smem_u32(dst + head), src + head, (uint32_t)body * 4,
                    bar);
        } else {
          mbar_arrive(bar);
        }
      }
      if (++slot == kRing) slot = 0, phase ^= 1;
    }
    return;
  }

  // ---- consumers: warp w takes bands [b0, b1) of every row of the tile
  const int b0 = (int)((int64_t)warp * B / kConsumerWarps);
  const int b1 = (int)((int64_t)(warp + 1) * B / kConsumerWarps);
  constexpr int Q = (SW + 3) / 4;   // float4s of a W row per pass
  int slot = 0, phase = 0;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    mbar_wait(full0 + 8 * slot, phase);
    const int64_t row0 = tile * TR;
    const int rows = (int)(N - row0 < TR ? N - row0 : TR);
    const int sh = shift_s[slot];
    if (sh >= 0) {
      const float* xs = ring + (size_t)slot * p.slot + sh + (size_t)lane * B;
      for (int st = 0; st < p.n_st; ++st) {
        float acc[R][SW];
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int s = 0; s < SW; ++s) acc[r][s] = 0.0f;
        }
        const float* wrow = w_s + 16 * st;
#pragma unroll 4
        for (int b = b0; b < b1; ++b) {
          float xv[R];
#pragma unroll
          for (int r = 0; r < R; ++r) xv[r] = xs[(size_t)32 * r * B + b];
          const float4* w4 =
              reinterpret_cast<const float4*>(wrow + (size_t)b * p.sp);
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const float4 w = w4[q];
            const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (4 * q + j < SW) {
#pragma unroll
                for (int r = 0; r < R; ++r) {
                  acc[r][4 * q + j] = fmaf(xv[r], wv[j], acc[r][4 * q + j]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float* pr = partial + ((size_t)warp * TR + lane + 32 * r) * S
                      + 16 * st;
#pragma unroll
          for (int s = 0; s < SW; ++s) {
            if (16 * st + s < S) pr[s] = acc[r][s];
          }
        }
      }
    }
    if (warp == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        pvalid_s[lane + 32 * r] = valid_s[slot * TR + lane + 32 * r];
      }
    }
    // this warp has read all it needs of the slot
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * slot);
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    // the tile's outputs: the 8 partial sums in warp order, coalesced
    float* o = out + row0 * S;
    for (int e = threadIdx.x; e < rows * S; e += kConsumers) {
      const int row = e / S;
      float v = fill;
      if (pvalid_s[row]) {
        v = partial[e];
#pragma unroll
        for (int w = 1; w < kConsumerWarps; ++w) {
          v += partial[(size_t)w * TR * S + e];
        }
      }
      o[e] = v;
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
    if (++slot == kRing) slot = 0, phase ^= 1;
  }
}

template <int SW, int R>
cudaError_t launch_tiled(const float* x, const float* W, const uint8_t* mask,
                         float* out, int64_t N, int B, int S, float fill,
                         cudaStream_t stream) {
  const TiledPlan p = tiled_plan(B, S, R);
  if (p.bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      srf_tiled_kernel<SW, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.bytes);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) return err;
  const int64_t n_tiles = (N + p.tr - 1) / p.tr;
  const int64_t blocks = n_tiles < sms ? n_tiles : sms;
  srf_tiled_kernel<SW, R><<<(unsigned int)blocks, kTiledThreads, p.bytes,
                            stream>>>(x, W, mask, out, N, B, S, fill,
                                      n_tiles);
  return cudaGetLastError();
}

template <int SW>
cudaError_t dispatch_tiled(int sw, int R, const float* x, const float* W,
                           const uint8_t* mask, float* out, int64_t N, int B,
                           int S, float fill, cudaStream_t stream) {
  if (sw == SW) {
    return R == 2 ? launch_tiled<SW, 2>(x, W, mask, out, N, B, S, fill,
                                        stream)
                  : launch_tiled<SW, 1>(x, W, mask, out, N, B, S, fill,
                                        stream);
  }
  if constexpr (SW < 16) {
    return dispatch_tiled<SW + 1>(sw, R, x, W, mask, out, N, B, S, fill,
                                  stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

// ---- the generic route ----------------------------------------------------

__global__ void __launch_bounds__(kThreads)
srf_generic_kernel(const float* __restrict__ x, const float* __restrict__ W,
                   const uint8_t* __restrict__ mask, float* __restrict__ out,
                   int64_t N, int B, int S, float fill) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t n_warps = (int64_t)gridDim.x * kWarps;
  for (int64_t n = warp; n < N; n += n_warps) {
    float* o = out + n * S;
    if (mask != nullptr && mask[n] == 0) {
      for (int s = lane; s < S; s += 32) o[s] = fill;
      continue;
    }
    const float* xr = x + n * B;
    for (int s0 = 0; s0 < S; s0 += 16) {
      float acc[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc[j] = 0.0f;
      for (int b = lane; b < B; b += 32) {
        const float xv = __ldg(xr + b);
        const float* wr = W + (int64_t)b * S + s0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (s0 + j < S) acc[j] = fmaf(xv, __ldg(wr + j), acc[j]);
        }
      }
      float mine = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float v = acc[j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v += __shfl_xor_sync(0xffffffffu, v, off);
        }
        if (lane == j) mine = v;
      }
      if (lane < 16 && s0 + lane < S) o[s0 + lane] = mine;
    }
  }
}

}  // namespace

// Bytes of shared memory the tiled route needs for rows of B floats, S
// outputs and R (1 or 2) rows per thread: the wrapper's mirror is checked
// against it.
extern "C" int srf_tiled_smem_bytes(int B, int S, int R) {
  return tiled_plan(B, S, R).bytes;
}

// The tiled route with R (1 or 2) rows per thread.
extern "C" int srf_synthesize_tiled_f32(const float* x, const float* W,
                                        const unsigned char* mask, float* out,
                                        long long N, int B, int S, int R,
                                        float fill, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (B < 1 || S < 1 || (R != 1 && R != 2)) return (int)cudaErrorInvalidValue;
  return (int)dispatch_tiled<1>(S <= 16 ? S : 16, R, x, W, mask, out, N, B, S,
                                fill, (cudaStream_t)stream);
}

// The generic route: any B and S.
extern "C" int srf_synthesize_generic_f32(const float* x, const float* W,
                                          const unsigned char* mask,
                                          float* out, long long N, int B,
                                          int S, float fill, void* stream) {
  if (N <= 0) return (int)cudaSuccess;
  if (B < 1 || S < 1) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) return (int)err;
  int64_t blocks = (N + kWarps - 1) / kWarps;
  if (blocks > (int64_t)sms * 8) blocks = (int64_t)sms * 8;
  srf_generic_kernel<<<(unsigned int)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(x, W, mask, out, N, B, S,
                                               fill);
  return (int)cudaGetLastError();
}

// The warp route (B <= 384, S <= 16).
extern "C" int srf_synthesize_warp_f32(const float* x, const float* W,
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
