// Fused ridge spectral-SR prediction to the u16 reflectance product, with
// the contraction on Hopper's tensor cores (wgmma, TF32 in three terms).
//
// For pixel p and output band j:
//
//   xs_b   = (x[p, b] - mean[b]) / std[b]                 b < Bx
//   F_m    = prod_d [1, xs_0, ..., xs_{Bx-1}][fac[m, d]]   m < F
//            (left to right; the host passes the monomials as pairs)
//   y      = sigmoid(clip(sum_m F_m * W[m, j] + intercept[j], -50, 50))
//   q[p,j] = valid(p) ? clip(rint(y * 1e4), 0, 65534) : 65535      (u16)
//
// valid(p) comes from a byte mask when one is given; otherwise the kernel
// tests the pixel's own bands: all finite and none within numpy's
// isclose of nodata (|x - nodata| <= 1e-8 + 1e-5 |nodata|, in double).
// A non-finite input is replaced as torch.nan_to_num does (NaN -> 0,
// +-inf -> +-FLT_MAX) before it is standardised, as the plain version
// does. X element (p, b) lies at p*x_sp + b*x_sb and Q element (p, j) at
// p*q_sp + j*q_sb (element strides), so one kernel serves the
// channel-major (Bx, N) -> (By, N) product layout and the row-major
// (N, Bx) -> (N, By) serving layout.
//
// Replaces the TPU kernels pallas_sr_predict_u16_cmajor and
// pallas_sr_predict_u16 (hyperres/kernels/pallas_ops.py:828 and :725),
// which expand the monomials through one-hot selector matmuls on the MXU.
// It replaces this file's earlier SIMT kernel, which formed the same
// monomials but did all F * By FMAs per pixel on the f32 pipes (62.7 ms
// at the (10 -> 32, 9140 x 9309) product on an H100, 37 % of the 67
// TFLOP/s f32 peak).
//
// What bounds it on Hopper: operations. The contraction F (N x F) . W
// (F x By) is 1.55 TFLOP at the product shape against ~4.3 GB of HBM
// traffic. One-pass TF32 keeps 10 mantissa bits, too few for the <= 1
// u16-step parity with the f32 plain version. So each operand is split,
// hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi), and the product is
// A_hi.B_hi + A_hi.B_lo + A_lo.B_hi in f32 accumulators: three terms,
// because the dropped A_lo.B_lo is ~2^-22 of the product (f32 level)
// while each of the two cross terms is ~2^-11 of it. Three TF32 passes
// at 495 TFLOP/s (dense) bound it at 9.4 ms, against 23.2 ms for f32 FMAs.
// The tensor cores are not what holds this kernel back: forming the
// monomials, their TF32 split and the sigmoid epilogue are SIMT work that
// each warpgroup does between its wgmmas (PERF.md has the breakdown).
// What the design does:
//   - a CTA is two warpgroups; each walks tiles of 64 pixels (one wgmma M
//     tile) in a persistent grid-stride loop, with BN = 32 output bands
//     (16 when K is large) per CTA in grid y;
//   - the K axis is the monomials in pairs that share every factor but
//     the last (the host builds the order, kernels/sr_predict.py:
//     sr_pair_table): pair 4 s + t fills K columns 8 s + t and 8 s + t + 4,
//     the two columns one thread holds in its A fragment for k8 step s, so
//     a thread loads the prefix factors once and makes two monomials from
//     one prefix product (6 multiplies and 8 loads where single monomials
//     take 8 and 12, for a 12 % longer K at the product: 320 for F = 285).
//     A monomial is still its factors multiplied left to right, so its
//     value is the plain version's;
//   - B = [W_hi | W_lo]: the CTA's W columns in that K order (zero rows
//     for padding), transposed to K-major (TF32 wgmma takes no
//     transpose), split once per CTA and stacked along N (2 BN rows), kept
//     in shared memory in the no-swizzle core-matrix layout
//     ([n/8][k/4][n%8][k%4]: 8 rows x 16 bytes per core matrix, 128 bytes
//     apart along K, K/4 * 128 bytes apart along N);
//   - per k8 step two wgmma.mma_async: m64n(2 BN)k8 of A_hi on [W_hi |
//     W_lo] and m64n(BN)k8 of A_lo on the W_hi half, into two sets of
//     accumulators (two independent chains); the epilogue adds the three
//     partial sums. Stacking hi and lo along N takes two wgmmas per step
//     where three m64n32k8 would take three;
//   - A = the monomials, formed by each thread straight into its wgmma
//     register fragment (rows g and g+8 of its warp's 16, columns t and
//     t+4 of each k8 step) from the tile's standardised inputs in shared
//     memory (one row per input, rows 72 floats apart so that rows that
//     differ mod 4 fall in different bank groups; the pair order gives the
//     four threads of a step such rows), so A never goes through shared
//     memory; the TF32 rounding is two integer operations;
//   - per chunk of 4 k8 steps: the fragments, 8 wgmmas as one commit
//     group, a wait; the SM's four warpgroups (two CTAs) overlap one
//     another's fragment work and tensor work;
//   - the next tile's inputs are loaded into registers while the current
//     tile computes;
//   - epilogue: intercept, clip, sigmoid, rintf, the u16 cast and the
//     validity flag per accumulator, then the tile goes through shared
//     memory so both layouts store coalesced (pixels contiguous per band
//     in cmajor, bands contiguous per pixel in rowmajor).
// Two routes, chosen by shape on the host (kernels/sr_predict.py:
// sr_route) before launch:
//   - resident: shared memory holds W's hi and lo for the CTA's band tile,
//     256 bytes per K column at 32 bands, and the pair entries: up to 800
//     K columns at 32 bands and 1632 at 16 (1600 at degree 4);
//   - streamed (more K columns: 12 bands at degree 4 take 2080): the host
//     splits W once per model and lays it out in global memory as slabs of
//     kChunkK K columns x [W_hi | W_lo] of 32 bands, each slab already in
//     the core-matrix layout. The CTA keeps a ring of kStages slabs in
//     shared memory, filled by 16-byte cp.async kStages - 1 chunks ahead of
//     the chunk being multiplied; its two warpgroups walk K in step (one
//     __syncthreads per chunk: the chunk's copies have landed, and every
//     wgmma that read the slot about to be refilled was waited for). The
//     stream runs on across the CTA's tiles (W stays in L2: 4.1 MB at F =
//     1819, By = 285). The pair entries stay resident (at most 5600 K
//     columns for 16 bands at degree 4, 45 KB). The k8 steps, the two
//     accumulator chains and their order are the resident route's, so
//     both routes give the same codes.
// Offsets are 64-bit: at 85 Mpx x 32 bands Q has 2.7e9 elements.
//
// C interface (built with nvcc into a shared library, loaded by ctypes):
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not
// take) so a refused launch is reported.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpgroups = 2;                 // per CTA
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kTileM = 64;                     // pixels per warpgroup tile
constexpr int kChunkSteps = 4;                 // k8 steps per commit group
constexpr int kChunkK = 8 * kChunkSteps;       // K granularity (32)
constexpr int kMaxBx = 16;                     // input bands
constexpr int kMaxDegree = 4;                  // factors per monomial
constexpr int kXsStride = kTileM + 8;          // floats per xs row
constexpr int kOutStride = kTileM + 2;         // u16 per staged band row
constexpr int kBandsPerThread = kMaxBx / 2;    // two threads per pixel
constexpr int kMaxSmem = 232448;               // bytes a CTA may use
constexpr int kStages = 4;                     // W slabs in the streamed ring
constexpr int kStreamBN = 32;                  // bands per CTA, streamed

// Bytes of one warpgroup's scratch: standardised inputs (row 0 is the
// constant one), two validity halves, the staged u16 tile.
__host__ __device__ constexpr int wg_bytes(int bn) {
  return (1 + kMaxBx) * kXsStride * 4 + 2 * kTileM
         + ((bn * kOutStride * 2 + 15) / 16) * 16;
}

// 32-bit words of one pair entry: 16-bit xs offsets of the prefix (D - 1
// factors, at least 2 with the constant row), then of the two last factors
__host__ __device__ constexpr int pair_words(int degree) {
  return degree <= 3 ? 2 : 4;
}

__host__ __device__ constexpr size_t smem_bytes(int bn, int kpad,
                                                int degree) {
  return (size_t)2 * bn * kpad * 4                  // W hi, W lo
         + (size_t)(kpad / 2) * pair_words(degree) * 4   // pair entries
         + (size_t)2 * kMaxBx * 4                   // mean, std
         + (size_t)kWarpgroups * wg_bytes(bn);
}

// Floats of one streamed slab: kChunkK K columns of [W_hi | W_lo]
__host__ __device__ constexpr int slab_floats(int bn) {
  return 2 * bn * kChunkK;
}

__host__ __device__ constexpr size_t smem_bytes_streamed(int bn, int kpad,
                                                         int degree) {
  return (size_t)kStages * slab_floats(bn) * 4      // the ring of slabs
         + (size_t)(kpad / 2) * pair_words(degree) * 4
         + (size_t)2 * kMaxBx * 4
         + (size_t)kWarpgroups * wg_bytes(bn);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// cvt.rna.tf32.f32 (nearest, ties away from zero, 10 mantissa bits) in
// two integer operations on the full-rate pipes: add half of the 13
// dropped bits to the magnitude, then drop them (a carry rounds into the
// exponent, as it should)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// 64-bit shared-memory matrix descriptor, no swizzle: start address, the
// byte offset between core matrices adjacent along K (LBO) and along N
// (SBO), each >> 4.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16)
         | ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void pin(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// D (64 x N, f32) += A (64 x 8, tf32 registers) . B (8 x N, tf32 in
// shared memory, K-major)
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// The two monomials of a pair for one pixel: `px` points at the pixel's
// column of xs, `e` holds the pair's xs offsets (16 bits each): the
// prefix product first (its factors left to right; the constant row pads
// it), then times each last factor. This is the plain version's left-to-
// right product with its factors of 1 dropped, so the values are the same.
template <int D>
__device__ __forceinline__ void pair_values(const float* px, const uint4& e,
                                            float& v, float& w) {
  if (D <= 3) {
    const float p = px[e.x & 0xFFFF] * px[e.x >> 16];
    v = p * px[e.y & 0xFFFF];
    w = p * px[e.y >> 16];
  } else {
    const float p = (px[e.x & 0xFFFF] * px[e.x >> 16]) * px[e.y & 0xFFFF];
    v = p * px[e.y >> 16];
    w = p * px[e.z & 0xFFFF];
  }
}

template <int D>
__device__ __forceinline__ uint4 load_pair(const uint32_t* pair_s, int q) {
  if (D <= 3) {
    const uint2 e = reinterpret_cast<const uint2*>(pair_s)[q];
    return make_uint4(e.x, e.y, 0u, 0u);
  }
  return reinterpret_cast<const uint4*>(pair_s)[q];
}

// torch.nan_to_num without branches: NaN -> 0, +-inf -> +-FLT_MAX
__device__ __forceinline__ float nan_to_num(float x) {
  return isnan(x) ? 0.0f : fminf(fmaxf(x, -FLT_MAX), FLT_MAX);
}

// kStream: W points at the host-made slabs (see the header) and `src` is
// not read; otherwise W is the (F, By) matrix and the CTA splits its tile
template <int D, int BN, bool kStream>
__global__ void __launch_bounds__(kThreads, 2)
sr_predict_tc_kernel(const float* __restrict__ X,
                     const uint8_t* __restrict__ mask,
                     const float* __restrict__ mean,
                     const float* __restrict__ stdv,
                     const float* __restrict__ W,
                     const float* __restrict__ icpt,
                     const int* __restrict__ pairs,
                     const int* __restrict__ src, uint16_t* __restrict__ Q,
                     int64_t N, int Bx, int By, int kpad,
                     int64_t x_sp, int64_t x_sb, int64_t q_sp, int64_t q_sb,
                     int test_nodata, double nodata, double nodata_tol,
                     int64_t n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kWords = pair_words(D);
  constexpr int kSlab = slab_floats(BN);
  // B: 2 BN rows x kpad, or the ring of kStages slabs
  float* w_s = reinterpret_cast<float*>(smem);
  uint32_t* pair_s = reinterpret_cast<uint32_t*>(
      w_s + (kStream ? kStages * kSlab : 2 * BN * kpad));
  const int wg = threadIdx.x >> 7;
  const int tid = threadIdx.x & 127;
  float* mean_s = reinterpret_cast<float*>(pair_s + (kpad / 2) * kWords);
  float* std_s = mean_s + kMaxBx;
  unsigned char* wg_s = reinterpret_cast<unsigned char*>(std_s + kMaxBx)
                        + wg * wg_bytes(BN);
  float* xs = reinterpret_cast<float*>(wg_s);
  uint8_t* valid_s = wg_s + (1 + kMaxBx) * kXsStride * 4;
  uint16_t* out_s = reinterpret_cast<uint16_t*>(valid_s + 2 * kTileM);

  // -- once per CTA: B = [W_hi | W_lo] of columns [j0, j0 + BN), K-major:
  // rows n < BN hold W_hi^T, rows BN + n hold W_lo^T --------------------
  const int j0 = blockIdx.y * BN;
  const int kc4 = kpad / 4;
  for (int e = threadIdx.x; !kStream && e < kpad * BN; e += kThreads) {
    const int k = e / BN;
    const int n = e - k * BN;
    const int m = src[k];   // W row of K column k, -1 for padding
    const float w = (m >= 0 && j0 + n < By) ? W[(int64_t)m * By + j0 + n]
                                            : 0.0f;
    const uint32_t hi = tf32_rna(w);
    const uint32_t lo = tf32_rna(w - __uint_as_float(hi));
    const int in_row = (k >> 2) * 32 + (n & 7) * 4 + (k & 3);
    w_s[(n >> 3) * kc4 * 32 + in_row] = __uint_as_float(hi);
    w_s[((BN + n) >> 3) * kc4 * 32 + in_row] = __uint_as_float(lo);
  }
  // pair entries: xs rows (D + 1 of them: prefix, last, last) as 16-bit
  // offsets, two per word; padding pairs are rows of the constant one
  // (their W rows are zero)
  for (int q = threadIdx.x; q < kpad / 2; q += kThreads) {
    uint32_t h[2 * kWords] = {};
#pragma unroll
    for (int i = 0; i < (D <= 3 ? 4 : 5); ++i) {
      h[i] = (uint32_t)(pairs[q * (D <= 3 ? 4 : 5) + i] * kXsStride);
    }
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      pair_s[q * kWords + w] = h[2 * w] | (h[2 * w + 1] << 16);
    }
  }
  for (int b = threadIdx.x; b < kMaxBx; b += kThreads) {
    mean_s[b] = b < Bx ? mean[b] : 0.0f;
    std_s[b] = b < Bx ? stdv[b] : 1.0f;
  }
  for (int i = tid; i < kXsStride; i += 128) xs[i] = 1.0f;
  // the generic-proxy stores above must be visible to wgmma's async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const uint64_t desc = smem_desc(w_s, 128, kc4 * 128);
  // a slab is 2 BN rows x kChunkK: kChunkK / 4 core matrices along K
  const uint64_t ring_desc = smem_desc(w_s, 128, (kChunkK / 4) * 128);
  const int warp = tid >> 5;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  // loads: two threads per pixel, each every other band
  const int p_ld = tid & (kTileM - 1);
  const int half = tid >> 6;
  const float* px0 = xs + 16 * warp + g;   // fragment rows g and g + 8
  const float* px1 = px0 + 8;
  // the intercepts of this thread's accumulator columns 8 (c / 2) + 2 t +
  // c % 2, and which of them are bands (j < By)
  float ic[BN / 4];
  uint32_t col_ok = 0;
#pragma unroll
  for (int c = 0; c < BN / 4; ++c) {
    const int j = j0 + 8 * (c >> 1) + 2 * t + (c & 1);
    ic[c] = j < By ? icpt[j] : 0.0f;
    if (j < By) col_ok |= 1u << c;
  }

  float xr[kBandsPerThread];
  bool ok = false;
  auto load_tile = [&](int64_t tile) {
    const int64_t p = tile * kTileM + p_ld;
    const bool in = p < N;
    ok = in;
    if (in && mask != nullptr) ok = half == 0 ? mask[p] != 0 : true;
#pragma unroll
    for (int i = 0; i < kBandsPerThread; ++i) {
      const int b = half + 2 * i;
      float x = 0.0f;
      if (in && b < Bx) {
        x = X[p * x_sp + b * x_sb];
        if (mask == nullptr) {
          ok = ok && isfinite(x);
          if (test_nodata) {
            ok = ok && !(fabs((double)x - nodata) <= nodata_tol);
          }
        }
      }
      xr[i] = x;
    }
  };

  const int64_t wg0 = (int64_t)blockIdx.x * kWarpgroups + wg;
  const int64_t wg_stride = (int64_t)gridDim.x * kWarpgroups;
  const uint32_t bar = 1 + wg;   // named barrier of this warpgroup

  // streamed: the CTA's slabs (chunk c at wsl + c kSlab) go round the ring
  // in the order the K loops below read them, tile after tile. The tile
  // loop is then the same for both warpgroups (the second may run a tile
  // past the end: its loads and stores are masked).
  const float* wsl = W + (size_t)blockIdx.y * (kpad / kChunkK) * kSlab;
  const int64_t cta_iters =
      kStream ? (n_tiles - wg0 + wg + wg_stride - 1) / wg_stride : 0;
  int64_t to_issue = cta_iters * (kpad / kChunkK);
  int issue_chunk = 0, issue_slot = 0, slot = 0;
  auto issue = [&]() {
    if (to_issue > 0) {
      const float* from = wsl + (size_t)issue_chunk * kSlab;
      float* to = w_s + issue_slot * kSlab;
      for (int e = threadIdx.x; e < kSlab / 4; e += kThreads) {
        cp_async16(to + 4 * e, from + 4 * e);
      }
      --to_issue;
      if (++issue_chunk == kpad / kChunkK) issue_chunk = 0;
      if (++issue_slot == kStages) issue_slot = 0;
    }
    // one group per call, empty past the end, so every wait counts alike
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (kStream) {
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) issue();
  }

  if (kStream || wg0 < n_tiles) load_tile(wg0);
  for (int64_t tile = wg0; (kStream ? tile - wg : tile) < n_tiles;
       tile += wg_stride) {
    // the prefetched inputs, standardised, into xs
#pragma unroll
    for (int i = 0; i < kBandsPerThread; ++i) {
      const int b = half + 2 * i;
      if (b < Bx) {
        xs[(b + 1) * kXsStride + p_ld] =
            (nan_to_num(xr[i]) - mean_s[b]) / std_s[b];
      }
    }
    valid_s[half * kTileM + p_ld] = ok ? 1 : 0;
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
    if (tile + wg_stride < n_tiles) load_tile(tile + wg_stride);

    // acc columns [0, BN): A_hi.W_hi, [BN, 2 BN): A_hi.W_lo; acc_lo
    // columns [0, BN): A_lo.W_hi (its own chain of wgmmas, so that the two
    // do not wait on each other)
    float acc[BN], acc_lo[BN / 2];
#pragma unroll
    for (int i = 0; i < BN; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc_lo[i] = 0.0f;
    // per chunk of kChunkSteps k8 steps: the fragments, then the chunk's
    // wgmmas as one commit group, then a wait. The other warpgroups of the
    // SM fill the gaps (forming the next chunk into a second register set
    // while one runs gained nothing on an H100).
    for (int k0 = 0; k0 < kpad; k0 += kChunkK) {
      if (kStream) {
        // this chunk's slab has landed (this thread's copies, then every
        // thread's), visible to the wgmmas' proxy; the barrier also says
        // that every wgmma of the chunk before was waited for, so its
        // slot may be refilled
        asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2)
                     : "memory");
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        issue();
      }
      uint32_t a_hi[kChunkSteps][4], a_lo[kChunkSteps][4];
#pragma unroll
      for (int s = 0; s < kChunkSteps; ++s) {
        // pair 4 (k8 step) + t: K columns t and t + 4 of the step
        const uint4 e = load_pair<D>(pair_s, (k0 / 8 + s) * 4 + t);
        // fragment: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
        float v[4];
        pair_values<D>(px0, e, v[0], v[2]);
        pair_values<D>(px1, e, v[1], v[3]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a_hi[s][r] = tf32_rna(v[r]);
          a_lo[s][r] = tf32_rna(v[r] - __uint_as_float(a_hi[s][r]));
        }
      }
#pragma unroll
      for (int i = 0; i < BN; ++i) pin(acc[i]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) pin(acc_lo[i]);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kChunkSteps; ++s) {
        // k8 step k0 / 8 + s starts 2 core matrices (256 bytes, 16 in the
        // descriptor's units) further along K
        // (a slab starts at K column 0 of its own)
        const uint64_t step =
            (uint64_t)(((kStream ? 0 : k0 / 4) + 2 * s) * 8);
        const uint64_t b = kStream ? ring_desc + (uint64_t)(slot * kSlab / 4)
                                   : desc;
        Wgmma<2 * BN>::run(acc, a_hi[s], b + step);
        Wgmma<BN>::run(acc_lo, a_lo[s], b + step);
      }
      wgmma_commit();
      wgmma_wait<0>();
      if (kStream && ++slot == kStages) slot = 0;
#pragma unroll
      for (int i = 0; i < BN; ++i) pin(acc[i]);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) pin(acc_lo[i]);
    }

    // epilogue: accumulator (row, col) of this thread -> u16 code, without
    // branches: every code is computed, invalid ones are replaced
    const int r0 = 16 * warp + g;
    const bool row_ok[2] = {valid_s[r0] && valid_s[kTileM + r0],
                            valid_s[r0 + 8] && valid_s[kTileM + r0 + 8]};
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      // register i holds column col, register i + BN / 2 column BN + col
      const int c = 2 * (i >> 2) + (i & 1);
      const int col = 8 * (i >> 2) + 2 * t + (i & 1);
      const int row = r0 + 8 * ((i >> 1) & 1);
      float z = ((acc[i] + acc_lo[i]) + acc[i + BN / 2]) + ic[c];
      z = fminf(fmaxf(z, -50.0f), 50.0f);
      const float y = 1.0f / (1.0f + expf(-z));
      const float q = fminf(fmaxf(rintf(y * 10000.0f), 0.0f), 65534.0f);
      const bool ok = row_ok[(i >> 1) & 1] && ((col_ok >> c) & 1u);
      out_s[col * kOutStride + row] = ok ? (uint16_t)q : (uint16_t)65535;
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
    const int64_t p0 = tile * kTileM;
    if (q_sp == 1) {   // pixels contiguous within a band
      for (int e = tid; e < BN * kTileM; e += 128) {
        const int col = e / kTileM;
        const int row = e - col * kTileM;
        if (p0 + row < N && j0 + col < By) {
          Q[(p0 + row) + (int64_t)(j0 + col) * q_sb] =
              out_s[col * kOutStride + row];
        }
      }
    } else {           // bands contiguous within a pixel
      for (int e = tid; e < BN * kTileM; e += 128) {
        const int row = e / BN;
        const int col = e - row * BN;
        if (p0 + row < N && j0 + col < By) {
          Q[(p0 + row) * q_sp + (int64_t)(j0 + col) * q_sb] =
              out_s[col * kOutStride + row];
        }
      }
    }
  }
}

// Output bands per CTA for kpad K columns at `degree`: 32 when W's hi /
// lo fit in shared memory at 32 bands, else 16, else 0 (not taken).
// Mirrored by kernels/sr_predict.py:sr_tile_bands.
int tile_bands(int kpad, int degree) {
  if (smem_bytes(32, kpad, degree) <= (size_t)kMaxSmem) return 32;
  if (smem_bytes(16, kpad, degree) <= (size_t)kMaxSmem) return 16;
  return 0;
}

template <int D, int BN, bool kStream>
cudaError_t launch(const float* X, const uint8_t* mask, const float* mean,
                   const float* stdv, const float* W, const float* icpt,
                   const int* pairs, const int* src, uint16_t* Q, int64_t N,
                   int Bx, int By, int kpad, int64_t x_sp, int64_t x_sb,
                   int64_t q_sp, int64_t q_sb, int test_nodata,
                   double nodata, cudaStream_t stream) {
  const size_t smem = kStream ? smem_bytes_streamed(BN, kpad, D)
                              : smem_bytes(BN, kpad, D);
  auto kernel = sr_predict_tc_kernel<D, BN, kStream>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t n_tiles = (N + kTileM - 1) / kTileM;
  const int tiles_by = (By + BN - 1) / BN;
  // enough CTAs to fill the card once, spread over the band tiles
  int64_t bx = ((int64_t)sms * per_sm + tiles_by - 1) / tiles_by;
  const int64_t cta_tiles = (n_tiles + kWarpgroups - 1) / kWarpgroups;
  if (bx > cta_tiles) bx = cta_tiles;
  const double tol = 1e-8 + 1e-5 * fabs(nodata);
  kernel<<<dim3((unsigned int)bx, tiles_by), kThreads, smem, stream>>>(
      X, mask, mean, stdv, W, icpt, pairs, src, Q, N, Bx, By, kpad, x_sp,
      x_sb, q_sp, q_sb, test_nodata, nodata, tol, n_tiles);
  return cudaGetLastError();
}

// route: 32 or 16 bands per CTA with W resident, 0 for the streamed route
template <int D>
cudaError_t launch_d(int bn, const float* X, const uint8_t* mask,
                     const float* mean, const float* stdv, const float* W,
                     const float* icpt, const int* pairs, const int* src,
                     uint16_t* Q, int64_t N, int Bx, int By, int kpad,
                     int64_t x_sp, int64_t x_sb, int64_t q_sp, int64_t q_sb,
                     int test_nodata, double nodata, cudaStream_t s) {
  if (bn == 0) {
    return launch<D, kStreamBN, true>(X, mask, mean, stdv, W, icpt, pairs,
                                      src, Q, N, Bx, By, kpad, x_sp, x_sb,
                                      q_sp, q_sb, test_nodata, nodata, s);
  }
  if (bn == 32) {
    return launch<D, 32, false>(X, mask, mean, stdv, W, icpt, pairs, src, Q,
                                N, Bx, By, kpad, x_sp, x_sb, q_sp, q_sb,
                                test_nodata, nodata, s);
  }
  return launch<D, 16, false>(X, mask, mean, stdv, W, icpt, pairs, src, Q, N,
                              Bx, By, kpad, x_sp, x_sb, q_sp, q_sb,
                              test_nodata, nodata, s);
}

cudaError_t launch_degree(int degree, int bn, const float* X,
                          const uint8_t* mask, const float* mean,
                          const float* stdv, const float* W,
                          const float* icpt, const int* pairs,
                          const int* src, uint16_t* Q, int64_t N, int Bx,
                          int By, int kpad, int64_t x_sp, int64_t x_sb,
                          int64_t q_sp, int64_t q_sb, int test_nodata,
                          double nodata, cudaStream_t s) {
  switch (degree) {
    case 1:
      return launch_d<1>(bn, X, mask, mean, stdv, W, icpt, pairs, src, Q, N,
                         Bx, By, kpad, x_sp, x_sb, q_sp, q_sb, test_nodata,
                         nodata, s);
    case 2:
      return launch_d<2>(bn, X, mask, mean, stdv, W, icpt, pairs, src, Q, N,
                         Bx, By, kpad, x_sp, x_sb, q_sp, q_sb, test_nodata,
                         nodata, s);
    case 3:
      return launch_d<3>(bn, X, mask, mean, stdv, W, icpt, pairs, src, Q, N,
                         Bx, By, kpad, x_sp, x_sb, q_sp, q_sb, test_nodata,
                         nodata, s);
    default:
      return launch_d<4>(bn, X, mask, mean, stdv, W, icpt, pairs, src, Q, N,
                         Bx, By, kpad, x_sp, x_sb, q_sp, q_sb, test_nodata,
                         nodata, s);
  }
}

}  // namespace

// Output bands per CTA for kcols K columns (2 per pair) at `degree`, 0
// where the kernel does not take them: the wrapper's mirror is checked
// against it.
extern "C" int sr_predict_tile_bands(int kcols, int degree) {
  if (kcols < kChunkK || kcols % kChunkK != 0 || degree < 1
      || degree > kMaxDegree) {
    return 0;
  }
  return tile_bands(kcols, degree);
}

// pairs: (n_pairs, degree <= 3 ? 4 : 5) xs rows per pair (row 0 the
// constant one, row b + 1 input band b): the prefix (padded to at least 2
// with row 0), then the two last factors; src: (2 n_pairs) W row of each
// K column, -1 for padding. Pair 4 s + t fills K columns 8 s + t and
// 8 s + t + 4. n_pairs is a multiple of 16. The resident route.
extern "C" int sr_predict_u16_f32(const float* X, const unsigned char* mask,
                                  const float* mean, const float* stdv,
                                  const float* W, const float* icpt,
                                  const int* pairs, const int* src,
                                  unsigned short* Q, long long N, int Bx,
                                  int By, int n_pairs, int degree,
                                  long long x_sp, long long x_sb,
                                  long long q_sp, long long q_sb,
                                  int test_nodata, double nodata,
                                  void* stream) {
  if (N <= 0 || By <= 0) return (int)cudaSuccess;
  const int kpad = 2 * n_pairs;
  const int bn = sr_predict_tile_bands(kpad, degree);
  if (Bx < 1 || Bx > kMaxBx || bn == 0 || By > 65535 * bn) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch_degree(degree, bn, X, mask, mean, stdv, W, icpt, pairs,
                            src, Q, N, Bx, By, kpad, x_sp, x_sb, q_sp, q_sb,
                            test_nodata, nodata, (cudaStream_t)stream);
}

// Whether the streamed route takes kcols K columns at `degree`: its ring
// and the resident pair entries fit in shared memory.
extern "C" int sr_predict_streamed_fits(int kcols, int degree) {
  return kcols >= kChunkK && kcols % kChunkK == 0 && degree >= 1
         && degree <= kMaxDegree
         && smem_bytes_streamed(kStreamBN, kcols, degree)
                <= (size_t)kMaxSmem;
}

// The streamed route. slabs: W in the K order of `pairs`, split into TF32
// hi and lo and laid out by the host (kernels/sr_predict.py:sr_w_slabs):
// [ceil(By / 32)][2 n_pairs / 32] slabs of 2048 floats, slab (jt, c) =
// K columns [32 c, 32 c + 32) of rows n < 32 (W_hi of band 32 jt + n) and
// 32 + n (W_lo), element (n, k) at (n / 8) * 256 + (k / 4) * 32 +
// (n % 8) * 4 + k % 4; zeros for padding columns and bands past By.
extern "C" int sr_predict_u16_streamed_f32(
    const float* X, const unsigned char* mask, const float* mean,
    const float* stdv, const float* slabs, const float* icpt,
    const int* pairs, unsigned short* Q, long long N, int Bx, int By,
    int n_pairs, int degree, long long x_sp, long long x_sb, long long q_sp,
    long long q_sb, int test_nodata, double nodata, void* stream) {
  if (N <= 0 || By <= 0) return (int)cudaSuccess;
  const int kpad = 2 * n_pairs;
  if (Bx < 1 || Bx > kMaxBx || !sr_predict_streamed_fits(kpad, degree)
      || By > 65535 * kStreamBN) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch_degree(degree, 0, X, mask, mean, stdv, slabs, icpt,
                            pairs, nullptr, Q, N, Bx, By, kpad, x_sp, x_sb,
                            q_sp, q_sb, test_nodata, nodata,
                            (cudaStream_t)stream);
}
