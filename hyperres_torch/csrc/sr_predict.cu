// Fused ridge spectral-SR prediction to the u16 reflectance product.
//
// For pixel p and output band j:
//
//   xs_b   = (x[p, b] - mean[b]) / std[b]                 b < Bx
//   F_m    = prod_d [1, xs_0, ..., xs_{Bx-1}][fac[m, d]]   m < F
//   y      = sigmoid(clip(sum_m F_m * W[m, j] + intercept[j], -50, 50))
//   q[p,j] = valid(p) ? clip(rint(y * 1e4), 0, 65534) : 65535      (u16)
//
// valid(p) comes from a byte mask when one is given; otherwise the kernel
// tests the pixel's own bands: all finite and none within numpy's
// isclose of nodata (|x - nodata| <= 1e-8 + 1e-5 |nodata|, in double).
// X element (p, b) lies at p*x_sp + b*x_sb and Q element (p, j) at
// p*q_sp + j*q_sb (element strides), so one kernel serves the
// channel-major (Bx, N) -> (By, N) product layout and the row-major
// (N, Bx) -> (N, By) serving layout.
//
// Replaces the TPU kernels pallas_sr_predict_u16_cmajor and
// pallas_sr_predict_u16 (hyperres/kernels/pallas_ops.py:828 and :725).
// Those expand the monomials through one-hot selector matmuls on the MXU
// (99 % zeros) in a 16-row channel-major layout with the validity plane on
// row 15, both only to suit Mosaic's (8, 128) tiling. Here each monomial
// is formed directly from its <= 4 factors.
//
// What bounds it on Hopper: f32 arithmetic. Per pixel it does F * By FMAs
// (285 * 32 = 9,120 at the product shape) against 40 bytes read and
// 2 * By bytes written, so at 85 Mpx it needs ~1.55 TFLOP (>= ~23 ms on
// the f32 pipes) but only ~8.9 GB of HBM traffic (>= ~2.6 ms). What the
// design does about it:
//   - one block owns a tile of 32 output bands (grid y) and keeps that
//     tile's W columns (F x 32 f32), the factor table and the intercepts
//     in shared memory, loaded once: blocks walk the pixel tiles in a
//     grid-stride loop, so W crosses L2 once per block, not per tile;
//   - each thread owns kPix pixels and 32 register accumulators per pixel;
//     per monomial it reads the W row as 8 broadcast float4 loads and
//     issues 32 * kPix FMAs, so each shared load feeds several FMAs;
//   - a thread's standardised inputs sit in shared memory (band-major,
//     one column per pixel: no bank conflicts), because indexing a
//     register array by a factor known only at run time would send it to
//     local memory;
//   - X is read once and Q written once: no nan_to_num copy, no mask pass.
// Offsets are 64-bit: at 85 Mpx x 32 bands Q has 2.7e9 elements.
//
// C interface (built with nvcc into a shared library, loaded by ctypes):
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for shapes it does not
// take) so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;               // threads per block
constexpr int kPix = 2;                     // pixels per thread
constexpr int kTilePix = kThreads * kPix;   // pixels per tile
constexpr int kTileBy = 32;                 // output bands per block
constexpr int kMaxBx = 16;                  // input bands
constexpr int kMaxDegree = 4;               // factors per monomial

template <int D>
__global__ void __launch_bounds__(kThreads)
sr_predict_kernel(const float* __restrict__ X,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ mean,
                  const float* __restrict__ stdv,
                  const float* __restrict__ W,
                  const float* __restrict__ icpt,
                  const int* __restrict__ fac, uint16_t* __restrict__ Q,
                  int64_t N, int Bx, int By, int F, int64_t x_sp,
                  int64_t x_sb, int64_t q_sp, int64_t q_sb, int test_nodata,
                  double nodata, double nodata_tol, int64_t n_tiles) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);        // F x kTileBy
  int4* fac_s = reinterpret_cast<int4*>(w_s + F * kTileBy);  // F
  float* xs_s = reinterpret_cast<float*>(fac_s + F);   // (1+Bx) x kTilePix

  const int j0 = blockIdx.y * kTileBy;
  for (int i = threadIdx.x; i < F * kTileBy; i += kThreads) {
    const int m = i / kTileBy;
    const int j = j0 + i % kTileBy;
    w_s[i] = j < By ? W[(int64_t)m * By + j] : 0.0f;
  }
  // factors as offsets of rows of xs_s (row 0 is the constant one)
  for (int m = threadIdx.x; m < F; m += kThreads) {
    int f[kMaxDegree] = {0, 0, 0, 0};
#pragma unroll
    for (int d = 0; d < D; ++d) f[d] = fac[m * D + d] * kTilePix;
    fac_s[m] = make_int4(f[0], f[1], f[2], f[3]);
  }
  for (int i = threadIdx.x; i < kTilePix; i += kThreads) xs_s[i] = 1.0f;
  __syncthreads();

  // from here on a thread reads and writes only its own columns of xs_s
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t p0 = tile * kTilePix;
    bool valid[kPix];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int lp = threadIdx.x + k * kThreads;
      const int64_t p = p0 + lp;
      bool ok = p < N;
      if (ok && mask != nullptr) ok = mask[p] != 0;
      for (int b = 0; b < Bx; ++b) {
        const float x = p < N ? X[p * x_sp + b * x_sb] : 0.0f;
        if (mask == nullptr) {
          ok = ok && isfinite(x);
          if (test_nodata) ok = ok && !(fabs((double)x - nodata) <= nodata_tol);
        }
        xs_s[(b + 1) * kTilePix + lp] = (x - __ldg(mean + b)) / __ldg(stdv + b);
      }
      valid[k] = ok;
    }

    float acc[kPix][kTileBy];
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
#pragma unroll
      for (int jj = 0; jj < kTileBy; ++jj) acc[k][jj] = 0.0f;
    }
    const float* xs_t = xs_s + threadIdx.x;
    for (int m = 0; m < F; ++m) {
      const int4 fm = fac_s[m];
      const int off[kMaxDegree] = {fm.x, fm.y, fm.z, fm.w};
      float f[kPix];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        f[k] = xs_t[off[0] + k * kThreads];
#pragma unroll
        for (int d = 1; d < D; ++d) f[k] *= xs_t[off[d] + k * kThreads];
      }
      const float4* wr = reinterpret_cast<const float4*>(w_s + m * kTileBy);
#pragma unroll
      for (int q = 0; q < kTileBy / 4; ++q) {
        const float4 w4 = wr[q];
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          acc[k][4 * q + 0] = fmaf(f[k], w4.x, acc[k][4 * q + 0]);
          acc[k][4 * q + 1] = fmaf(f[k], w4.y, acc[k][4 * q + 1]);
          acc[k][4 * q + 2] = fmaf(f[k], w4.z, acc[k][4 * q + 2]);
          acc[k][4 * q + 3] = fmaf(f[k], w4.w, acc[k][4 * q + 3]);
        }
      }
    }

#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      const int64_t p = p0 + threadIdx.x + k * kThreads;
      if (p >= N) continue;
      uint16_t* qp = Q + p * q_sp;
#pragma unroll
      for (int jj = 0; jj < kTileBy; ++jj) {
        const int j = j0 + jj;
        if (j < By) {
          float z = acc[k][jj] + __ldg(icpt + j);
          z = fminf(fmaxf(z, -50.0f), 50.0f);
          const float y = 1.0f / (1.0f + expf(-z));
          const float qf = fminf(fmaxf(rintf(y * 10000.0f), 0.0f), 65534.0f);
          qp[j * q_sb] = valid[k] ? (uint16_t)qf : (uint16_t)65535;
        }
      }
    }
  }
}

template <int D>
cudaError_t launch(const float* X, const uint8_t* mask, const float* mean,
                   const float* stdv, const float* W, const float* icpt,
                   const int* fac, uint16_t* Q, int64_t N, int Bx, int By,
                   int F, int64_t x_sp, int64_t x_sb, int64_t q_sp,
                   int64_t q_sb, int test_nodata, double nodata,
                   cudaStream_t stream) {
  const size_t smem = (size_t)F * kTileBy * sizeof(float)
                      + (size_t)F * sizeof(int4)
                      + (size_t)(1 + kMaxBx) * kTilePix * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sr_predict_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, sr_predict_kernel<D>, kThreads, smem)) != cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t n_tiles = (N + kTilePix - 1) / kTilePix;
  const int tiles_by = (By + kTileBy - 1) / kTileBy;
  // enough blocks to fill the card once, spread over the band tiles
  int64_t bx = ((int64_t)sms * per_sm + tiles_by - 1) / tiles_by;
  if (bx > n_tiles) bx = n_tiles;
  const double tol = 1e-8 + 1e-5 * fabs(nodata);
  sr_predict_kernel<D><<<dim3((unsigned int)bx, tiles_by), kThreads, smem,
                         stream>>>(X, mask, mean, stdv, W, icpt, fac, Q, N,
                                   Bx, By, F, x_sp, x_sb, q_sp, q_sb,
                                   test_nodata, nodata, tol, n_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sr_predict_u16_f32(const float* X, const unsigned char* mask,
                                  const float* mean, const float* stdv,
                                  const float* W, const float* icpt,
                                  const int* fac, unsigned short* Q,
                                  long long N, int Bx, int By, int F,
                                  int degree, long long x_sp, long long x_sb,
                                  long long q_sp, long long q_sb,
                                  int test_nodata, double nodata,
                                  void* stream) {
  if (N <= 0 || By <= 0) return (int)cudaSuccess;
  if (Bx < 1 || Bx > kMaxBx || F < 1 || By > 65535 * kTileBy) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  switch (degree) {
    case 1:
      return (int)launch<1>(X, mask, mean, stdv, W, icpt, fac, Q, N, Bx, By,
                            F, x_sp, x_sb, q_sp, q_sb, test_nodata, nodata, s);
    case 2:
      return (int)launch<2>(X, mask, mean, stdv, W, icpt, fac, Q, N, Bx, By,
                            F, x_sp, x_sb, q_sp, q_sb, test_nodata, nodata, s);
    case 3:
      return (int)launch<3>(X, mask, mean, stdv, W, icpt, fac, Q, N, Bx, By,
                            F, x_sp, x_sb, q_sp, q_sb, test_nodata, nodata, s);
    case 4:
      return (int)launch<4>(X, mask, mean, stdv, W, icpt, fac, Q, N, Bx, By,
                            F, x_sp, x_sb, q_sp, q_sb, test_nodata, nodata, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
