// Quantization of float32 values to uint16 codes with a nodata sentinel.
//
// For element i of an array whose last axis has C entries (band b = i % C):
//
//   stats form  : s = ((x - lo[b]) / (hi[b] - lo[b] + 1e-32)) * 65535
//   pallas form : s = (x - lo[b]) * scale[b]
//   q[i] = valid(i) ? clip(rint(s), q_lo, q_hi) : sentinel          (u16)
//
// The stats form is hyperres/kernels/stats.py:289 quantize_u16, the
// quantizer behind every u16 GeoTIFF product; the pallas form is
// pallas_quantize_u16 (hyperres/kernels/pallas_ops.py:122), whose scale
// 65535 / (hi - lo + 1e-32) the caller computes in double and rounds to
// float. lo and the second operand are per-band arrays read with a band
// stride of 1, or scalars read with a stride of 0. rint is rintf (half to
// even, as jnp.rint). q_lo / q_hi keep the sentinel reserved:
// q_lo = 1 when the sentinel is 0, q_hi = 65534 when it is 65535.
//
// valid(i) comes from a byte mask when one is given; otherwise the kernel
// tests the value itself: isfinite(x), and x != nodata_src when a source
// nodata is given (ortho/products.py's _valid_mask), so no host mask pass
// is needed. An invalid element gets the sentinel without going through
// the float-to-integer conversion (NaN -> u16 is undefined).
//
// The subtract, divide, multiply and add are written with the _rn
// intrinsics and the build uses no --use_fast_math, so nvcc contracts
// nothing into an FMA and the codes are the plain version's, bit for bit.
//
// What bounds it on Hopper: memory. Per element it reads 4 bytes (5 with
// a mask) and writes 2, with a handful of operations, so the floor is
// ~6 bytes per element at 3.35 TB/s (the full-size reflectance product,
// 673 M elements, ~4.0 GB: ~1.2 ms). The design: one thread per 4
// consecutive elements, read as one float4 and written as one 8-byte
// store where the base pointers allow it, in a grid-stride loop over
// enough blocks to fill the card; the band index advances with the
// element, with no division inside the loop.
//
// Replaces the TPU kernel pallas_quantize_u16
// (hyperres/kernels/pallas_ops.py:122, pallas_call :158), which pads the
// array to (2048-row, 128-lane) tiles and ships a float validity plane of
// the padded size; here nothing is padded and the mask, when given, is
// one byte per element.
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
constexpr int kVec = 4;  // elements per thread and step

template <bool kPallasForm>
__device__ __forceinline__ uint16_t quantize_one(
    float x, bool ok, float lo, float p2, float q_lo, float q_hi,
    uint16_t sentinel) {
  if (!ok) return sentinel;
  float s;
  if (kPallasForm) {
    s = __fmul_rn(__fsub_rn(x, lo), p2);
  } else {
    const float den = __fadd_rn(__fsub_rn(p2, lo), 1e-32f);
    s = __fmul_rn(__fdiv_rn(__fsub_rn(x, lo), den), 65535.0f);
  }
  const float q = fminf(fmaxf(rintf(s), q_lo), q_hi);
  return (uint16_t)q;
}

__device__ __forceinline__ bool valid_at(float x, const uint8_t* mask,
                                         int64_t i, int test_nodata,
                                         float nodata_src) {
  if (mask != nullptr) return mask[i] != 0;
  bool ok = isfinite(x);
  if (test_nodata) ok = ok && x != nodata_src;
  return ok;
}

template <bool kPallasForm>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                const float* __restrict__ lo, const float* __restrict__ p2,
                int band_stride, uint16_t* __restrict__ q, int64_t n, int C,
                int test_nodata, float nodata_src, float q_lo, float q_hi,
                uint16_t sentinel, int vec_ok) {
  const int64_t n_vec = vec_ok ? n / kVec : 0;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; v < n_vec;
       v += step) {
    const int64_t i0 = v * kVec;
    const float4 x4 = reinterpret_cast<const float4*>(x)[v];
    const float xs[kVec] = {x4.x, x4.y, x4.z, x4.w};
    int b = (int)(i0 % C);
    uint16_t out[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int bi = b * band_stride;
      out[k] = quantize_one<kPallasForm>(
          xs[k], valid_at(xs[k], mask, i0 + k, test_nodata, nodata_src),
          __ldg(lo + bi), __ldg(p2 + bi), q_lo, q_hi, sentinel);
      if (++b == C) b = 0;
    }
    ushort4 o4;
    o4.x = out[0];
    o4.y = out[1];
    o4.z = out[2];
    o4.w = out[3];
    reinterpret_cast<ushort4*>(q)[v] = o4;
  }
  // the tail (or every element when the pointers are not aligned)
  for (int64_t i = n_vec * kVec + (int64_t)blockIdx.x * blockDim.x +
                   threadIdx.x;
       i < n; i += step) {
    const float xv = x[i];
    const int bi = (int)(i % C) * band_stride;
    q[i] = quantize_one<kPallasForm>(
        xv, valid_at(xv, mask, i, test_nodata, nodata_src), __ldg(lo + bi),
        __ldg(p2 + bi), q_lo, q_hi, sentinel);
  }
}

template <bool kPallasForm>
cudaError_t launch(const float* x, const uint8_t* mask, const float* lo,
                   const float* p2, int band_stride, uint16_t* q, int64_t n,
                   int C, int test_nodata, float nodata_src, float q_lo,
                   float q_hi, uint16_t sentinel, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, quantize_kernel<kPallasForm>, kThreads, 0)) !=
      cudaSuccess) {
    return err;
  }
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int vec_ok = ((uintptr_t)x % 16 == 0) && ((uintptr_t)q % 8 == 0);
  const int64_t work = vec_ok ? (n + kVec - 1) / kVec : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t fill = (int64_t)sms * per_sm;
  if (blocks > fill) blocks = fill;
  quantize_kernel<kPallasForm><<<(unsigned int)blocks, kThreads, 0, stream>>>(
      x, mask, lo, p2, band_stride, q, n, C, test_nodata, nodata_src, q_lo,
      q_hi, sentinel, vec_ok);
  return cudaGetLastError();
}

}  // namespace

// form: 0 = stats (p2 holds hi), 1 = pallas (p2 holds scale).
// sentinel: 0 or 65535 reserve their code; any other value reserves none.
extern "C" int quantize_u16_f32(const float* x, const unsigned char* mask,
                                const float* lo, const float* p2,
                                int band_stride, unsigned short* q,
                                long long n, int C, int form, int test_nodata,
                                float nodata_src, int sentinel,
                                void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (C < 1 || (band_stride != 0 && band_stride != 1) || sentinel < 0 ||
      sentinel > 65535 || (form != 0 && form != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const float q_lo = sentinel == 0 ? 1.0f : 0.0f;
  const float q_hi = sentinel == 65535 ? 65534.0f : 65535.0f;
  cudaStream_t s = (cudaStream_t)stream;
  if (form == 1) {
    return (int)launch<true>(x, mask, lo, p2, band_stride, q, n, C,
                             test_nodata, nodata_src, q_lo, q_hi,
                             (uint16_t)sentinel, s);
  }
  return (int)launch<false>(x, mask, lo, p2, band_stride, q, n, C,
                            test_nodata, nodata_src, q_lo, q_hi,
                            (uint16_t)sentinel, s);
}
