// RMSNorm for Hopper (sm_90a), with a plain C interface loaded through ctypes
// (src/repro_torch/kernels/rmsnorm/rmsnorm.py).
//
// Replaces the Pallas kernel src/repro/kernels/rmsnorm/rmsnorm.py
// _rmsnorm_kernel (K4), which is also what the reference model's XLA
// rmsnorm (src/repro/models/layers.py:46) computes. Per row x of width D:
//   var = sum_d x_d^2 / D        in f32 (x cast to f32 first)
//   r   = 1 / sqrt(var + eps)    in f32, then rounded to x's dtype
//   y   = (x * r) * scale        in x's dtype: x*r is rounded to the dtype,
//                                scale is rounded to the dtype, and their
//                                product is rounded again.
// For bf16 the float product of two bf16 values is exact, so rounding it
// with __float2bfloat16_rn gives the bf16 product: both roundings of the
// reference are reproduced exactly. r uses the correctly rounded 1/sqrtf,
// not the approximate rsqrtf (the f32 tolerance is 1e-5).
//
// The sum of squares has a fixed order, which the plain version in
// rmsnorm.py repeats, so kernel and plain version agree bit for bit: lane j
// adds x_j^2, x_{j+32}^2, ... in turn (products and sums rounded apart, no
// FMA), then the 32 lane sums meet in a halving tree (lane j with j + 16,
// then j + 8, ...), which is what the xor shuffles compute. Only this order
// differs from the reference's, and in bf16 it can move r across a rounding
// boundary: one bf16 step, 0.03 at outputs of 4 to 8.
//
// Bound on an H100 (3.35 TB/s HBM3): memory. Each element is read once and
// written once, with ~4 flops per element, far below the ~295 flops per byte
// where the card turns compute-bound. (180,224 x 128) bf16 moves 92.3 MB:
// at least 27.5 us. The design is the simple one: one warp per row, lanes
// striding over the row (coalesced 32-element sweeps), the sum of squares
// reduced with warp shuffles; the row is read a second time for the output
// pass, from L1/L2 (a 256-byte row stays resident).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

// value dtype codes, mirrored by _DTYPE_CODES in rmsnorm.py
enum DType : int { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round a float to T (round to nearest even)
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int64_t rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock +
                      (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const T* xr = x + row * d;
  T* outr = out + row * d;
  float ss = 0.0f;
  for (int j = lane; j < d; j += 32) {
    const float v = to_f32(xr[j]);
    ss = __fadd_rn(ss, __fmul_rn(v, v));
  }
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float var = ss / static_cast<float>(d);
  const float r = to_f32(from_f32<T>(1.0f / sqrtf(var + eps)));
  for (int j = lane; j < d; j += 32) {
    const float xr_r = to_f32(from_f32<T>(to_f32(xr[j]) * r));
    const float s = to_f32(from_f32<T>(scale[j]));
    outr[j] = from_f32<T>(xr_r * s);
  }
}

template <typename T>
int launch(const void* x, const float* scale, void* out, int64_t rows, int d,
           float eps, cudaStream_t st) {
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0)
    rmsnorm_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
        static_cast<const T*>(x), scale, static_cast<T*>(out), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: (rows, d) contiguous, dtype `dtype`; scale: (d,) f32 (the caller
// widens bf16 scales exactly). Launches on `stream`; returns the launch's
// cudaError_t (0 on success).
int repro_rmsnorm(const void* x, const void* scale, void* out, int64_t rows,
                  int d, float eps, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  switch (dtype) {
    case F32: return launch<float>(x, sc, out, rows, d, eps, st);
    case BF16: return launch<__nv_bfloat16>(x, sc, out, rows, d, eps, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
