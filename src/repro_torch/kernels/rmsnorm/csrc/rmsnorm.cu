// RMSNorm for Hopper (sm_90a), with a plain C interface loaded through ctypes
// (src/repro_torch/kernels/rmsnorm/rmsnorm.py).
//
// Replaces the Pallas kernel src/repro/kernels/rmsnorm/rmsnorm.py
// _rmsnorm_kernel (K4), which is also what the reference model's XLA
// rmsnorm (src/repro/models/layers.py:46) computes. Per row x of width d:
//   var = sum_i x_i^2 / d        in f32 (x cast to f32 first)
//   r   = 1 / sqrt(var + eps)    in f32, then rounded to x's dtype
//   y   = (x * r) * scale        in x's dtype: x*r is rounded to the dtype,
//                                scale is rounded to the dtype, and their
//                                product is rounded again.
// For bf16 the float product of two bf16 values is exact, so rounding it
// with __float2bfloat16_rn gives the bf16 product: both roundings of the
// reference are reproduced exactly. r uses the correctly rounded 1/sqrtf,
// not the approximate rsqrtf (the f32 tolerance is 1e-5). The scale is read
// in its own dtype (f32 or bf16) and rounded to x's dtype here.
//
// The order of the sum of squares, which the plain version in rmsnorm.py
// repeats, so the two agree bit for bit, whatever layout a call takes:
//  - the row is cut into 16-byte groups (8 bf16 or 4 f32 values; the last
//    one ragged, its missing values zero);
//  - each group's squares are added left to right, products and sums
//    rounded apart (no FMA);
//  - the n group sums meet in a halving tree: group g with g + N/2, then
//    g + N/4, ..., g + 1, where N is n rounded up to a power of two and the
//    missing groups are zero. Adding +0 is exact, so any larger power of two
//    gives the same bits: a layout pads the row to its own N.
// A thread holds groups t, t + P, t + 2P, ... of its row (P threads a row),
// so the tree's first levels are its own registers (group j with j + K/2,
// ...), the levels from P/2 down to 32 go through shared memory, and the
// last five are the xor shuffles of one warp. The order differs from the
// reference's, and in bf16 it can move r across a rounding boundary: one
// bf16 step, 0.03 at outputs of 4 to 8.
//
// Bound on an H100 (3.35 TB/s HBM3): memory. Each element is read once and
// written once, ~4 flops an element, far below the ~295 flops a byte where
// the card turns compute-bound: 8,000 x 2,048 bf16 moves 65.5 MB, at least
// 19.6 us. At decode's 4 rows the bytes take nanoseconds, and a call costs a
// launch plus one round trip to memory. The design: a row is read once,
// with 16-byte loads, all of a thread's loads in flight before the first
// add, and held in registers (at most 16 groups a thread) until its output
// is written from them. The scale is read once a block, rounded to x's dtype
// and kept in shared memory. The layout follows the rows
// (repro_rmsnorm_plan):
//  - many rows: 32 threads a row (16 while a row has at most 16 groups, so
//    two rows share a warp at d 128 bf16; N/16 beyond 512 groups), blocks
//    of 256 threads;
//  - few rows, where that grid would fill at most half the SMs: one row a
//    block, one group a thread up to 512 threads, so a row's loads all go
//    at once. (tools/k4_ab.py --sweep on an H100: this layout is ahead to
//    512 rows of d 2,048 and 4,096, level or behind from 1,024.)
// One launch a call. A row that starts off a 16-byte boundary, or whose
// width is not a multiple of 16 bytes, takes a scalar path in the same
// order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// dtype codes of x and the scale, mirrored by _DTYPE_CODES in rmsnorm.py
enum DType : int { F32 = 0, BF16 = 1 };

constexpr int kManyThreads = 256;     // a block of the many-rows layout
constexpr int kMaxTeam = 512;         // threads a row, at most
constexpr int kMaxK = 16;             // groups a thread, at most
constexpr int kMaxGroups = kMaxTeam * kMaxK;

// ptx:begin -- x's loads: read once, not kept in L1
__device__ __forceinline__ uint4 load_stream16(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
// ptx:end

// a value's bits, its float value, and a float rounded to it (to nearest
// even)
template <typename T> struct Elem;
template <> struct Elem<float> {
  using Bits = uint32_t;
  __device__ static float value(Bits b) { return __uint_as_float(b); }
  __device__ static Bits round(float v) { return __float_as_uint(v); }
};
template <> struct Elem<__nv_bfloat16> {
  using Bits = uint16_t;
  __device__ static float value(Bits b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  __device__ static Bits round(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// value i of values of T packed in words
template <typename T, int N>
__device__ __forceinline__ float get(const uint32_t (&w)[N], int i) {
  if constexpr (sizeof(T) == 4) {
    return Elem<T>::value(w[i]);
  } else {
    return Elem<T>::value(
        static_cast<uint16_t>(w[i >> 1] >> (16 * (i & 1))));
  }
}

// v rounded to T into value i of a 16-byte group whose words start at zero
template <typename T>
__device__ __forceinline__ void put(uint32_t (&w)[4], int i, float v) {
  const uint32_t b = Elem<T>::round(v);
  if constexpr (sizeof(T) == 4) {
    w[i] = b;
  } else {
    w[i >> 1] |= b << (16 * (i & 1));
  }
}

// values [c, c + 16 / sizeof(T)) of a row of d, into a group's words: one
// 16-byte load when `vec` (then the group is whole and aligned), else one
// load a value, zero past d
template <typename T>
__device__ __forceinline__ void load_group(uint32_t (&w)[4], const T* row,
                                           int c, int d, bool vec) {
  constexpr int G = 16 / sizeof(T);
  w[0] = w[1] = w[2] = w[3] = 0u;
  if (vec) {
    if (c < d) {
      const uint4 u = load_stream16(row + c);
      w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
    }
    return;
  }
  using B = typename Elem<T>::Bits;
  const B* bits = reinterpret_cast<const B*>(row);
#pragma unroll
  for (int i = 0; i < G; ++i)
    if (c + i < d)
      w[(i * sizeof(T)) / 4] |= static_cast<uint32_t>(bits[c + i])
                                << (8 * ((i * sizeof(T)) % 4));
}

// the scale's values [c, c + G) (G = 16 / sizeof(T)), rounded to T, as a
// group; zero past d
template <typename T, typename S>
__device__ __forceinline__ uint4 scale_group(const S* scale, int c, int d,
                                             bool vec) {
  constexpr int G = 16 / sizeof(T);
  constexpr int kBytes = G * sizeof(S);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if constexpr (kBytes >= 16) {
    if (vec && c + G <= d) {                 // 16-byte loads of S
      uint32_t s[kBytes / 4];
#pragma unroll
      for (int k = 0; k < kBytes / 16; ++k) {
        const uint4 u = load_stream16(reinterpret_cast<const uint8_t*>(
                                          scale + c) + 16 * k);
        s[4 * k] = u.x; s[4 * k + 1] = u.y; s[4 * k + 2] = u.z;
        s[4 * k + 3] = u.w;
      }
#pragma unroll
      for (int i = 0; i < G; ++i) put<T>(w, i, get<S>(s, i));
      uint4 u;
      u.x = w[0]; u.y = w[1]; u.z = w[2]; u.w = w[3];
      return u;
    }
  }
  using B = typename Elem<S>::Bits;
  const B* bits = reinterpret_cast<const B*>(scale);
#pragma unroll
  for (int i = 0; i < G; ++i)
    put<T>(w, i, c + i < d ? Elem<S>::value(bits[c + i]) : 0.0f);
  uint4 u;
  u.x = w[0]; u.y = w[1]; u.z = w[2]; u.w = w[3];
  return u;
}

// Rows of d values of T, `team` threads a row (a power of two, 16..512),
// blockDim.x / team rows a block, K groups a thread (team * K >= the row's
// groups). Dynamic shared memory: team * K groups of the scale as T, then,
// when team > 32, one float a thread for the tree's middle levels.
template <typename T, typename S, int K>
__global__ void __launch_bounds__(kMaxTeam)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ out, int64_t rows, int d, float eps, int team,
               int vec, int scale_vec) {
  constexpr int G = 16 / sizeof(T);
  extern __shared__ uint4 smem[];
  uint4* sc = smem;
  float* tree = reinterpret_cast<float*>(smem + team * K);
  const int tid = static_cast<int>(threadIdx.x);
  const int t = tid & (team - 1);
  const int64_t row = static_cast<int64_t>(blockIdx.x) *
                          (static_cast<int>(blockDim.x) / team) + tid / team;
  const bool live = row < rows;   // a dead row loads nothing, stores nothing
  const T* xr = x + (live ? row : 0) * d;
  const int dl = live ? d : 0;

  // the row's groups t, t + team, ..., all loads in flight
  uint32_t w[K][4];
#pragma unroll
  for (int j = 0; j < K; ++j)
    load_group<T>(w[j], xr, (t + team * j) * G, dl, vec != 0);

  // the scale, once a block: the block's threads stage its groups in turn
  for (int q = tid; q < team * K; q += static_cast<int>(blockDim.x))
    sc[q] = scale_group<T, S>(scale, q * G, d, scale_vec != 0);

  // each group left to right, then the tree: K groups in registers ...
  float s[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float a = get<T>(w[j], 0);
    a = __fmul_rn(a, a);
#pragma unroll
    for (int i = 1; i < G; ++i) {
      const float v = get<T>(w[j], i);
      a = __fadd_rn(a, __fmul_rn(v, v));
    }
    s[j] = a;
  }
#pragma unroll
  for (int h = K / 2; h > 0; h >>= 1)
#pragma unroll
    for (int j = 0; j < h; ++j) s[j] = __fadd_rn(s[j], s[j + h]);
  float ss = s[0];
  // ... the levels team/2 .. 32 through shared memory ...
  if (team > 32) {
    tree[tid] = ss;
    __syncthreads();
    for (int h = team / 2; h >= 32; h >>= 1) {
      if (t < h) tree[tid] = __fadd_rn(tree[tid], tree[tid + h]);
      __syncthreads();
    }
    ss = tree[tid - t + (t & 31)];   // every warp of the row takes them
  }
  // ... and the last levels across a warp's lanes
  for (int off = (team < 32 ? team : 32) / 2; off > 0; off >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));

  const float var = ss / static_cast<float>(d);
  const float r = Elem<T>::value(Elem<T>::round(1.0f / sqrtf(var + eps)));
  __syncthreads();   // the staged scale

  // the output, from the same registers
  using B = typename Elem<T>::Bits;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = (t + team * j) * G;
    const uint4 su = sc[t + team * j];
    const uint32_t sw[4] = {su.x, su.y, su.z, su.w};
    uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float xr_r =
          Elem<T>::value(Elem<T>::round(__fmul_rn(get<T>(w[j], i), r)));
      put<T>(o, i, __fmul_rn(xr_r, get<T>(sw, i)));
    }
    if (!live || c >= d) continue;
    T* orow = out + row * d;
    if (vec) {
      uint4 u;
      u.x = o[0]; u.y = o[1]; u.z = o[2]; u.w = o[3];
      *reinterpret_cast<uint4*>(orow + c) = u;
    } else {
      B* bits = reinterpret_cast<B*>(orow);
#pragma unroll
      for (int i = 0; i < G; ++i)
        if (c + i < d)
          bits[c + i] = static_cast<B>(o[(i * sizeof(T)) / 4] >>
                                       (8 * ((i * sizeof(T)) % 4)));
    }
  }
}

// the current device's SM count, asked once a device
int sm_count() {
  static int known[64];
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev >= 0 && dev < 64 && known[dev]) return known[dev];
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    return 1;
  if (dev >= 0 && dev < 64) known[dev] = sms;
  return sms;
}

int itemsize(int dtype) { return dtype == F32 ? 4 : 2; }

// a row's 16-byte groups, rounded up to a power of two (at least 1)
int padded_groups(int d, int dtype) {
  const int G = 16 / itemsize(dtype);
  const int n = (d + G - 1) / G;
  int N = 1;
  while (N < n) N <<= 1;
  return N;
}

template <typename T, typename S, int K>
int launch_k(const void* x, const void* scale, void* out, int64_t rows,
             int d, float eps, int team, int rpb, cudaStream_t st) {
  const int threads = team * rpb;
  const int64_t blocks = (rows + rpb - 1) / rpb;
  const size_t smem = static_cast<size_t>(team) * K * 16 +
                      (team > 32 ? static_cast<size_t>(threads) * 4 : 0);
  auto* kern = rmsnorm_kernel<T, S, K>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x),
                  oa = reinterpret_cast<uintptr_t>(out),
                  sa = reinterpret_cast<uintptr_t>(scale);
  const int vec = xa % 16 == 0 && oa % 16 == 0 &&
                  (static_cast<int64_t>(d) * sizeof(T)) % 16 == 0;
  const int scale_vec = sa % 16 == 0;
  kern<<<static_cast<unsigned>(blocks), threads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(out), rows, d, eps, team, vec, scale_vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename S>
int launch_s(const void* x, const void* scale, void* out, int64_t rows,
             int d, float eps, int team, int rpb, int K, cudaStream_t st) {
  switch (K) {
    case 1: return launch_k<T, S, 1>(x, scale, out, rows, d, eps, team, rpb, st);
    case 2: return launch_k<T, S, 2>(x, scale, out, rows, d, eps, team, rpb, st);
    case 4: return launch_k<T, S, 4>(x, scale, out, rows, d, eps, team, rpb, st);
    case 8: return launch_k<T, S, 8>(x, scale, out, rows, d, eps, team, rpb, st);
    case 16: return launch_k<T, S, 16>(x, scale, out, rows, d, eps, team, rpb, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_t(const void* x, const void* scale, void* out, int64_t rows,
             int d, float eps, int scale_dtype, int team, int rpb, int K,
             cudaStream_t st) {
  switch (scale_dtype) {
    case F32: return launch_s<T, float>(x, scale, out, rows, d, eps, team, rpb, K, st);
    case BF16: return launch_s<T, __nv_bfloat16>(x, scale, out, rows, d, eps, team, rpb, K, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The layout repro_rmsnorm takes for `rows` rows of `d` values of `dtype`
// (F32 or BF16) on the current device: *team threads a row and *rpb rows a
// block. Many rows: 32 threads a row (16 at up to 16 groups, N/16 past 512
// groups), 256-thread blocks. Few rows, where that grid would have at most
// half as many blocks as the card has SMs: one row a block, one group a
// thread (at
// most 512 threads; 16 at up to 16 groups, two rows a block). Returns 0, or
// cudaErrorInvalidValue for a row of more than 8,192 groups.
int repro_rmsnorm_plan(int64_t rows, int d, int dtype, int* team, int* rpb) {
  if (d < 1 || (dtype != F32 && dtype != BF16)) return cudaErrorInvalidValue;
  const int N = padded_groups(d, dtype);
  if (N > kMaxGroups) return cudaErrorInvalidValue;
  const int many = N <= 16 ? 16 : N <= 32 * kMaxK ? 32 : N / kMaxK;
  const int many_rpb = many < kManyThreads ? kManyThreads / many : 1;
  if (2 * ((rows + many_rpb - 1) / many_rpb) > sm_count()) {
    *team = many;
    *rpb = many_rpb;
  } else {
    *team = N < 16 ? 16 : N > kMaxTeam ? kMaxTeam : N;
    *rpb = *team < 32 ? 32 / *team : 1;
  }
  return 0;
}

// x, out: (rows, d) rows of contiguous values, dtype `dtype` (F32 or BF16);
// scale: (d,) contiguous, dtype `scale_dtype` (F32 or BF16). `team`
// threads a row (a power of two, 16..512) and `rpb` rows a block, whole
// warps; a row of more groups than team * 16 is refused. Launches on
// `stream`; returns the launch's cudaError_t (0 on success).
int repro_rmsnorm_layout(const void* x, const void* scale, void* out,
                         int64_t rows, int d, float eps, int dtype,
                         int scale_dtype, int team, int rpb, void* stream) {
  if (rows < 1 || d < 1) return 0;
  if ((dtype != F32 && dtype != BF16) || team < 16 || team > kMaxTeam ||
      (team & (team - 1)) || rpb < 1 || team * rpb > kMaxTeam ||
      (team * rpb) % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int N = padded_groups(d, dtype);
  const int K = N > team ? N / team : 1;
  if (K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F32)
    return launch_t<float>(x, scale, out, rows, d, eps, scale_dtype, team,
                           rpb, K, st);
  return launch_t<__nv_bfloat16>(x, scale, out, rows, d, eps, scale_dtype,
                                 team, rpb, K, st);
}

// The same in the layout of repro_rmsnorm_plan: one launch.
int repro_rmsnorm(const void* x, const void* scale, void* out, int64_t rows,
                  int d, float eps, int dtype, int scale_dtype, void* stream) {
  if (rows < 1 || d < 1) return 0;
  int team = 0, rpb = 0;
  const int rc = repro_rmsnorm_plan(rows, d, dtype, &team, &rpb);
  if (rc) return rc;
  return repro_rmsnorm_layout(x, scale, out, rows, d, eps, dtype,
                              scale_dtype, team, rpb, stream);
}

}  // extern "C"
