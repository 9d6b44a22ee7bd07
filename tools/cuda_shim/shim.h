// Runs a CUDA source of the port on the CPU for rehearsal without a card:
// one std::thread per CUDA thread, the blocks one after another. It stands
// in for what the kernels use: 3-D grids (blockIdx, blockDim, gridDim), __syncthreads, warp shuffles,
// votes and __syncwarp, float2, float4, uint2, uint4, bf16 and f16
// conversions, f32 adds and multiplies rounded apart (__fadd_rn,
// __fmul_rn), atomics on u32 (atomicAdd, atomicCAS), __threadfence,
// __ldcg, the device's SM count (2 here), and the
// inline PTX statements of checksum.cu, flash_attention.cu, mamba2_ssd.cu,
// rwkv6.cu, rmsnorm.cu and mamba2_glue.cu (the functions between their "ptx:begin" and "ptx:end"
// lines, which build.py drops): streaming loads (alignment checked), an
// acq_rel ticket, mbarriers
// (arrivals and transaction bytes per phase), TMA box loads (bounds, zero
// fill, the tensor map's alignment rules and the swizzle on shared-memory
// address bits), setmaxnreg, wgmma in its SS and RS forms (bf16 in, f32
// accumulate) reading shared memory through its descriptors, and
// cvt.rna.tf32.f32 and mma.sync.m16n8k8 TF32 (the warp's fragments
// gathered in PTX's layout, products in double, the bits below TF32 of
// each operand ignored, as the tensor cores ignore them), and cp.async in
// commit groups (a destination reads NaN from the copy's issue until a
// wait_group lets its group complete, so a read before the wait, or a copy
// into a stage that is still being read, shows; a write into it meanwhile
// aborts). A wgmma result lands at wgmma_wait; until then its accumulator
// registers read as NaN, so a read before the wait shows.
// An mbarrier wait that does not complete in 30 s aborts with the barrier
// and the waiting thread, so a wrong phase shows as a message, not a hang.
// What it cannot show: the PTX's syntax, register pressure, and whether the
// hardware reads the descriptors as this file does (the card tests do).
#pragma once
#include <algorithm>
#include <barrier>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <atomic>
#include <bit>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define CUDART_VERSION 12080

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3s { unsigned x = 0, y = 0, z = 0; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) uint2 { uint32_t x, y; };
struct alignas(16) uint4 { uint32_t x, y, z, w; };
struct alignas(8) float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline uint2 make_uint2(uint32_t x, uint32_t y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline thread_local uint3s threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1,
                   cudaErrorNotSupported = 801 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline thread_local cudaError_t shim_last_error = cudaSuccess;
inline cudaError_t cudaGetLastError() {
  cudaError_t e = shim_last_error;
  shim_last_error = cudaSuccess;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "shim error";
}
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  if (a != cudaDevAttrMultiProcessorCount) return cudaErrorInvalidValue;
  *v = 2;
  return cudaSuccess;
}
template <typename F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int bytes) {
  return bytes <= 232448 ? cudaSuccess : cudaErrorInvalidValue;
}

// -- CUDA types of the tensor map ------------------------------------------
typedef uint64_t cuuint64_t;
typedef uint32_t cuuint32_t;
typedef int CUresult;
#define CUDA_SUCCESS 0
enum CUtensorMapDataType { CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 = 9 };
enum CUtensorMapInterleave { CU_TENSOR_MAP_INTERLEAVE_NONE = 0 };
enum CUtensorMapSwizzle { CU_TENSOR_MAP_SWIZZLE_NONE = 0,
                          CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_SWIZZLE_64B,
                          CU_TENSOR_MAP_SWIZZLE_128B };
enum CUtensorMapL2promotion { CU_TENSOR_MAP_L2_PROMOTION_NONE = 0,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_128B = 2 };
enum CUtensorMapFloatOOBfill { CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE = 0 };
struct CUtensorMap {
  const uint8_t* base;
  int rank;
  uint64_t dims[5], strides[5];   // strides in bytes, strides[0] = 2
  uint32_t box[5];
  int swz;                        // swizzle span in bytes, 0 for none
};
typedef CUresult (*PFN_cuTensorMapEncodeTiled_v12000)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled's checks that the port relies on: base 16-byte aligned,
// strides multiples of 16 below 2^40, box dims 1..256, the inner box row
// within the swizzle span.
inline CUresult shim_encode_tiled(
    CUtensorMap* m, CUtensorMapDataType, cuuint32_t rank, void* base,
    const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
    const cuuint32_t* estr, CUtensorMapInterleave, CUtensorMapSwizzle swz,
    CUtensorMapL2promotion, CUtensorMapFloatOOBfill) {
  if (reinterpret_cast<uintptr_t>(base) % 16 || rank < 1 || rank > 5)
    return 1;
  m->base = static_cast<const uint8_t*>(base);
  m->rank = static_cast<int>(rank);
  m->strides[0] = 2;
  for (cuuint32_t i = 0; i < rank; ++i) {
    if (dims[i] == 0 || dims[i] > (1ull << 32) || box[i] == 0 ||
        box[i] > 256 || estr[i] != 1)
      return 1;
    m->dims[i] = dims[i];
    m->box[i] = box[i];
    if (i > 0) {
      if (strides[i - 1] % 16 || strides[i - 1] >= (1ull << 40)) return 1;
      m->strides[i] = strides[i - 1];
    }
  }
  m->swz = swz == CU_TENSOR_MAP_SWIZZLE_128B ? 128
           : swz == CU_TENSOR_MAP_SWIZZLE_64B ? 64
           : swz == CU_TENSOR_MAP_SWIZZLE_32B ? 32 : 0;
  if ((box[0] * 2) % 16 || (m->swz && box[0] * 2 > unsigned(m->swz))) return 1;
  return 0;
}
enum cudaDriverEntryPointQueryResult { cudaDriverEntryPointSuccess = 0 };
enum { cudaEnableDefault = 0 };
inline cudaError_t cudaGetDriverEntryPointByVersion(
    const char* sym, void** fn, unsigned, unsigned long long,
    cudaDriverEntryPointQueryResult* q) {
  if (std::strcmp(sym, "cuTensorMapEncodeTiled") != 0) return cudaErrorInvalidValue;
  *fn = reinterpret_cast<void*>(&shim_encode_tiled);
  *q = cudaDriverEntryPointSuccess;
  return cudaSuccess;
}

// -- bf16 --------------------------------------------------------------------
struct __nv_bfloat16 { uint16_t x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u = __float_as_uint(f);
  if (std::isnan(f)) return {static_cast<uint16_t>((u >> 16) | 0x40)};
  u += 0x7fff + ((u >> 16) & 1);
  return {static_cast<uint16_t>(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) { return __uint_as_float(uint32_t(b.x) << 16); }
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.x; }
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return {__float2bfloat16_rn(lo), __float2bfloat16_rn(hi)};
}
// -- f16, integer conversions, bit counts -----------------------------------
struct __half { uint16_t x; };
inline __half __ushort_as_half(unsigned short u) { return {u}; }
inline float __half2float(__half h) {   // exact, subnormals, inf and NaN
  const uint32_t sign = uint32_t(h.x >> 15) << 31, e = (h.x >> 10) & 0x1f,
                 m = h.x & 0x3ff;
  if (e == 31) return __uint_as_float(sign | 0x7f800000u | (m << 13));
  const float f = e ? std::ldexp(float(m | 0x400), int(e) - 25)
                    : std::ldexp(float(m), -24);
  return sign ? -f : f;
}
inline float __int2float_rn(int x) { return static_cast<float>(x); }
// f32 products and sums rounded apart (build.py compiles with
// -ffp-contract=off, so nothing fuses them)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __uint2float_rn(unsigned x) { return static_cast<float>(x); }
inline int __popc(unsigned x) { return std::popcount(x); }
inline int __clz(int x) { return std::countl_zero(static_cast<uint32_t>(x)); }

// -- memory: loads past L1, fences, atomics (threads of a block run at once) --
template <typename T> inline T __ldcg(const T* p) { return *p; }
// checksum.cu's streaming loads (ld.global.nc.L1::no_allocate)
inline uint4 load_stream16(const void* p) {
  if (reinterpret_cast<uintptr_t>(p) % 16) {
    std::fprintf(stderr, "shim: 16-byte load from a misaligned address\n");
    std::abort();
  }
  uint4 v; std::memcpy(&v, p, 16); return v;
}
inline uint32_t ticket_acq_rel(uint32_t* p) {   // atom.acq_rel.gpu.add 1
  std::atomic_thread_fence(std::memory_order_seq_cst);
  return std::atomic_ref<uint32_t>(*p).fetch_add(1u);
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}
inline unsigned atomicCAS(unsigned* p, unsigned cmp, unsigned v) {
  std::atomic_ref<unsigned>(*p).compare_exchange_strong(cmp, v);
  return cmp;
}
inline int min(int a, int b) { return a < b ? a : b; }
inline int64_t min(int64_t a, int64_t b) { return a < b ? a : b; }

// -- blocks, warps, barriers -------------------------------------------------
struct ShimBar { int count = 0, pending = 0; int64_t tx = 0; uint32_t phase = 0; };
struct ShimBlock {
  uint8_t* smem = nullptr;
  std::unique_ptr<std::barrier<>> block;
  std::vector<std::unique_ptr<std::barrier<>>> warp, wg;
  std::vector<float> shfl;                 // one word per thread
  std::vector<float> wg_a;                 // per warpgroup: A, 64 x 16
  std::vector<float> mma_a, mma_b;         // per warp: A 16 x 8, B 8 x 8
  std::mutex mu;
  std::map<uint32_t, ShimBar> bars;
};
inline thread_local ShimBlock* shim_blk = nullptr;
inline uint8_t* shim_smem() { return shim_blk->smem; }
inline void __syncthreads() { shim_blk->block->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  shim_blk->warp[threadIdx.x / 32]->arrive_and_wait();
}
template <typename T>
T __shfl_xor_sync(unsigned, T v, int mask) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  float f; std::memcpy(&f, &v, 4);
  const unsigned t = threadIdx.x, w = t / 32;
  shim_blk->shfl[t] = f;
  __syncwarp();
  float r = shim_blk->shfl[w * 32 + ((t % 32) ^ unsigned(mask))];
  __syncwarp();
  T out; std::memcpy(&out, &r, 4);
  return out;
}

template <typename T>
T __shfl_down_sync(unsigned, T v, unsigned delta) {   // lanes >= 32 - delta keep v
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  float f; std::memcpy(&f, &v, 4);
  const unsigned t = threadIdx.x, lane = t % 32;
  shim_blk->shfl[t] = f;
  __syncwarp();
  float r = lane + delta < 32 && t + delta < shim_blk->shfl.size()
                ? shim_blk->shfl[t + delta] : f;
  __syncwarp();
  T out; std::memcpy(&out, &r, 4);
  return out;
}

template <typename T>
T __shfl_up_sync(unsigned, T v, unsigned delta) {   // lanes < delta keep v
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  float f; std::memcpy(&f, &v, 4);
  const unsigned t = threadIdx.x, lane = t % 32;
  shim_blk->shfl[t] = f;
  __syncwarp();
  float r = lane >= delta ? shim_blk->shfl[t - delta] : f;
  __syncwarp();
  T out; std::memcpy(&out, &r, 4);
  return out;
}

inline int __any_sync(unsigned, int pred) {
  const unsigned t = threadIdx.x, w = t / 32;
  shim_blk->shfl[t] = pred ? 1.0f : 0.0f;
  __syncwarp();
  int any = 0;
  for (unsigned i = 0; i < 32 && w * 32 + i < shim_blk->shfl.size(); ++i)
    any |= shim_blk->shfl[w * 32 + i] != 0.0f;
  __syncwarp();
  return any;
}

// -- the kernels' PTX statements ----------------------------------------------
inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(static_cast<const uint8_t*>(p) - shim_blk->smem);
}
inline float ex2(float x) {
  const float y = std::exp2(x);
  return y < 1.17549435e-38f ? 0.0f : y;
}
inline void mbar_init(uint32_t bar, uint32_t count) {
  std::lock_guard<std::mutex> g(shim_blk->mu);
  ShimBar& b = shim_blk->bars[bar];
  b.count = b.pending = static_cast<int>(count);
  b.tx = 0;
  b.phase = 0;
}
inline void mbar_fence_init() {}
inline void shim_bar_step(ShimBar& b) {     // under the lock
  if (b.pending == 0 && b.tx == 0) {
    b.phase ^= 1;
    b.pending = b.count;
  }
}
inline ShimBar& shim_bar(uint32_t bar) {
  auto it = shim_blk->bars.find(bar);
  if (it == shim_blk->bars.end()) {
    std::fprintf(stderr, "shim: mbarrier at %u used before init\n", bar);
    std::abort();
  }
  return it->second;
}
inline void mbar_arrive(uint32_t bar) {
  std::lock_guard<std::mutex> g(shim_blk->mu);
  ShimBar& b = shim_bar(bar);
  if (--b.pending < 0) { std::fprintf(stderr, "shim: too many arrivals\n"); std::abort(); }
  shim_bar_step(b);
}
inline void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  std::lock_guard<std::mutex> g(shim_blk->mu);
  ShimBar& b = shim_bar(bar);
  b.tx += bytes;
  if (--b.pending < 0) { std::fprintf(stderr, "shim: too many arrivals\n"); std::abort(); }
  shim_bar_step(b);
}
inline void shim_complete_tx(uint32_t bar, uint32_t bytes) {
  std::lock_guard<std::mutex> g(shim_blk->mu);
  ShimBar& b = shim_bar(bar);
  b.tx -= bytes;
  shim_bar_step(b);
}
inline void mbar_wait(uint32_t bar, uint32_t parity) {
  const auto t0 = std::chrono::steady_clock::now();
  for (;;) {
    {
      std::lock_guard<std::mutex> g(shim_blk->mu);
      if ((shim_bar(bar).phase & 1) != (parity & 1)) return;
    }
    if (std::chrono::steady_clock::now() - t0 > std::chrono::seconds(30)) {
      std::fprintf(stderr, "shim: hang: thread %u of block %u waits on the "
                   "mbarrier at %u for parity %u\n", threadIdx.x, blockIdx.x,
                   bar, parity);
      std::abort();
    }
    std::this_thread::yield();
  }
}

// the swizzle on shared-memory address bits: bits [4, 4 + b) ^= bits [7, 7 + b)
inline uint32_t shim_swizzle(uint32_t off, int span) {
  const uint32_t b = span == 128 ? 7 : span == 64 ? 3 : span == 32 ? 1 : 0;
  return off ^ (((off >> 7) & b) << 4);
}

inline void tma_load(uint32_t dst, const CUtensorMap* m, uint32_t bar, int c0,
                     int c1, int c2, int c3) {
  if (m->swz ? dst % (8 * m->swz) : dst % 128) {
    std::fprintf(stderr, "shim: TMA destination %u misaligned\n", dst);
    std::abort();
  }
  const int64_t c[4] = {c0, c1, c2, c3};
  const uint32_t* bx = m->box;
  uint32_t bytes = 0;
  for (uint32_t i3 = 0; i3 < bx[3]; ++i3)
    for (uint32_t i2 = 0; i2 < bx[2]; ++i2)
      for (uint32_t i1 = 0; i1 < bx[1]; ++i1)
        for (uint32_t i0 = 0; i0 < bx[0]; ++i0) {
          const int64_t at[4] = {c[0] + i0, c[1] + i1, c[2] + i2, c[3] + i3};
          bool in = true;
          int64_t off = 0;
          for (int d = 0; d < 4; ++d) {
            in = in && at[d] >= 0 && at[d] < int64_t(m->dims[d]);
            off += at[d] * int64_t(m->strides[d]);
          }
          uint16_t v = 0;
          if (in) std::memcpy(&v, m->base + off, 2);
          const uint32_t lin = ((i3 * bx[2] + i2) * bx[1] + i1) * bx[0] + i0;
          std::memcpy(shim_blk->smem + shim_swizzle(dst + 2 * lin, m->swz), &v, 2);
          bytes += 2;
        }
  shim_complete_tx(bar, bytes);
}

// x to TF32: to nearest, ties away from zero (on the magnitude), the 13
// bits below it zero; NaN and infinity keep their class
inline uint32_t tf32_rna(float x) {
  const uint32_t u = __float_as_uint(x);
  if ((u & 0x7f800000u) == 0x7f800000u)
    return (u & 0x007fffffu) ? 0x7fffe000u : u;
  return (u + 0x1000u) & 0xffffe000u;
}

// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, d += a b: lane (g, q)
// = (lane / 4, lane % 4) holds a (g, q) (g + 8, q) (g, q + 4) (g + 8, q + 4),
// b (k q, n g) (k q + 4, n g) and d (g, 2q) (g, 2q + 1) (g + 8, 2q)
// (g + 8, 2q + 1); every lane of the warp must call it
inline void mma_tf32(float* d, const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  const unsigned t = threadIdx.x, w = t / 32, lane = t % 32;
  const unsigned g = lane / 4, q = lane % 4;
  float* A = &shim_blk->mma_a[w * 128];
  float* B = &shim_blk->mma_b[w * 64];
  auto tf = [](uint32_t v) { return __uint_as_float(v & 0xffffe000u); };
  A[g * 8 + q] = tf(a[0]);
  A[(g + 8) * 8 + q] = tf(a[1]);
  A[g * 8 + q + 4] = tf(a[2]);
  A[(g + 8) * 8 + q + 4] = tf(a[3]);
  B[q * 8 + g] = tf(b[0]);
  B[(q + 4) * 8 + g] = tf(b[1]);
  __syncwarp();
  for (int e = 0; e < 4; ++e) {
    const unsigned row = g + 8 * (e >> 1), col = 2 * q + (e & 1);
    double s = d[e];
    for (int k = 0; k < 8; ++k) s += double(A[row * 8 + k]) * double(B[k * 8 + col]);
    d[e] = float(s);
  }
  __syncwarp();
}

// cp.async: the thread's copies, in groups; the open group is the one not
// committed yet
struct ShimCopy { uint8_t* dst; const uint8_t* src; int bytes, size; };
inline thread_local std::vector<std::vector<ShimCopy>> shim_cp_groups;
inline thread_local std::vector<ShimCopy> shim_cp_open;
inline void shim_cp(void* dst, const void* src, int bytes, int size) {
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  if (d % size || (bytes && reinterpret_cast<uintptr_t>(src) % size) ||
      static_cast<uint8_t*>(dst) < shim_blk->smem) {
    std::fprintf(stderr, "shim: cp.async of %d bytes misaligned or not to "
                 "shared memory\n", size);
    std::abort();
  }
  std::memset(dst, 0xff, size_t(size));   // NaN until the copy lands
  shim_cp_open.push_back({static_cast<uint8_t*>(dst),
                          static_cast<const uint8_t*>(src), bytes, size});
}
inline void cp_async4(void* dst, const void* src, int bytes) { shim_cp(dst, src, bytes, 4); }
inline void cp_async16(void* dst, const void* src, int bytes) { shim_cp(dst, src, bytes, 16); }
inline void cp_async_commit() {
  shim_cp_groups.push_back(std::move(shim_cp_open));
  shim_cp_open.clear();
}
template <int N> inline void cp_async_wait() {
  while (shim_cp_groups.size() > size_t(N)) {
    for (const ShimCopy& c : shim_cp_groups.front()) {
      for (int i = 0; i < c.size; ++i)
        if (c.dst[i] != 0xff) {
          std::fprintf(stderr, "shim: shared memory written while a cp.async "
                       "into it was in flight\n");
          std::abort();
        }
      std::memset(c.dst, 0, size_t(c.size));
      if (c.bytes) std::memcpy(c.dst, c.src, size_t(c.bytes));
    }
    shim_cp_groups.erase(shim_cp_groups.begin());
  }
}

template <int R> inline void regs_inc() {}
template <int R> inline void regs_dec() {}

// wgmma: results pending until wgmma_wait, the registers NaN meanwhile
inline thread_local std::vector<std::pair<float*, float>> shim_pending;
inline float shim_acc_in(float* r) {       // the latest value of register r
  for (auto it = shim_pending.rbegin(); it != shim_pending.rend(); ++it)
    if (it->first == r) return it->second;
  return *r;
}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
inline void wgmma_wait() {
  for (auto& pr : shim_pending) *pr.first = pr.second;
  shim_pending.clear();
}
template <int N> inline void reg_fence(float (&)[N]) {}

struct ShimDesc {
  uint32_t start, lbo, sbo;
  int span;
  explicit ShimDesc(uint64_t d)
      : start(uint32_t(d & 0x3FFF) << 4),
        lbo(uint32_t((d >> 16) & 0x3FFF) << 4),
        sbo(uint32_t((d >> 32) & 0x3FFF) << 4) {
    const int code = int(d >> 62);
    span = code == 1 ? 128 : code == 2 ? 64 : code == 3 ? 32 : 0;
    if (!span) { std::fprintf(stderr, "shim: descriptor without swizzle\n"); std::abort(); }
  }
  float at(uint32_t off) const {
    uint16_t v;
    std::memcpy(&v, shim_blk->smem + shim_swizzle(off, span), 2);
    return __uint_as_float(uint32_t(v) << 16);
  }
  // K-major: element (row, k), k in [0, 16)
  float kmajor(int row, int k) const {
    return at(start + (row / 8) * sbo + (row % 8) * span + 2 * k);
  }
  // MN-major: element (k, n), k in [0, 16)
  float mnmajor(int k, int n) const {
    const int w = span / 2;
    return at(start + (n / w) * lbo + (k / 8) * sbo + (k % 8) * span + 2 * (n % w));
  }
};

// row and column of accumulator element i of this thread (m64nN fragment)
inline void shim_rc(int i, int& row, int& col) {
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int j = i / 4, e = i % 4;
  row = 16 * w + lane / 4 + 8 * (e >> 1);
  col = 8 * j + 2 * (lane % 4) + (e & 1);
}

template <int N>
inline void shim_wgmma(float* d, const float* A /* 64 x 16 or null */,
                       uint64_t da, uint64_t db, bool b_mn_major,
                       bool accumulate) {
  ShimDesc a(A ? 0x4000000000000000ull : da), b(db);
  for (int i = 0; i < N / 2; ++i) {
    int row, col;
    shim_rc(i, row, col);
    double s = accumulate ? shim_acc_in(&d[i]) : 0.0;
    for (int k = 0; k < 16; ++k) {
      const float av = A ? A[row * 16 + k] : a.kmajor(row, k);
      const float bv = b_mn_major ? b.mnmajor(k, col) : b.kmajor(col, k);
      s += double(av) * double(bv);
    }
    shim_pending.emplace_back(&d[i], float(s));
  }
  for (int i = 0; i < N / 2; ++i) d[i] = NAN;
}

inline void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                          int accumulate) {
  shim_wgmma<128>(d, nullptr, da, db, false, accumulate != 0);
}

template <int N, bool kBMnMajor = true>
inline void shim_wgmma_rs(float* d, const uint32_t (&a)[4], uint64_t db) {
  const int t = threadIdx.x % 128, w = t / 32, lane = t % 32;
  const int g = lane / 4, q = lane % 4;
  float* A = &shim_blk->wg_a[(threadIdx.x / 128) * 64 * 16];
  const int rows[4] = {g, g + 8, g, g + 8}, cols[4] = {2 * q, 2 * q, 2 * q + 8, 2 * q + 8};
  for (int r = 0; r < 4; ++r) {
    A[(16 * w + rows[r]) * 16 + cols[r]] = __uint_as_float(a[r] << 16);
    A[(16 * w + rows[r]) * 16 + cols[r] + 1] = __uint_as_float(a[r] & 0xffff0000u);
  }
  shim_blk->wg[threadIdx.x / 128]->arrive_and_wait();
  shim_wgmma<N>(d, A, 0, db, kBMnMajor, true);
  shim_blk->wg[threadIdx.x / 128]->arrive_and_wait();
}
inline void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) { shim_wgmma_rs<16>(d, a, db); }
inline void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) { shim_wgmma_rs<32>(d, a, db); }
inline void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) { shim_wgmma_rs<64>(d, a, db); }
inline void wgmma_rs_n8_kmajor(float (&d)[4], const uint32_t (&a)[4], uint64_t db) { shim_wgmma_rs<8, false>(d, a, db); }
inline void fence_proxy_async() {}

// -- launch --------------------------------------------------------------------
// Runs the blocks one after another (x fastest, then y, then z), each with
// one thread per CUDA thread and its dynamic shared memory filled with 0xff
// (NaN as bf16 and f32).
inline void shim_launch(const std::function<void()>& k, dim3 grid, dim3 block,
                        int smem, cudaStream_t = nullptr) {
  const unsigned n = block.x;
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
  for (unsigned bx = 0; bx < grid.x; ++bx) {
    ShimBlock blk;
    std::vector<uint8_t> buf(size_t(smem) + 2048);
    uint8_t* base = buf.data() + (1024 - reinterpret_cast<uintptr_t>(buf.data()) % 1024) % 1024;
    std::memset(base, 0xff, size_t(smem));
    blk.smem = base;
    blk.block = std::make_unique<std::barrier<>>(n);
    for (unsigned w = 0; w < (n + 31) / 32; ++w)
      blk.warp.push_back(std::make_unique<std::barrier<>>(std::min(32u, n - 32 * w)));
    for (unsigned w = 0; w < (n + 127) / 128; ++w)
      blk.wg.push_back(std::make_unique<std::barrier<>>(std::min(128u, n - 128 * w)));
    blk.shfl.assign(n, 0.0f);
    blk.wg_a.assign(((n + 127) / 128) * 64 * 16, 0.0f);
    blk.mma_a.assign(((n + 31) / 32) * 128, NAN);
    blk.mma_b.assign(((n + 31) / 32) * 64, NAN);
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < n; ++t)
      ts.emplace_back([&, t, bx, by, bz] {
        threadIdx.x = t;
        blockIdx.x = bx;
        blockIdx.y = by;
        blockIdx.z = bz;
        blockDim = block;
        gridDim = grid;
        shim_blk = &blk;
        k();
        if (!shim_pending.empty()) {
          std::fprintf(stderr, "shim: wgmma results never waited for\n");
          std::abort();
        }
        if (!shim_cp_groups.empty() || !shim_cp_open.empty()) {
          std::fprintf(stderr, "shim: cp.async copies never waited for\n");
          std::abort();
        }
      });
    for (auto& t : ts) t.join();
  }
}
