// Runs a CUDA source of the port on the CPU for rehearsal without a card.
// The blocks of a launch run one after another. Within a block each CUDA
// thread is a fiber (ucontext) on the OS thread that launches, so a launch
// takes one core and starts no OS thread. A fiber runs until it waits on
// another thread: __syncthreads, __syncwarp and the shuffles, votes and
// mma.sync built on it, the warpgroup barrier of wgmma's RS form, an mbarrier
// wait. A barrier is a count of arrivals and a phase. Then the next fiber
// that can run takes over, round robin: in ascending threadIdx order in one
// launch of a launch site and in descending order in the next (a counter per
// launch site; it is not a knob). So a read of shared memory that another
// warp writes with no barrier between them reads a stale value, or the 0xff
// fill, in one of the two orders, and every check that launches a kernel
// twice sees both. When no fiber of a block can run, the shim aborts at once,
// naming each barrier waited on, its phase and its waiting threads: a wrong
// phase or a barrier reached by half a block shows as a message within
// microseconds, not as a hang. Each fiber has a 64 KiB stack above a guard
// page: the largest kernel frame at build.py's -O1 is under 1 KiB (K5's wgmma
// kernel at head dim 128, its register tiles included), and the rest leaves
// room for the shim's calls and fprintf on an abort; an overflow faults.
// It stands in for what the kernels use: 3-D grids of 1-D blocks (blockIdx,
// blockDim, gridDim), __syncthreads, warp shuffles,
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
// What it cannot show: the PTX's syntax, register pressure, whether the
// hardware reads the descriptors as this file does, and true concurrency
// between the threads of a block (a fiber runs until it waits). The card
// tests under the `cuda` marker show those.
#pragma once
#include <sys/mman.h>
#include <ucontext.h>
#include <algorithm>
#include <bit>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <type_traits>
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

// -- memory: loads past L1, fences, atomics ----------------------------------
// One OS thread runs every CUDA thread of a launch, so plain loads and stores
// are already ordered and atomic.
template <typename T> inline T __ldcg(const T* p) { return *p; }
// checksum.cu's streaming loads (ld.global.nc.L1::no_allocate)
inline uint4 load_stream16(const void* p) {
  if (reinterpret_cast<uintptr_t>(p) % 16) {
    std::fprintf(stderr, "shim: 16-byte load from a misaligned address\n");
    std::abort();
  }
  uint4 v; std::memcpy(&v, p, 16); return v;
}
inline uint32_t ticket_acq_rel(uint32_t* p) { return (*p)++; }   // atom.acq_rel.gpu.add 1
inline void __threadfence() {}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p = old + v;
  return old;
}
inline unsigned atomicCAS(unsigned* p, unsigned cmp, unsigned v) {
  const unsigned old = *p;
  if (old == cmp) *p = v;
  return old;
}
inline int min(int a, int b) { return a < b ? a : b; }
inline int64_t min(int64_t a, int64_t b) { return a < b ? a : b; }

// -- fibers: one per CUDA thread, all on the OS thread that launches ----------
struct ShimCopy { uint8_t* dst; const uint8_t* src; int bytes, size; };
struct ShimFiber {
  ucontext_t ctx;
  unsigned tid = 0;
  bool done = false;
  // what it waits for: it can run once (*phase ^ from) & mask != 0
  const uint32_t* phase = nullptr;
  uint32_t from = 0, mask = 0;
  const char* what = nullptr;       // the barrier, for the hang message
  uint32_t which = 0;
  std::vector<std::pair<float*, float>> pending;   // wgmma results in flight
  std::vector<std::vector<ShimCopy>> cp_groups;    // committed cp.async groups
  std::vector<ShimCopy> cp_open;                   // the group not committed
};
struct ShimRun {
  void (*kernel)(void*);
  void* arg;
  std::vector<ShimFiber> fibers;    // in resume order
  unsigned live = 0;                // fibers of the block not returned yet
  ucontext_t host;
};
inline thread_local ShimRun* shim_run = nullptr;
inline thread_local ShimFiber* shim_self = nullptr;

[[noreturn]] void shim_hang();
// Switches to the next fiber in resume order that can run, this one last; to
// the launch once every fiber of the block has returned; aborts if none can
// run.
inline void shim_yield() {
  ShimRun& r = *shim_run;
  ShimFiber* const self = shim_self;
  const size_t n = r.fibers.size(), k = size_t(self - r.fibers.data());
  for (size_t i = 1; i <= n; ++i) {
    ShimFiber* f = &r.fibers[(k + i) % n];
    if (f->done || (f->phase && !((*f->phase ^ f->from) & f->mask))) continue;
    if (f != self) {
      shim_self = f;
      threadIdx.x = f->tid;
      swapcontext(&self->ctx, &f->ctx);
    }
    self->phase = nullptr;
    return;
  }
  if (r.live) shim_hang();
  swapcontext(&self->ctx, &r.host);
  self->phase = nullptr;
}
inline void shim_wait(const uint32_t* phase, uint32_t from, uint32_t mask,
                      const char* what, uint32_t which) {
  ShimFiber& f = *shim_self;
  f.phase = phase;
  f.from = from;
  f.mask = mask;
  f.what = what;
  f.which = which;
  shim_yield();
}

// -- blocks, warps, barriers -------------------------------------------------
// A barrier is a count of arrivals and a phase; the last arrival starts the
// next phase, and every arrival waits for it.
struct ShimSync { uint32_t count = 0, arrived = 0, phase = 0; };
struct ShimBar { int count = 0, pending = 0; int64_t tx = 0; uint32_t phase = 0; };
struct ShimBlock {
  uint8_t* smem = nullptr;
  ShimSync block;
  std::vector<ShimSync> warp, wg;
  std::vector<float> shfl;                 // one word per thread
  std::vector<float> wg_a;                 // per warpgroup: A, 64 x 16
  std::vector<float> mma_a, mma_b;         // per warp: A 16 x 8, B 8 x 8
  std::map<uint32_t, ShimBar> bars;
};
inline thread_local ShimBlock* shim_blk = nullptr;
inline uint8_t* shim_smem() { return shim_blk->smem; }
inline void shim_sync(ShimSync& s, const char* what, uint32_t which) {
  const uint32_t from = s.phase;
  if (++s.arrived == s.count) {
    s.arrived = 0;
    ++s.phase;
  }
  shim_wait(&s.phase, from, ~0u, what, which);
}
inline void __syncthreads() { shim_sync(shim_blk->block, "__syncthreads", 0); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  const unsigned w = threadIdx.x / 32;
  shim_sync(shim_blk->warp[w], "the barrier of warp %u (__syncwarp, shuffles, "
            "votes, mma.sync)", w);
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
  ShimBar& b = shim_blk->bars[bar];
  b.count = b.pending = static_cast<int>(count);
  b.tx = 0;
  b.phase = 0;
}
inline void mbar_fence_init() {}
inline void shim_bar_step(ShimBar& b) {
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
  ShimBar& b = shim_bar(bar);
  if (--b.pending < 0) { std::fprintf(stderr, "shim: too many arrivals\n"); std::abort(); }
  shim_bar_step(b);
}
inline void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  ShimBar& b = shim_bar(bar);
  b.tx += bytes;
  if (--b.pending < 0) { std::fprintf(stderr, "shim: too many arrivals\n"); std::abort(); }
  shim_bar_step(b);
}
inline void shim_complete_tx(uint32_t bar, uint32_t bytes) {
  ShimBar& b = shim_bar(bar);
  b.tx -= bytes;
  shim_bar_step(b);
}
inline void mbar_wait(uint32_t bar, uint32_t parity) {
  const ShimBar& b = shim_bar(bar);
  if ((b.phase ^ parity) & 1) return;
  shim_wait(&b.phase, parity, 1, "the mbarrier at %u", bar);
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

// cp.async: the thread's copies, in groups (ShimFiber::cp_groups); the open
// group is the one not committed yet
inline void shim_cp(void* dst, const void* src, int bytes, int size) {
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  if (d % size || (bytes && reinterpret_cast<uintptr_t>(src) % size) ||
      static_cast<uint8_t*>(dst) < shim_blk->smem) {
    std::fprintf(stderr, "shim: cp.async of %d bytes misaligned or not to "
                 "shared memory\n", size);
    std::abort();
  }
  std::memset(dst, 0xff, size_t(size));   // NaN until the copy lands
  shim_self->cp_open.push_back({static_cast<uint8_t*>(dst),
                          static_cast<const uint8_t*>(src), bytes, size});
}
inline void cp_async4(void* dst, const void* src, int bytes) { shim_cp(dst, src, bytes, 4); }
inline void cp_async16(void* dst, const void* src, int bytes) { shim_cp(dst, src, bytes, 16); }
inline void cp_async_commit() {
  ShimFiber& f = *shim_self;
  f.cp_groups.push_back(std::move(f.cp_open));
  f.cp_open.clear();
}
template <int N> inline void cp_async_wait() {
  auto& groups = shim_self->cp_groups;
  while (groups.size() > size_t(N)) {
    for (const ShimCopy& c : groups.front()) {
      for (int i = 0; i < c.size; ++i)
        if (c.dst[i] != 0xff) {
          std::fprintf(stderr, "shim: shared memory written while a cp.async "
                       "into it was in flight\n");
          std::abort();
        }
      std::memset(c.dst, 0, size_t(c.size));
      if (c.bytes) std::memcpy(c.dst, c.src, size_t(c.bytes));
    }
    groups.erase(groups.begin());
  }
}

template <int R> inline void regs_inc() {}
template <int R> inline void regs_dec() {}

// wgmma: results pending (ShimFiber::pending) until wgmma_wait, the registers
// NaN meanwhile
inline float shim_acc_in(float* r) {       // the latest value of register r
  const auto& pending = shim_self->pending;
  for (auto it = pending.rbegin(); it != pending.rend(); ++it)
    if (it->first == r) return it->second;
  return *r;
}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
inline void wgmma_wait() {
  for (auto& pr : shim_self->pending) *pr.first = pr.second;
  shim_self->pending.clear();
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
    shim_self->pending.emplace_back(&d[i], float(s));
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
  const unsigned grp = threadIdx.x / 128;
  const char* what = "the barrier of warpgroup %u (wgmma with A in registers)";
  shim_sync(shim_blk->wg[grp], what, grp);
  shim_wgmma<N>(d, A, 0, db, kBMnMajor, true);
  shim_sync(shim_blk->wg[grp], what, grp);
}
inline void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) { shim_wgmma_rs<16>(d, a, db); }
inline void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) { shim_wgmma_rs<32>(d, a, db); }
inline void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) { shim_wgmma_rs<64>(d, a, db); }
inline void wgmma_rs_n8_kmajor(float (&d)[4], const uint32_t (&a)[4], uint64_t db) { shim_wgmma_rs<8, false>(d, a, db); }
inline void fence_proxy_async() {}

// -- launch --------------------------------------------------------------------
// Each fiber's stack: kShimStack bytes above a guard page that faults on an
// overflow.
constexpr size_t kShimStack = 64 << 10, kShimSlot = kShimStack + 4096;

// A fiber runs the kernel once for each block of the launch: it parks in
// shim_yield after each, and the launch resumes it for the next block.
inline void shim_fiber_main() {
  for (;;) {
    shim_run->kernel(shim_run->arg);
    ShimFiber& f = *shim_self;
    if (!f.pending.empty()) {
      std::fprintf(stderr, "shim: wgmma results never waited for\n");
      std::abort();
    }
    if (!f.cp_groups.empty() || !f.cp_open.empty()) {
      std::fprintf(stderr, "shim: cp.async copies never waited for\n");
      std::abort();
    }
    f.done = true;
    --shim_run->live;
    shim_yield();
  }
}

// No fiber of the block can run: name each barrier waited on, its phase and
// its waiting threads, and the threads that have returned.
inline void shim_ranges(const std::vector<unsigned>& ts) {
  for (size_t i = 0; i < ts.size();) {
    size_t j = i;
    while (j + 1 < ts.size() && ts[j + 1] == ts[j] + 1) ++j;
    std::fprintf(stderr, i ? ", %u" : " %u", ts[i]);
    if (j > i) std::fprintf(stderr, "-%u", ts[j]);
    i = j + 1;
  }
}
[[noreturn]] inline void shim_hang() {
  const ShimRun& r = *shim_run;
  std::vector<const ShimFiber*> by_tid(r.fibers.size());
  for (const ShimFiber& f : r.fibers) by_tid[f.tid] = &f;
  std::fprintf(stderr, "shim: hang: no thread of block (%u, %u, %u) can run\n",
               blockIdx.x, blockIdx.y, blockIdx.z);
  std::vector<const uint32_t*> seen;
  for (const ShimFiber* f : by_tid) {
    if (f->done || std::find(seen.begin(), seen.end(), f->phase) != seen.end())
      continue;
    seen.push_back(f->phase);
    std::vector<unsigned> ts;
    for (const ShimFiber* g : by_tid)
      if (!g->done && g->phase == f->phase) ts.push_back(g->tid);
    std::fprintf(stderr, "  ");
    std::fprintf(stderr, f->what, f->which);
    if (f->mask == 1)
      std::fprintf(stderr, ", phase %u, parity %u awaited by thread%s",
                   *f->phase, f->from & 1, ts.size() > 1 ? "s" : "");
    else
      std::fprintf(stderr, ", phase %u, awaited by thread%s", *f->phase,
                   ts.size() > 1 ? "s" : "");
    shim_ranges(ts);
    std::fprintf(stderr, "\n");
  }
  std::vector<unsigned> ts;
  for (const ShimFiber* f : by_tid)
    if (f->done) ts.push_back(f->tid);
  if (!ts.empty()) {
    std::fprintf(stderr, "  returned: thread%s", ts.size() > 1 ? "s" : "");
    shim_ranges(ts);
    std::fprintf(stderr, "\n");
  }
  std::abort();
}

// Runs the blocks one after another (x fastest, then y, then z), each with
// its dynamic shared memory filled with 0xff (NaN as bf16 and f32) and one
// fiber per CUDA thread, resumed in ascending threadIdx order in one launch
// of a launch site and descending in the next.
inline void shim_launch_fibers(void (*kernel)(void*), void* arg, dim3 grid,
                               dim3 block, int smem, bool descending) {
  const unsigned n = block.x;
  if (n == 0) return;
  ShimRun run;
  run.kernel = kernel;
  run.arg = arg;
  run.fibers.resize(n);
  void* m = mmap(nullptr, n * kShimSlot, PROT_READ | PROT_WRITE,
                 MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
  if (m == MAP_FAILED) {
    std::fprintf(stderr, "shim: no memory for %u fiber stacks\n", n);
    std::abort();
  }
  uint8_t* const stacks = static_cast<uint8_t*>(m);
  for (unsigned i = 0; i < n; ++i) {
    ShimFiber& f = run.fibers[i];
    f.tid = descending ? n - 1 - i : i;
    getcontext(&f.ctx);
    mprotect(stacks + i * kShimSlot, kShimSlot - kShimStack, PROT_NONE);
    f.ctx.uc_stack.ss_sp = stacks + i * kShimSlot + (kShimSlot - kShimStack);
    f.ctx.uc_stack.ss_size = kShimStack;
    f.ctx.uc_link = nullptr;
    makecontext(&f.ctx, shim_fiber_main, 0);
  }
  shim_run = &run;
  blockDim = block;
  gridDim = grid;
  for (unsigned bz = 0; bz < grid.z; ++bz)
  for (unsigned by = 0; by < grid.y; ++by)
  for (unsigned bx = 0; bx < grid.x; ++bx) {
    ShimBlock blk;
    std::vector<uint8_t> buf(size_t(smem) + 2048);
    uint8_t* base = buf.data() + (1024 - reinterpret_cast<uintptr_t>(buf.data()) % 1024) % 1024;
    std::memset(base, 0xff, size_t(smem));
    blk.smem = base;
    blk.block.count = n;
    for (unsigned w = 0; w < (n + 31) / 32; ++w)
      blk.warp.push_back({std::min(32u, n - 32 * w), 0, 0});
    for (unsigned w = 0; w < (n + 127) / 128; ++w)
      blk.wg.push_back({std::min(128u, n - 128 * w), 0, 0});
    blk.shfl.assign(n, 0.0f);
    blk.wg_a.assign(((n + 127) / 128) * 64 * 16, 0.0f);
    blk.mma_a.assign(((n + 31) / 32) * 128, NAN);
    blk.mma_b.assign(((n + 31) / 32) * 64, NAN);
    shim_blk = &blk;
    blockIdx = {bx, by, bz};
    for (ShimFiber& f : run.fibers) f.done = false;
    run.live = n;
    shim_self = &run.fibers[0];
    threadIdx.x = run.fibers[0].tid;
    swapcontext(&run.host, &run.fibers[0].ctx);
  }
  shim_run = nullptr;
  shim_self = nullptr;
  munmap(m, n * kShimSlot);
}

// One launch: <<<grid, block, smem, stream>>> as build.py rewrites it. Each
// launch site (each lambda type) counts its own launches for the resume
// order, so every check that launches a kernel twice or more sees both
// orders. That is not a knob.
template <typename F>
inline void shim_launch(F&& k, dim3 grid, dim3 block, int smem,
                        cudaStream_t = nullptr) {
  using K = std::remove_reference_t<F>;
  static unsigned launches = 0;
  shim_launch_fibers([](void* p) { (*static_cast<K*>(p))(); }, &k, grid,
                     block, smem, launches++ & 1);
}
