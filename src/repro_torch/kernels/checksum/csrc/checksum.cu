// Fused QA + transfer checksum for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (src/repro_torch/kernels/checksum/checksum.py).
//
// Replaces the Pallas kernels of src/repro/kernels/checksum/checksum.py:
//   repro_qa_checksum     <- _qa_checksum_kernel (K1): one-shot, batched rows
//   repro_qa_chunk        <- _qa_chunk_kernel    (K2): one chunk, seeded from
//                                                      a carry at global offsets
//   repro_device_checksum <- _checksum_kernel    (K3): transfer checksum only
//
// What each computes, over a row's bytes:
//   s1 = sum_i w_i, s2 = sum_i (i mod 65521) * w_i   (uint32, wraps mod 2^32)
//     over the little-endian uint32 word view, the last word zero-padded;
//   min, max, sum and count of the finite values, each value cast to f32.
//
// Bit-exactness with ref.py is the contract, so:
//   * integers are uint32 (Pallas int32 wraps; signed overflow is UB here).
//     Their sums are associative mod 2^32, so any order and atomics are fine;
//   * each block of blk_v values is summed by the exact halving tree of
//     ref.tree_sum_f32 (element j pairs with j + n/2 at each level), which is
//     the classic shared-memory reduction; the per-block sums are then added
//     SEQUENTIALLY in block order by one thread (qa_fold_kernel), starting
//     from 0.0f (K1) or the carry (K2) -- the reference's cross-block order;
//   * min/max/count are order-free; min/max compare by value;
//   * built without --use_fast_math and without -ftz: subnormals are kept.
//
// Bound on an H100 (3.35 TB/s HBM3, 700 W part): memory. Each input byte is
// read once, so a 256x256x176 f32 volume (46 MB) needs at least 13.8 us. The
// design is the simple one: one 256-thread block per 1024-value block step,
// coalesced loads, and the value tree in shared memory. Two costs stand
// above the bound and are left for a later change: each f32 byte is loaded
// twice (word view and value view; the second load hits L1/L2), and the
// sequential fold is a chain of nsteps dependent f32 adds (11,264 for the
// volume above), which the bit-exact contract does not allow to reorder.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr uint32_t kMPos = 65521u;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlkV = 4096;

// value dtype codes, mirrored by _DTYPE_CODES in checksum.py
enum DType : int { F32 = 0, F16 = 1, BF16 = 2, I8 = 3, U8 = 4, I16 = 5,
                   U16 = 6, I32 = 7, U32 = 8 };

// Little-endian word at byte offset `off` of `base`; bytes at or beyond
// `nbytes` read as zero (the reference's zero padding of the last word).
__device__ __forceinline__ uint32_t load_word(const uint8_t* base, int64_t off,
                                              int64_t nbytes) {
  const uint8_t* p = base + off;
  if (off + 4 <= nbytes && (reinterpret_cast<uintptr_t>(p) & 3u) == 0)
    return *reinterpret_cast<const uint32_t*>(p);
  uint32_t w = 0;
  for (int b = 0; b < 4; ++b)
    if (off + b < nbytes) w |= static_cast<uint32_t>(p[b]) << (8 * b);
  return w;
}

// Element k of `base` cast to f32 with round-to-nearest (numpy's astype).
__device__ __forceinline__ float load_value(const uint8_t* base, int64_t k,
                                            int dtype) {
  switch (dtype) {
    case F32: return reinterpret_cast<const float*>(base)[k];
    case F16: return __half2float(reinterpret_cast<const __half*>(base)[k]);
    case BF16:
      return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(base)[k]);
    case I8: return static_cast<float>(reinterpret_cast<const int8_t*>(base)[k]);
    case U8: return static_cast<float>(base[k]);
    case I16: return static_cast<float>(reinterpret_cast<const int16_t*>(base)[k]);
    case U16: return static_cast<float>(reinterpret_cast<const uint16_t*>(base)[k]);
    case I32: return __int2float_rn(reinterpret_cast<const int32_t*>(base)[k]);
    case U32: return __uint2float_rn(reinterpret_cast<const uint32_t*>(base)[k]);
    default: return 0.0f;
  }
}

__device__ __forceinline__ uint32_t word_pos(int64_t gw) {
  // (i mod 65521) from a 64-bit index; the 32-bit modulo is the cheap path
  return gw < 4294967296LL ? static_cast<uint32_t>(gw) % kMPos
                           : static_cast<uint32_t>(gw % kMPos);
}

struct AddU32 {
  __device__ uint32_t operator()(uint32_t a, uint32_t b) const { return a + b; }
};
struct AddI32 {
  __device__ int32_t operator()(int32_t a, int32_t b) const { return a + b; }
};
struct MinF {
  __device__ float operator()(float a, float b) const { return b < a ? b : a; }
};
struct MaxF {
  __device__ float operator()(float a, float b) const { return b > a ? b : a; }
};

// Block-wide reduction with an associative, commutative op; the result is
// valid in thread 0 only. `sh` holds kWarps values.
template <typename T, typename Op>
__device__ __forceinline__ T block_reduce(T v, Op op, T* sh) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_down_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();  // `sh` may still be read by the previous reduction
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kWarps; ++w) v = op(v, sh[w]);
  return v;
}

struct Partials {
  float* sum;
  float* min;
  float* max;
  int32_t* cnt;
  uint32_t* s1;
  uint32_t* s2;
};

// One CUDA block per (block step i, row g): the reference's per-grid-step
// body, writing its partials instead of adding them into a carry.
__global__ void __launch_bounds__(kThreads)
qa_blocks_kernel(const uint8_t* __restrict__ data, int64_t row_stride,
                 int64_t row_bytes, int dtype, int itemsize, int blk_v,
                 int blk_w, int64_t nsteps, int64_t w0, int64_t v0,
                 int64_t nw, int64_t nv, Partials part) {
  __shared__ float tree[kMaxBlkV];
  __shared__ uint32_t red_u[kWarps];
  __shared__ int32_t red_i[kWarps];
  __shared__ float red_f[kWarps];
  const int64_t i = blockIdx.x;
  const int64_t g = blockIdx.y;
  const uint8_t* row = data + g * row_stride;
  const int t = threadIdx.x;

  uint32_t s1 = 0, s2 = 0;
  for (int j = t; j < blk_w; j += kThreads) {
    const int64_t lw = i * blk_w + j;   // word index within these bytes
    const int64_t gw = w0 + lw;         // global word index
    if (gw < nw) {
      const uint32_t w = load_word(row, lw * 4, row_bytes);
      s1 += w;
      s2 += w * word_pos(gw);
    }
  }

  int32_t cnt = 0;
  float mn = INFINITY, mx = -INFINITY;
  for (int k = t; k < blk_v; k += kThreads) {
    const int64_t lv = i * blk_v + k;
    float v = 0.0f;
    if (v0 + lv < nv) {
      // a value past the row's bytes reads as zero, like the words
      v = (lv + 1) * itemsize <= row_bytes ? load_value(row, lv, dtype) : 0.0f;
      if (isfinite(v)) {
        ++cnt;
        mn = v < mn ? v : mn;
        mx = v > mx ? v : mx;
      } else {
        v = 0.0f;
      }
    }
    tree[k] = v;
  }
  __syncthreads();
  // ref.tree_sum_f32: v[:n] + v[n:2n], halving n each level
  for (int s = blk_v >> 1; s > 0; s >>= 1) {
    for (int k = t; k < s; k += kThreads) tree[k] += tree[k + s];
    __syncthreads();
  }

  s1 = block_reduce(s1, AddU32(), red_u);
  s2 = block_reduce(s2, AddU32(), red_u);
  cnt = block_reduce(cnt, AddI32(), red_i);
  mn = block_reduce(mn, MinF(), red_f);
  mx = block_reduce(mx, MaxF(), red_f);
  if (t == 0) {
    const int64_t p = g * nsteps + i;
    part.sum[p] = tree[0];
    part.min[p] = mn;
    part.max[p] = mx;
    part.cnt[p] = cnt;
    part.s1[p] = s1;
    part.s2[p] = s2;
  }
}

// One CUDA block per row: fold the row's partials into its carry. A null
// carry starts from the reference's init (0, 0, +inf, -inf, 0.0f, 0).
__global__ void __launch_bounds__(kThreads)
qa_fold_kernel(int64_t nsteps, Partials part, const uint32_t* carry_sums,
               const float* carry_qa, const int32_t* carry_cnt,
               uint32_t* out_sums, float* out_qa, int32_t* out_cnt) {
  __shared__ uint32_t red_u[kWarps];
  __shared__ int32_t red_i[kWarps];
  __shared__ float red_f[kWarps];
  const int64_t g = blockIdx.x;
  const int64_t base = g * nsteps;

  uint32_t s1 = 0, s2 = 0;
  int32_t cnt = 0;
  float mn = INFINITY, mx = -INFINITY;
  for (int64_t i = threadIdx.x; i < nsteps; i += kThreads) {
    s1 += part.s1[base + i];
    s2 += part.s2[base + i];
    cnt += part.cnt[base + i];
    mn = MinF()(mn, part.min[base + i]);
    mx = MaxF()(mx, part.max[base + i]);
  }
  s1 = block_reduce(s1, AddU32(), red_u);
  s2 = block_reduce(s2, AddU32(), red_u);
  cnt = block_reduce(cnt, AddI32(), red_i);
  mn = block_reduce(mn, MinF(), red_f);
  mx = block_reduce(mx, MaxF(), red_f);
  if (threadIdx.x == 0) {
    // the reference's cross-block order: one scalar add per block, in order
    float acc = carry_qa ? carry_qa[g * 3 + 2] : 0.0f;
#pragma unroll 8
    for (int64_t i = 0; i < nsteps; ++i) acc += part.sum[base + i];
    const uint32_t c1 = carry_sums ? carry_sums[g * 2] : 0u;
    const uint32_t c2 = carry_sums ? carry_sums[g * 2 + 1] : 0u;
    const float cmn = carry_qa ? carry_qa[g * 3] : INFINITY;
    const float cmx = carry_qa ? carry_qa[g * 3 + 1] : -INFINITY;
    const int32_t cc = carry_cnt ? carry_cnt[g] : 0;
    out_sums[g * 2] = c1 + s1;
    out_sums[g * 2 + 1] = c2 + s2;
    out_qa[g * 3] = MinF()(cmn, mn);
    out_qa[g * 3 + 1] = MaxF()(cmx, mx);
    out_qa[g * 3 + 2] = acc;
    out_cnt[g] = cc + cnt;
  }
}

// Transfer checksum: grid-stride over words, then one atomic add per block
// (s1/s2 are sums mod 2^32, so the order of the atomics does not matter).
__global__ void __launch_bounds__(kThreads)
checksum_kernel(const uint8_t* __restrict__ data, int64_t nbytes, int64_t nw,
                uint32_t* out) {
  __shared__ uint32_t red_u[kWarps];
  uint32_t s1 = 0, s2 = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       j < nw; j += stride) {
    const uint32_t w = load_word(data, j * 4, nbytes);
    s1 += w;
    s2 += w * word_pos(j);
  }
  s1 = block_reduce(s1, AddU32(), red_u);
  s2 = block_reduce(s2, AddU32(), red_u);
  if (threadIdx.x == 0) {
    atomicAdd(&out[0], s1);
    atomicAdd(&out[1], s2);
  }
}

int launch_qa(const void* data, int64_t row_stride, int64_t row_bytes,
              int dtype, int itemsize, int64_t blk_v, int64_t nsteps,
              int64_t G, int64_t w0, int64_t v0, int64_t nw, int64_t nv,
              const void* carry_sums, const void* carry_qa,
              const void* carry_cnt, void* out_sums, void* out_qa,
              void* out_cnt, void* scratch, void* stream) {
  if (blk_v < 8 || blk_v > kMaxBlkV || (blk_v & (blk_v - 1)) != 0 ||
      itemsize < 1 || itemsize > 4 || (blk_v * itemsize) % 4 != 0 ||
      nsteps < 1 || nsteps > 0x7fffffffLL || G < 1 || G > 65535 ||
      dtype < F32 || dtype > U32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blk_w = static_cast<int>(blk_v * itemsize / 4);
  const int64_t n = G * nsteps;
  uint32_t* s = static_cast<uint32_t*>(scratch);  // 6 * G * nsteps words
  Partials part{reinterpret_cast<float*>(s), reinterpret_cast<float*>(s + n),
                reinterpret_cast<float*>(s + 2 * n),
                reinterpret_cast<int32_t*>(s + 3 * n), s + 4 * n, s + 5 * n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  qa_blocks_kernel<<<dim3(static_cast<unsigned>(nsteps),
                          static_cast<unsigned>(G)), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(data), row_stride, row_bytes, dtype,
      itemsize, static_cast<int>(blk_v), blk_w, nsteps, w0, v0, nw, nv, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  qa_fold_kernel<<<static_cast<unsigned>(G), kThreads, 0, st>>>(
      nsteps, part, static_cast<const uint32_t*>(carry_sums),
      static_cast<const float*>(carry_qa),
      static_cast<const int32_t*>(carry_cnt), static_cast<uint32_t*>(out_sums),
      static_cast<float*>(out_qa), static_cast<int32_t*>(out_cnt));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K1: G rows of `row_bytes` bytes each, `row_stride` apart; nv values and nw
// words per row. Outputs uint32 (G,2), f32 (G,3), int32 (G,1).
int repro_qa_checksum(const void* data, int64_t row_stride, int64_t row_bytes,
                      int dtype, int itemsize, int64_t blk_v, int64_t nsteps,
                      int64_t G, int64_t nw, int64_t nv, void* out_sums,
                      void* out_qa, void* out_cnt, void* scratch,
                      void* stream) {
  return launch_qa(data, row_stride, row_bytes, dtype, itemsize, blk_v, nsteps,
                   G, 0, 0, nw, nv, nullptr, nullptr, nullptr, out_sums,
                   out_qa, out_cnt, scratch, stream);
}

// K2: `nbytes` bytes (a whole number of values) of one array starting at
// global word w0 / value v0, folded as `nsteps` blocks into the carry; the
// new carry goes to out_*.
int repro_qa_chunk(const void* data, int64_t nbytes, int dtype, int itemsize,
                   int64_t blk_v, int64_t nsteps, int64_t w0, int64_t v0,
                   int64_t nw, int64_t nv, const void* carry_sums,
                   const void* carry_qa, const void* carry_cnt, void* out_sums,
                   void* out_qa, void* out_cnt, void* scratch, void* stream) {
  if (carry_sums == nullptr || carry_qa == nullptr || carry_cnt == nullptr ||
      itemsize < 1 || nbytes % itemsize != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_qa(data, nbytes, nbytes, dtype, itemsize, blk_v, nsteps, 1, w0,
                   v0, nw, nv, carry_sums, carry_qa, carry_cnt, out_sums,
                   out_qa, out_cnt, scratch, stream);
}

// K3: s1/s2 over the words of `nbytes` bytes, added into out[2] (zeroed by
// the caller).
int repro_device_checksum(const void* data, int64_t nbytes, void* out,
                          void* stream) {
  if (nbytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nw = (nbytes + 3) / 4;
  int64_t blocks = (nw + kThreads * 4 - 1) / (kThreads * 4);
  if (blocks < 1) blocks = 1;
  if (blocks > 4096) blocks = 4096;
  checksum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), nbytes, nw,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
