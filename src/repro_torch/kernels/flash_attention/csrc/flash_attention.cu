// Flash attention (forward) for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (src/repro_torch/kernels/flash_attention/
// flash_attention.py).
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention/
// flash_attention.py _flash_kernel (K5). For each query row it computes
//   o = softmax(mask(q k^T * scale)) v,   scale = 1/sqrt(Dh),
// by the online softmax over key tiles, with the Pallas kernel's numbers:
//   * scores in f32 from the input dtype (q_ref[...].astype(f32)), no TF32;
//   * masks col < seq_k, causal row >= col, window row - col < window, where
//     a masked score is NEG_INF = -1e30 (finite, not -inf: a row whose tile
//     is wholly masked gets p = exp(0) = 1 there, and the first real column
//     wipes it with alpha = exp(-1e30 - m) = 0; with -inf it would be NaN);
//   * running max m, denominator l and accumulator in f32, l = l*alpha +
//     sum p, acc = acc*alpha + p v, p kept in f32 (rounded to bf16 on the
//     bf16 path, below); the output acc / max(l, 1e-30), rounded once to
//     the output dtype;
//   * GQA: query head h reads kv head h / G, K and V never repeated;
//   * accurate expf, not __expf (built without --use_fast_math).
// Rows are absolute positions q_offset + i (q_offset = 0 in the Pallas
// kernel). Any Sq and Sk: the ragged tiles are masked here, not padded.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor, 67 TFLOP/s f32 SIMT, MUFU
// 16 exp/clk/SM): causal attention over S tokens does 4*S^2/2*Dh*H flops and
// H*S^2/2 exponentials. At S = 180,224, H = 4, Dh = 32 (the reduced
// paper-unest) that is 8.3 TFLOP (8.4 ms on the tensor cores) and 6.5e10
// exponentials (~16 ms at the MUFU rate): the exponentials bound it at
// Dh = 32. At H = 8, Dh = 64 (the published width) 33 TFLOP (34 ms) against
// 1.3e11 exponentials (~32 ms): about even.
//
// Two kernels share the grid, the masks and the online softmax: one
// 128-thread block per (b, h, 64-row query tile), walking the 64-column key
// tiles in order. Causal tiles wholly above the diagonal are skipped: their
// contribution is exactly zero once a real column has been seen, and column
// 0 (tile 0) is always seen first. Query tiles are issued longest first, so
// the short causal tiles fill the tail. No TMA, no wgmma: simple first.
//
//  * flash_mma_kernel, bf16: the two products on the tensor cores with
//    mma.sync m16n8k16 (bf16 in, f32 accumulate). Each warp owns 16 query
//    rows; Q stays in registers as A fragments, K is staged row-major and V
//    transposed in shared memory (rows padded by 8 elements, so the
//    fragment loads do not conflict), and the score tile stays in
//    registers: its C fragments are the A fragments of P.V once rounded to
//    bf16. That rounding of P (the reference model rounds its
//    probabilities to bf16 before P.V too) is its one departure from the
//    Pallas kernel's arithmetic; l sums the same rounded p, so the weights
//    stay normalised. It is far from its bound, most likely for latency:
//    with 4 resident blocks at Dh 32 and 3 at Dh 64 (99 and 134 registers
//    a thread) an SM has few warps to hide the chain of dependent steps
//    each tile takes (products, row max, shuffles, expf, row sum, rescale,
//    products) between its two barriers.
//  * flash_fwd_kernel, f32: plain f32 FMAs on the SIMT units (67 TFLOP/s),
//    since TF32 would miss the 2e-5 tolerance. Q, K, V (as f32) and P are
//    staged in shared memory, rows padded by one word; each thread owns a
//    4x8 patch of the 64x64 score tile and a 4x(Dh/8) patch of the output,
//    row max and row sum reduced across the 8 threads of a row group with
//    warp shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // key columns per tile
constexpr int kRows = 4;         // rows per thread (16 row groups x 4 = 64)
constexpr int kCols = 8;         // score columns per thread (8 x 8 = 64)
constexpr float kNegInf = -1e30f;

// value dtype codes, mirrored by _DTYPE_CODES in flash_attention.py
enum DType : int { F32 = 0, BF16 = 1 };

struct Strides {  // element strides of a (B, heads, S, Dh) view; Dh is dense
  int64_t b, h, s;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides qs, ks, vs, os;
  int B, H, G, Sq, Sk;
  float scale;
  int causal, window;  // window <= 0: none
  int64_t q_offset;
};

template <int DH>
constexpr int smem_floats() {
  return (kBQ + 2 * kBK) * (DH + 1) + kBQ * (kBK + 1);
}

// ---------------------------------------------------------------------------
// f32 on the SIMT units
// ---------------------------------------------------------------------------

// Rows [s0, s0 + 64) of one head of `src` into `dst` (64 x (DH+1));
// rows at or past `S` read as zero.
template <int DH>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      Strides st, int64_t s0, int S) {
  for (int idx = threadIdx.x; idx < kBK * DH; idx += kThreads) {
    const int r = idx / DH, d = idx % DH;
    const int64_t s = s0 + r;
    dst[r * (DH + 1) + d] = s < S ? src[s * st.s + d] : 0.0f;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  float* sQ = smem;                          // kBQ x (DH+1)
  float* sK = sQ + kBQ * (DH + 1);           // kBK x (DH+1)
  float* sV = sK + kBK * (DH + 1);           // kBK x (DH+1)
  float* sP = sV + kBK * (DH + 1);           // kBQ x (kBK+1)
  constexpr int kOut = DH / 8;               // output columns per thread

  const int n_q = (p.Sq + kBQ - 1) / kBQ;
  const int bh_count = p.B * p.H;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const int b = bh / p.H, h = bh % p.H, kvh = h / p.G;
  const int64_t q0 = static_cast<int64_t>(qt) * kBQ;

  const float* q = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h;
  const float* k =
      static_cast<const float*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const float* v =
      static_cast<const float*>(p.v) + b * p.vs.b + kvh * p.vs.h;
  float* o = static_cast<float*>(p.o) + b * p.os.b + h * p.os.h;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;                   // row group: rows rg*4 + i
  const int cg = tid & 7;                    // columns cg + 8*j
  const int r0 = rg * kRows;

  stage<DH>(sQ, q, p.qs, q0, p.Sq);

  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kOut; ++c) acc[i][c] = 0.0f;
  }

  int64_t kv_end = p.Sk;
  if (p.causal) {  // the block's last row sees columns up to its position
    const int64_t last = p.q_offset + q0 + kBQ - 1;
    kv_end = last + 1 < kv_end ? last + 1 : kv_end;
  }
  const int64_t n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 1;

  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t c0 = t * kBK;
    __syncthreads();                         // the last tile's reads are done
    stage<DH>(sK, k, p.ks, c0, p.Sk);
    stage<DH>(sV, v, p.vs, c0, p.Sk);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = sQ[(r0 + i) * (DH + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = sK[(cg + 8 * j) * (DH + 1) + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t row = p.q_offset + q0 + r0 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int64_t col = c0 + cg + 8 * j;
        bool ok = col < p.Sk;
        if (p.causal) ok = ok && row >= col;
        if (p.window > 0) ok = ok && row - col < p.window;
        s[i][j] = ok ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float e = expf(s[i][j] - m_new);
        rs += e;
        sP[(r0 + i) * (kBK + 1) + cg + 8 * j] = e;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                         // sP complete

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = sP[(r0 + i) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < kOut; ++c) {
        const float vv = sV[j * (DH + 1) + cg + 8 * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int64_t s = q0 + r0 + i;
    if (s >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      o[s * p.os.s + cg + 8 * c] = acc[i][c] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

// d += a . b for one 16x16 (A, row-major) by 16x8 (B, column-major) bf16
// tile pair with f32 accumulators, in the PTX fragment layout: with
// g = lane / 4 and t = lane % 4, a = {A[g][2t..], A[g+8][2t..], A[g][2t+8..],
// A[g+8][2t+8..]}, b = {B[2t..][g], B[2t+8..][g]}, d = {D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1]}; each 32-bit register holds two consecutive
// elements, the lower index in the low half.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 in one register (lo in the low half), and back
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int DH>
constexpr int mma_smem_bytes() {  // sQ, sK: 64 x (DH+8); sVt: DH x (64+8)
  return static_cast<int>(sizeof(bf16)) *
         (2 * kBQ * (DH + 8) + DH * (kBK + 8));
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_mma_kernel(Params p) {
  extern __shared__ uint32_t smem_words[];
  constexpr int LD = DH + 8;                 // sQ, sK row pitch (elements)
  constexpr int LDV = kBK + 8;               // sVt row pitch
  constexpr int PAIRS = DH / 2;              // 32-bit pairs per row
  bf16* sQ = reinterpret_cast<bf16*>(smem_words);
  bf16* sK = sQ + kBQ * LD;
  bf16* sVt = sK + kBK * LD;

  const int n_q = (p.Sq + kBQ - 1) / kBQ;
  const int bh_count = p.B * p.H;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const int b = bh / p.H, h = bh % p.H, kvh = h / p.G;
  const int64_t q0 = static_cast<int64_t>(qt) * kBQ;

  const bf16* q = static_cast<const bf16*>(p.q) + b * p.qs.b + h * p.qs.h;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.ks.b + kvh * p.ks.h;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.vs.b + kvh * p.vs.h;
  bf16* o = static_cast<bf16*>(p.o) + b * p.os.b + h * p.os.h;

  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = (tid >> 5) * 16;            // the warp's first query row

  for (int idx = tid; idx < kBQ * PAIRS; idx += kThreads) {
    const int r = idx / PAIRS, c = 2 * (idx % PAIRS);
    const int64_t s = q0 + r;
    *reinterpret_cast<uint32_t*>(&sQ[r * LD + c]) =
        s < p.Sq ? ld32(q + s * p.qs.s + c) : 0u;
  }
  __syncthreads();
  uint32_t qa[DH / 16][4];
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const bf16* base = sQ + (w0 + g) * LD + kk * 16 + 2 * t;
    qa[kk][0] = ld32(base);
    qa[kk][1] = ld32(base + 8 * LD);
    qa[kk][2] = ld32(base + 8);
    qa[kk][3] = ld32(base + 8 * LD + 8);
  }

  // rows g and g + 8 of the warp: index 0 and 1 below
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  int64_t kv_end = p.Sk;
  if (p.causal) {
    const int64_t last = p.q_offset + q0 + kBQ - 1;
    kv_end = last + 1 < kv_end ? last + 1 : kv_end;
  }
  const int64_t n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 1;

  for (int64_t tile = 0; tile < n_tiles; ++tile) {
    const int64_t c0 = tile * kBK;
    __syncthreads();                         // the last tile's reads are done
    for (int idx = tid; idx < kBK * PAIRS; idx += kThreads) {
      const int r = idx / PAIRS, c = 2 * (idx % PAIRS);
      const int64_t s = c0 + r;
      *reinterpret_cast<uint32_t*>(&sK[r * LD + c]) =
          s < p.Sk ? ld32(k + s * p.ks.s + c) : 0u;
    }
    // V^T: each thread takes keys r, r+1 at dims c, c+1 and writes two
    // words, dims c and c+1 over keys r, r+1. A warp spans 4 dim pairs of
    // 8 key pairs: each load reads 16 contiguous bytes of 8 rows, and each
    // store hits 32 banks (the 72-element pitch puts dims c, c+2, c+4, c+6
    // 8 banks apart)
    for (int idx = tid; idx < (kBK / 2) * PAIRS; idx += kThreads) {
      const int rest = idx >> 2;
      const int r = 2 * (rest % (kBK / 2)),
                c = 2 * (4 * (rest / (kBK / 2)) + (idx & 3));
      const int64_t s = c0 + r;
      const uint32_t v0 = s < p.Sk ? ld32(v + s * p.vs.s + c) : 0u;
      const uint32_t v1 = s + 1 < p.Sk ? ld32(v + (s + 1) * p.vs.s + c) : 0u;
      *reinterpret_cast<uint32_t*>(&sVt[c * LDV + r]) =
          __byte_perm(v0, v1, 0x5410);
      *reinterpret_cast<uint32_t*>(&sVt[(c + 1) * LDV + r]) =
          __byte_perm(v0, v1, 0x7632);
    }
    __syncthreads();

    float sc[kBK / 8][4];                    // the warp's 16 x 64 scores
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const bf16* kb = sK + (j * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(sc[j], qa[kk], ld32(kb), ld32(kb + 8));
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        const int64_t row = p.q_offset + q0 + w0 + g + 8 * hi;
        const int64_t col = c0 + j * 8 + 2 * t + (e & 1);
        bool ok = col < p.Sk;
        if (p.causal) ok = ok && row >= col;
        if (p.window > 0) ok = ok && row - col < p.window;
        sc[j][e] = ok ? sc[j][e] * p.scale : kNegInf;
        mx[hi] = fmaxf(mx[hi], sc[j][e]);
      }
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    // p rounded to bf16 (row g in pk[j][0], row g + 8 in pk[j][1]), as
    // the tensor cores take it, and l sums those same weights
    uint32_t pk[kBK / 8][2];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      pk[j][0] = pack_bf16(expf(sc[j][0] - m[0]), expf(sc[j][1] - m[0]));
      pk[j][1] = pack_bf16(expf(sc[j][2] - m[1]), expf(sc[j][3] - m[1]));
      rs[0] += bf16_lo(pk[j][0]) + bf16_hi(pk[j][0]);
      rs[1] += bf16_lo(pk[j][1]) + bf16_hi(pk[j][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {  // keys 16 kk .. 16 kk + 15
      const uint32_t pa[4] = {pk[2 * kk][0], pk[2 * kk][1],
                              pk[2 * kk + 1][0], pk[2 * kk + 1][1]};
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        const bf16* vb = sVt + (n * 8 + g) * LDV + kk * 16 + 2 * t;
        mma_bf16(acc[n], pa, ld32(vb), ld32(vb + 8));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t s = q0 + w0 + g + 8 * i;
    if (s >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
      *reinterpret_cast<uint32_t*>(o + s * p.os.s + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * i] / denom, acc[n][2 * i + 1] / denom);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename K>
int launch(K kernel, int smem, const Params& p, cudaStream_t st) {
  const int64_t n_q = (p.Sq + kBQ - 1) / kBQ;
  const int64_t blocks = n_q * p.B * p.H;
  if (blocks == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dh(const Params& p, int dtype, cudaStream_t st) {
  if (dtype == BF16)
    return launch(flash_mma_kernel<DH>, mma_smem_bytes<DH>(), p, st);
  return launch(flash_fwd_kernel<DH>,
                static_cast<int>(sizeof(float)) * smem_floats<DH>(), p, st);
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q: (B, H, Sq, Dh), k and v: (B, KV, Sk, Dh), o: (B, H, Sq, Dh), given as
// base pointers and element strides of their first three dims (the last dim
// dense), so the model's (B, S, H, Dh) layout is read in place. dtype: 0 f32,
// 1 bf16 (all four alike). Dh in {16, 32, 64, 128}; H a multiple of KV.
// Launches on `stream`; returns the cudaError_t of the launch (0 on success).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, int dtype, int B, int H, int KV, int Sq,
                          int Sk, int Dh, int64_t qsb, int64_t qsh,
                          int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
                          int64_t vsb, int64_t vsh, int64_t vss, int64_t osb,
                          int64_t osh, int64_t oss, float scale, int causal,
                          int window, int64_t q_offset, void* stream) {
  if (KV <= 0 || H % KV != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
           {osb, osh, oss}, B, H, H / KV, Sq, Sk, scale, causal, window,
           q_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != F32 && dtype != BF16)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (Dh) {
    case 16: return launch_dh<16>(p, dtype, st);
    case 32: return launch_dh<32>(p, dtype, st);
    case 64: return launch_dh<64>(p, dtype, st);
    case 128: return launch_dh<128>(p, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
