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
//     wipes it with alpha = exp(-1e30 - m) = 0; with -inf it would be NaN).
//     A row with no key at all (causal at a negative position, or a window
//     that starts past the last key) averages v over the Sk keys, as the
//     plain version does: its block visits every key tile, where the row
//     gets p = 1 at every column, padding past Sk (v zero there) included,
//     and its output is divided by Sk instead of l;
//   * running max m, denominator l and accumulator in f32, l = l*alpha +
//     sum p, acc = acc*alpha + p v; the output acc / max(l, 1e-30), rounded
//     once to the output dtype;
//   * GQA: query head h reads kv head h / G, K and V never repeated.
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
//  * flash_wgmma_kernel, bf16, built for Hopper. One block per (b, h, 64 x
//    kConsumers query rows), longest rows first, of kConsumers consumer
//    warpgroups (4 at Dh 16 and 32, 3 at Dh 64, 2 at Dh 128: as many as
//    their registers allow) and one producer warpgroup. After setmaxnreg
//    gives the producer's registers to the consumers, one producer thread
//    issues every load as a TMA box copy (a 4-D tensor map (Dh, heads, S, B)
//    per tensor, built on the host from the view's strides, swizzled
//    128/64/32 B for Dh 64/32/16; Dh 128 is two 64-column boxes): Q once,
//    then K and V tile by tile into a ring of 2-3 stages, each with a full
//    and an empty mbarrier. Each consumer warpgroup owns 64 query rows and
//    never issues a copy. Both products run on wgmma: S = Q K^T
//    (m64n128k16, Q and K K-major from shared memory) and O += P V
//    (m64nDh k16, P from registers: the S accumulator packed to bf16 is the
//    A fragment layout; V straight from its TMA tile as an MN-major B, so
//    nothing is transposed in software). P is rounded to bf16 for the
//    tensor cores (the reference model's XLA attention rounds its
//    probabilities to bf16 too), and l sums the same rounded weights: the
//    one departure from the Pallas kernel's arithmetic besides the next.
//    That sum runs on the tensor cores too: beside each P.V step, a
//    m64n8k16 wgmma multiplies the same P fragment by a block of bf16 ones
//    in shared memory, so every column of that accumulator is l (f32, like
//    O), and the softmax spends no instructions on it. O and l are
//    rescaled only when a row's max moved (alpha != 1), which late in a
//    long causal row is rare.
//    Scores are scaled by scale*log2(e) and exponentiated with ex2.approx,
//    one MUFU op, where accurate expf takes several instructions around it:
//    this moves last bits only (relative error ~2^-22, flushed below
//    2^-126), far inside the bf16 tolerance. Key tiles wholly above the
//    causal diagonal or wholly outside the window are skipped (their
//    contribution is exactly zero once a row has seen a real key, and every
//    row sees one in the tiles visited); only the tiles that cross the
//    diagonal, the ragged last tile and a window's edge are masked.
//  * flash_fwd_kernel, f32: plain f32 FMAs on the SIMT units (67 TFLOP/s),
//    since TF32 would miss the 2e-5 tolerance; accurate expf. One 128-thread
//    block per (b, h, 64-row query tile), longest first, walking the
//    64-column key tiles in order, skipping those above the diagonal. Q, K,
//    V (as f32) and P are staged in shared memory, rows padded by one word;
//    each thread owns a 4x8 patch of the 64x64 score tile and a 4x(Dh/8)
//    patch of the output, row max and row sum reduced across the 8 threads
//    of a row group with warp shuffles.

#include <cuda.h>            // CUtensorMap and its enums (no libcuda link)
#include <cudaTypedefs.h>    // PFN_cuTensorMapEncodeTiled_v12000
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

// True if the query at absolute position `pos` has no key to attend to.
__device__ __forceinline__ bool no_key(int64_t pos, const Params& p) {
  return (p.causal && pos < 0) ||
         (p.window > 0 && pos - p.window + 1 >= p.Sk);
}

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
  // the block's last row sees columns up to its position (every column if
  // its first row has no key)
  if (p.causal && !no_key(p.q_offset + q0, p)) {
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
    const float denom =
        fmaxf(no_key(p.q_offset + s, p) ? p.Sk : l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      o[s * p.os.s + cg + 8 * c] = acc[i][c] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16 on Hopper: TMA, an mbarrier ring and wgmma
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kWG = 128;         // threads of a warpgroup
constexpr int kBN = 128;         // keys per tile
constexpr float kLog2e = 1.4426950408889634f;

// The shared-memory plan of one block. A TMA box is at most 128 bytes wide
// (the widest swizzle), so Dh 128 is two boxes of 64 columns; each box of R
// rows is R rows of kSwz bytes, swizzled by the TMA in 8-row atoms of
// 8 * kSwz bytes, and every tile starts on a 1024-byte boundary (a whole
// number of atoms), so the descriptors need no base offset.
template <int DH>
struct Plan {
  // consumer warpgroups of 64 query rows each, and the registers setmaxnreg
  // gives them and the producer: the block's launch allocation (65,536 /
  // threads, rounded down to a multiple of 8) shared out, none left over
  static constexpr int kConsumers = DH == 128 ? 2 : DH == 64 ? 3 : 4;
  static constexpr int kThreads = kWG * (kConsumers + 1);
  static constexpr int kConsumerRegs =
      kConsumers == 2 ? 240 : kConsumers == 3 ? 160 : 112;
  static constexpr int kProducerRegs = kConsumers == 2 ? 24 : 32;
  static constexpr int kBM = 64 * kConsumers;        // query rows per block
  static constexpr int kBox = DH < 64 ? DH : 64;     // columns of one box
  static constexpr int kBoxes = DH / kBox;
  static constexpr int kSwz = 2 * kBox;              // bytes of one box row
  static constexpr int kStages = DH == 128 ? 2 : 3;  // K/V tiles in flight
  static constexpr int kQBytes = kBM * DH * 2;       // Q, all the block's rows
  static constexpr int kTileBytes = kBN * DH * 2;    // one K or one V tile
  // 1 KB of bf16 ones: the B of the wgmma that sums each row of P
  static constexpr int kOnes = kQBytes + 2 * kStages * kTileBytes;
  static constexpr int kBars = kOnes + 1024;
  // + full and empty barriers per stage and Q's, + slack to align the base
  static constexpr int kSmem = kBars + 8 * (2 * kStages + 1) + 1024;
  // the descriptors' swizzle code: 1 = 128 B, 2 = 64 B, 3 = 32 B
  static constexpr uint64_t kSwzCode = kSwz == 128 ? 1 : kSwz == 64 ? 2 : 3;
};

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (all in 16-byte units) and the swizzle mode.
//  * K-major (Q and K: rows of Dh contiguous values): rows of an 8-row atom
//    kSwz bytes apart, atoms `sbo` = 8 * kSwz apart; the leading offset is
//    unused with a swizzle (1 by convention); a 16-wide k step is 32 bytes
//    further along the row.
//  * MN-major (V as the B of P.V: keys are k, Dh is n and contiguous): an
//    atom is 8 keys of kSwz bytes, atoms along k `sbo` apart, along n
//    `lbo` apart (unused: each wgmma here covers one box).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swz) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (swz << 62);
}

// two floats rounded to bf16 in one register (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ptx:begin -- the inline PTX of the bf16 kernel, one statement each

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the MUFU, one instruction (results below 2^-126 flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// arrive, and expect `bytes` more from the TMA before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 4-D (Dh, heads, S, B) tensor map at (d, h, s, b) into
// shared memory, completing its bytes on `bar`; rows past S read as zero
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d, int h, int s,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(s),
      "r"(b) : "memory");
}

// orders this thread's generic-proxy shared-memory stores before later
// async-proxy reads (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until all of this warpgroup's committed wgmma groups are done
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving reads or writes of r across a wgmma wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x 128, f32) = A (64 x 16) . B (128 x 16)^T, both bf16 K-major in
// shared memory; D += when `accumulate` is non-zero
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 16, f32) += A (64 x 16, bf16 in registers: per warp the A
// fragment of an m16n8k16 product) . B (16 x 16, bf16, MN-major in shared
// memory)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, f32) += A (64 x 16, bf16 in registers: per warp the A
// fragment of an m16n8k16 product) . B (16 x 32, bf16, MN-major in shared
// memory)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 in registers: per warp the A
// fragment of an m16n8k16 product) . B (16 x 64, bf16, MN-major in shared
// memory)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 8, f32) += A (64 x 16, bf16 in registers) . B (16 x 8, bf16,
// K-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n8_kmajor(float (&d)[4],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ptx:end

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else wgmma_rs_n64(d, a, db);
}

// S = Q K^T for one key tile, issued (not waited for): 64 x 128 f32,
// element 4j + e at row warp*16 + g + 8(e/2), key 8j + 2 t4 + e%2
template <int DH>
__device__ __forceinline__ void issue_qk(float (&sc)[kBN / 2], uint32_t sQ,
                                         uint32_t sK) {
  using L = Plan<DH>;
  constexpr int kKsteps = L::kBox / 16;          // k steps in one box
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const int x = kk / kKsteps, off = (kk % kKsteps) * 32;
    const uint64_t da = gmma_desc(sQ + x * L::kBM * L::kSwz + off, 16,
                                  8 * L::kSwz, L::kSwzCode);
    const uint64_t db = gmma_desc(sK + x * kBN * L::kSwz + off, 16,
                                  8 * L::kSwz, L::kSwzCode);
    wgmma_ss_n128(sc, da, db, kk);
  }
}

// O += P V for one key tile, issued (not waited for); V straight from its
// TMA tile as an MN-major B. pk[j][r] holds row g + 8r, keys 8j + 2 t4 and
// + 1, so the A fragment for keys 16 kk .. + 15 is pk[2kk], pk[2kk + 1].
// The same fragments times a block of ones add P's row sums to accl.
template <int DH>
__device__ __forceinline__ void issue_pv(
    float (&acc)[Plan<DH>::kBoxes][Plan<DH>::kBox / 2], float (&accl)[4],
    const uint32_t (&pk)[kBN / 8][2], uint32_t sV, uint32_t sOnes) {
  using L = Plan<DH>;
  // 8 rows of 16 ones, K-major, 32-byte swizzle (one atom: no offsets read)
  const uint64_t d1 = gmma_desc(sOnes, 16, 256, 3);
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint32_t a[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0],
                           pk[2 * kk + 1][1]};
#pragma unroll
    for (int x = 0; x < L::kBoxes; ++x)
      wgmma_rs<L::kBox>(
          acc[x], a,
          gmma_desc(sV + x * kBN * L::kSwz + kk * 16 * L::kSwz,
                    kBN * L::kSwz, 8 * L::kSwz, L::kSwzCode));
    wgmma_rs_n8_kmajor(accl, a, d1);
  }
}

// The online softmax of one tile of scores `sc` (raw q.k) for the thread's
// rows `row` and row + 8: updates the running max m (log2 units), returns
// alpha = 2^(m_old - m_new) and the weights p = 2^(s scale log2(e) - m)
// rounded to bf16 in pk. With
// `masked`, keys at or past Sk, above the diagonal or outside the window
// score NEG_INF (in log2 units, as the reference masks scaled scores).
__device__ __forceinline__ void softmax_tile(
    float (&sc)[kBN / 2], uint32_t (&pk)[kBN / 8][2], float (&m)[2],
    float (&alpha)[2], bool masked, int64_t row, int64_t c0,
    const Params& p, float sl2) {
  float mx[2] = {kNegInf, kNegInf};
  if (masked) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t r = row + 8 * (e >> 1);
        const int64_t col = c0 + 8 * j + 2 * (threadIdx.x % 4) + (e & 1);
        bool ok = col < p.Sk;
        if (p.causal) ok = ok && r >= col;
        if (p.window > 0) ok = ok && r - col < p.window;
        sc[4 * j + e] = ok ? sc[4 * j + e] * sl2 : kNegInf;
      }
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    // an unmasked tile's max is raw: scale it (rounding is monotone, so
    // this is the max of the rounded scaled scores)
    const float m_new = fmaxf(m[r], masked ? mx[r] : mx[r] * sl2);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
  // p = 2^(s - m): one FFMA from a raw score, one FADD from a masked tile's
  // scaled one (whose all-masked rows need s - m = -1e30 - -1e30 = 0 exactly)
  if (masked) {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        pk[j][r] = pack_bf16(ex2(sc[4 * j + 2 * r] - m[r]),
                             ex2(sc[4 * j + 2 * r + 1] - m[r]));
  } else {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        pk[j][r] = pack_bf16(ex2(fmaf(sc[4 * j + 2 * r], sl2, -m[r])),
                             ex2(fmaf(sc[4 * j + 2 * r + 1], sl2, -m[r])));
  }
}

// One block per (b, h, kBM query rows), longest rows first. Consumer
// warpgroups 0 .. kConsumers - 1 each own 64 query rows; the last
// warpgroup is the producer, of which one thread issues every TMA load: Q
// once, then each key tile's K and V into the next free stage of the ring.
// A stage's full barrier completes when its bytes have landed, its empty
// barrier when every consumer warp is done with it. Each consumer
// warpgroup takes a tile in order (S = Q K^T, wait, softmax, O += P V,
// wait); the warpgroups of a block, at their own pace, keep the tensor
// cores, the MUFU and the FP32 units busy together.
template <int DH>
__global__ void __launch_bounds__(Plan<DH>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Plan<DH>;
  constexpr int NS = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sKV = base + L::kQBytes, bars = base + L::kBars;
  const uint32_t q_bar = bars + 16 * NS;
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (NS + st); };
  auto k_tile = [&](int st) { return sKV + st * 2 * L::kTileBytes; };
  auto v_tile = [&](int st) { return k_tile(st) + L::kTileBytes; };

  constexpr int kBM = L::kBM;
  const int n_q = (p.Sq + kBM - 1) / kBM;
  const int bh_count = p.B * p.H;
  const int qt = n_q - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const int b = bh / p.H, h = bh % p.H, kvh = h / p.G;
  const int q0 = qt * kBM;

  // the key tiles [t0, t1) that hold an unmasked key of some row: causal
  // stops at the last row's position, a window starts at the first row's
  // position - window + 1 (tiles outside both are exactly zero once a row
  // has seen a real key; every row sees one in [t0, t1)), or every tile if
  // a row of the block has no key (the header)
  const int64_t row_first = p.q_offset + q0;
  const int64_t row_last = p.q_offset + min(q0 + kBM, p.Sq) - 1;
  int64_t kv_end = p.Sk, kv_beg = 0;
  if (p.causal && row_last + 1 < kv_end) kv_end = row_last + 1;
  if (p.window > 0 && row_first - p.window + 1 > 0)
    kv_beg = row_first - p.window + 1;
  if (no_key(row_first, p) || no_key(row_last, p)) kv_end = p.Sk, kv_beg = 0;
  const int t1 = kv_end > 0 ? static_cast<int>((kv_end + kBN - 1) / kBN) : 1;
  const int t0 = kv_beg / kBN < t1 - 1 ? static_cast<int>(kv_beg / kBN)
                                         : t1 - 1;

  {
    uint32_t* ones = reinterpret_cast<uint32_t*>(
        smem_raw + (base - smem_addr(smem_raw)) + L::kOnes);
    for (int k = threadIdx.x; k < 256; k += L::kThreads) ones[k] = 0x3F803F80u;
    fence_proxy_async();
  }
  if (threadIdx.x == 0) {
    for (int st = 0; st < NS; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), 4 * L::kConsumers);     // one per warp
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == L::kConsumers) {
    // -- producer ---------------------------------------------------------
    regs_dec<L::kProducerRegs>();
    if (threadIdx.x == L::kConsumers * kWG) {
      mbar_expect_tx(q_bar, L::kQBytes);
      for (int x = 0; x < L::kBoxes; ++x)
        tma_load(sQ + x * kBM * L::kSwz, &tq, q_bar, x * L::kBox, h, q0, b);
      for (int t = t0, i = 0; t < t1; ++t, ++i) {
        const int st = i % NS;
        mbar_wait(empty(st), ((i / NS) & 1) ^ 1);   // round 0 passes at once
        mbar_expect_tx(full(st), 2 * L::kTileBytes);
        for (int x = 0; x < L::kBoxes; ++x) {
          tma_load(k_tile(st) + x * kBN * L::kSwz, &tk, full(st),
                   x * L::kBox, kvh, t * kBN, b);
          tma_load(v_tile(st) + x * kBN * L::kSwz, &tv, full(st),
                   x * L::kBox, kvh, t * kBN, b);
        }
      }
    }
  } else {
    // -- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ---------
    regs_inc<L::kConsumerRegs>();
    const int tid = threadIdx.x % kWG, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int64_t wrow = p.q_offset + q0 + 64 * wg;   // its first position
    const int64_t row = wrow + warp * 16 + g;         // this thread's first
    const float sl2 = p.scale * kLog2e;               // scores to log2 units
    const uint32_t sQw = sQ + wg * 64 * L::kSwz;      // its 64 rows of Q
    // a tile needs the masks if a key in it can be masked for a row of the
    // warpgroup: the causal diagonal, the ragged last tile, a window's edge
    auto needs_mask = [&](int t) {
      const int64_t c0 = static_cast<int64_t>(t) * kBN;
      return (p.causal && c0 + kBN - 1 > wrow) || c0 + kBN > p.Sk ||
             (p.window > 0 && wrow + 63 - c0 >= p.window);
    };

    // the accumulator of P.V, one m64nBox fragment per box: element 4j + e
    // is row warp*16 + g + 8(e/2), column box*kBox + 8j + 2 t4 + e%2
    float acc[L::kBoxes][L::kBox / 2];
#pragma unroll
    for (int x = 0; x < L::kBoxes; ++x)
#pragma unroll
      for (int i = 0; i < L::kBox / 2; ++i) acc[x][i] = 0.0f;
    // running max (log2 units) of rows g and g + 8 of its warp, and their
    // sums l of the rounded weights: an m64n8 accumulator whose elements 0,
    // 1 hold row g's and 2, 3 row g + 8's
    float m[2] = {kNegInf, kNegInf}, accl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float sc[kBN / 2], alpha[2];
    uint32_t pk[kBN / 8][2];

    mbar_wait(q_bar, 0);
    int i = 0;
    for (int t = t0; t < t1; ++t, ++i) {
      const int st = i % NS;
      mbar_wait(full(st), (i / NS) & 1);
      wgmma_fence();
      issue_qk<DH>(sc, sQw, k_tile(st));
      wgmma_commit();
      wgmma_wait();
      reg_fence(sc);
      softmax_tile(sc, pk, m, alpha, needs_mask(t), row,
                   static_cast<int64_t>(t) * kBN, p, sl2);
      // rescale only if a row's max moved (alpha is then not 1): late in a
      // long row it rarely does, and the branch is the same for the warp
      if (__any_sync(0xffffffffu, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
        for (int x = 0; x < L::kBoxes; ++x)
#pragma unroll
          for (int i2 = 0; i2 < L::kBox / 2; ++i2)
            acc[x][i2] *= alpha[(i2 >> 1) & 1];
#pragma unroll
        for (int i2 = 0; i2 < 4; ++i2) accl[i2] *= alpha[i2 >> 1];
      }
      wgmma_fence();
      issue_pv<DH>(acc, accl, pk, v_tile(st), base + L::kOnes);
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int x = 0; x < L::kBoxes; ++x) reg_fence(acc[x]);
      reg_fence(accl);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));         // the stage is free
    }

    bf16* o = static_cast<bf16*>(p.o) + b * p.os.b + h * p.os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t s = q0 + 64 * wg + warp * 16 + g + 8 * r;
      if (s >= p.Sq) continue;
      const float denom =
          fmaxf(no_key(p.q_offset + s, p) ? p.Sk : accl[2 * r], 1e-30f);
#pragma unroll
      for (int x = 0; x < L::kBoxes; ++x)
#pragma unroll
        for (int j = 0; j < L::kBox / 8; ++j)
          *reinterpret_cast<uint32_t*>(o + s * p.os.s + x * L::kBox + 8 * j +
                                       2 * t4) =
              pack_bf16(acc[x][4 * j + 2 * r] / denom,
                        acc[x][4 * j + 2 * r + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, looked up in libcuda at run time, so the library
// is not linked against it
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult got;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &got);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                              cudaEnableDefault, &got);
#endif
    if (err == cudaSuccess && got == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }
  return fn;
}

// The 4-D map (Dh, heads, S, B) of a bf16 (B, heads, S, Dh) view with
// element strides `st`, read in boxes of (box_cols, 1, rows, 1). A dim of
// size 1 takes the dense stride (never stepped; any torch stride is legal
// there). TMA wants the base 16-byte aligned and strides in multiples of 16
// bytes: the wrapper copies a view that is not.
int make_map(CUtensorMap* map, const void* ptr, int heads, int S, int B,
             int Dh, Strides st, int box_cols, int rows) {
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(Dh), static_cast<cuuint64_t>(heads),
      static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {
      heads > 1 ? static_cast<cuuint64_t>(st.h) * 2 : dims[0] * 2,
      S > 1 ? static_cast<cuuint64_t>(st.s) * 2 : dims[0] * dims[1] * 2,
      B > 1 ? static_cast<cuuint64_t>(st.b) * 2
            : dims[0] * dims[1] * dims[2] * 2};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1,
                       static_cast<cuuint32_t>(rows), 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz =
      box_cols * 2 == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : box_cols * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(ptr), dims, strides, box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int DH>
int launch_bf16(const Params& p, int KV, cudaStream_t st) {
  using L = Plan<DH>;
  const int64_t blocks =
      static_cast<int64_t>((p.Sq + L::kBM - 1) / L::kBM) * p.B * p.H;
  if (blocks == 0) return 0;
  if (p.Sk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, p.q, p.H, p.Sq, p.B, DH, p.qs, L::kBox, L::kBM);
  if (!err) err = make_map(&tk, p.k, KV, p.Sk, p.B, DH, p.ks, L::kBox, kBN);
  if (!err) err = make_map(&tv, p.v, KV, p.Sk, p.B, DH, p.vs, L::kBox, kBN);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_wgmma_kernel<DH>
      <<<static_cast<unsigned>(blocks), L::kThreads, L::kSmem, st>>>(tq, tk,
                                                                     tv, p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_f32(const Params& p, cudaStream_t st) {
  const int64_t blocks =
      static_cast<int64_t>((p.Sq + kBQ - 1) / kBQ) * p.B * p.H;
  if (blocks == 0) return 0;
  const int smem = static_cast<int>(sizeof(float)) * smem_floats<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel<DH><<<static_cast<unsigned>(blocks), kThreads, smem, st>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int launch_dh(const Params& p, int KV, int dtype, cudaStream_t st) {
  return dtype == BF16 ? launch_bf16<DH>(p, KV, st) : launch_f32<DH>(p, st);
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q: (B, H, Sq, Dh), k and v: (B, KV, Sk, Dh), o: (B, H, Sq, Dh), given as
// base pointers and element strides of their first three dims (the last dim
// dense), so the model's (B, S, H, Dh) layout is read in place. dtype: 0 f32,
// 1 bf16 (all four alike). Dh in {16, 32, 64, 128}; H a multiple of KV. For
// bf16, q, k and v start 16-byte aligned with strides in multiples of 8
// elements (the TMA's rule; dims of size 1 excepted), and o's row pairs are
// 4-byte aligned. Launches on `stream`; returns the cudaError_t of the
// launch (0 on success).
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
    case 16: return launch_dh<16>(p, KV, dtype, st);
    case 32: return launch_dh<32>(p, KV, dtype, st);
    case 64: return launch_dh<64>(p, KV, dtype, st);
    case 128: return launch_dh<128>(p, KV, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
