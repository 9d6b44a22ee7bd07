// RWKV-6 chunked WKV for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (src/repro_torch/kernels/rwkv6/rwkv6.py).
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6/rwkv6.py _wkv_kernel
// (K7). Per (batch b, head h), over chunks of T steps, with the (dh x dh)
// f32 state S carried from chunk to chunk and per-channel log-decays lw < 0:
//   cum   = cumsum(lw) over the chunk (inclusive), cumex_t = cum_{t-1}
//   out_t = sum_{s<t} [sum_d r_t[d] k_s[d] exp(cumex_t[d] - cum_s[d])] v_s
//         + (sum_d u[d] r_t[d] k_t[d]) v_t                  (the bonus)
//         + (r_t o exp(cumex_t)) S                          (inter-chunk)
//   S'    = diag(exp(cum_T)) S + sum_s (k_s o exp(cum_T - cum_s))^T v_s
// r, k, v are read in their dtype (f32 or bf16) and widened to f32, as the
// Pallas kernel's astype(f32) does. A ragged last chunk is padded with
// identity steps (r = k = v = 0, lw = 0); here the copies zero the rows
// past S. Unlike the Pallas kernel, this one starts from a given state (or
// zero) and writes the final state, which prefill hands to decode. cumex_t
// is taken as the scan's row t - 1 (0 at t = 0), which is cum_t - lw_t
// without the rounding of the subtraction.
//
// Bound on an H100: the bytes. At rwkv6-1.6b's serving shape (B 4, H 32,
// S 2,000, dh 64, T 128; r, k, v in bf16) the inputs and outputs are ~0.23
// GB (0.069 ms at 3.35 TB/s, chip_smoke.scan_bound). The kernels below move
// ~0.49 GB (k, v and lw read twice, the state scratch four times: 0.15 ms)
// and do ~3.4G multiply-adds on the tensor cores and ~0.2G exponentials
// (ex2.approx).
//
// Decays. A decay exp(x - y) is only ever formed with x - y <= 0 (clamped
// at 0, so rounding cannot push it past 1): split into exp(x) exp(-y) it
// overflows, since lw reaches -20 a step and exp(-cum) passes f32's range
// within five steps. The chunk's rows are cut into sub-chunks of 16; with
// B_i = cum at the row before sub-chunk i (B_0 = 0), a pair (t, s) with t
// in sub-chunk i and s in an earlier sub-chunk j factors as
//   exp(cumex_t - cum_s) = exp(cumex_t - B_i) exp(B_i - B_{j+1}) exp(B_{j+1} - cum_s)
// (B_{j+1} is cum at j's last row), each exponent <= 0. So the scores of
// such pairs are a product, sum_d q_t[d] D_ij[d] kk_s[d], with q = r o
// exp(cumex - B_i) and kk = k o exp(B_{j+1} - cum) formed once a row and
// D_ij once a pair of sub-chunks. A factor underflows to 0 only where the
// weight it bounds is already below f32's range. Pairs inside one
// sub-chunk keep the pairwise exp(cumex_t - cum_s), for s < t only.
//
// Products. They run on the tensor cores in split TF32 ("3xTF32",
// CUTLASS's fast f32): each f32 operand x is hi = rna_tf32(x) plus lo = x -
// hi (exact in f32; the tensor core reads lo's top 11 significant bits),
// and a product is lo_a hi_b + hi_a lo_b + hi_a hi_b, accumulated in f32.
// v in bf16 is exact in TF32, so a product with it as B has no lo_b term.
// What is dropped is ~2^-21 relative, where one TF32 product (~1e-3) would
// break the 1e-4 tolerance the reference holds its kernel to. Decays are
// applied in f32 before the split.
//
// Design: three kernels, launched in order on the caller's stream, with
// their intermediates in a workspace the caller allocates
// (repro_wkv6_workspace_bytes):
//  1. wkv6_chunk_state, one block per (b, h, chunk): the chunk's cum (a
//     block-wide scan: per-thread runs of a column, combined through
//     shared memory), exp(cum_T), and the chunk's own state
//     dS = sum_s (k_s o exp(cum_T - cum_s))^T v_s over 64-row key tiles.
//  2. wkv6_state_pass, one thread per (b, h, d, e): S_c = exp(cum_T,c-1)
//     S_{c-1} + dS_{c-1} in chunk order, from state_in or zero, 16 chunks'
//     loads in flight at a time; each chunk's entering state overwrites its
//     dS, and the last S is state_out.
//  3. wkv6_chunk_out, one block per (b, h, chunk): the chunk's cum again
//     (it bounds the chunk: T x 64 floats of shared memory), then its
//     64-row tiles in order, with the state R entering each tile carried in
//     shared memory (R_0 = S_c): with q0 the tile's first row and q1 its
//     last, per tile
//       - the four sub-chunks' pairwise scores, a pair a thread, and the
//         bonus on their diagonals, a row a thread, from the raw r and k;
//       - q and kk of the tile's rows;
//       - out_t = (q_t o exp(B_i - cum_{q0-1})) R        (the state)
//               + sum_{s in an earlier sub-chunk of the tile} (q_t D_ij . kk_s) v_s
//               + sum_{s <= t in t's sub-chunk} pairwise_ts v_s;
//       - R = diag(exp(cum_q1 - cum_{q0-1})) R
//             + sum_{s in the tile} (kk_s o exp(cum_q1 - B_{j+1}))^T v_s,
//     the recurrence at 64-step granularity (every factor <= 1), so no
//     tile is read twice and no score tile lies off the diagonal.
// Every product is a 64 x 64 output tile on 8 warps, each a 16 x 32 strip
// (a sub-chunk's rows), per 8 steps of depth mma.sync.m16n8k8 TF32 tiles,
// with fragments read from shared tiles whose row strides keep a fragment
// load on 32 distinct banks (68 floats where the tile is read along its
// rows, 72 where along its columns; the inline PTX is in small functions
// between the ptx:begin and ptx:end lines, for which tools/cuda_shim
// stands in). Tiles are copied with cp.async (no registers held, zero fill
// past the edges, 16 bytes a copy where the rows allow).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // rows of a tile; also the largest dh
constexpr int kSub = 16;         // rows of a sub-chunk: a warp's rows
constexpr int kLdR = 68;         // row stride of a tile read along rows
constexpr int kLdC = 72;         // row stride of a tile read along columns
constexpr int kThreads = 256;    // 8 warps, a 16 x 32 strip of a tile each
constexpr int kRowTile = kTile * kLdR;
constexpr int kColTile = kTile * kLdC;
constexpr int kTileElems = kTile * kTile;
constexpr int kNs = kTile / kSub;                // sub-chunks a tile
constexpr int kPairs = kSub * (kSub - 1) / 2;   // a sub-chunk's s < t
constexpr int kMaxSmem = 232448; // bytes a block may use on an H100

// value dtype codes, mirrored by _DTYPE_CODES in rwkv6.py
enum DType : int { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

struct WkvArgs {
  const void* r; int64_t r_b, r_h, r_s;      // (B, H, S, dh), dense last dim
  const void* k; int64_t k_b, k_h, k_s;
  const void* v; int64_t v_b, v_h, v_s;
  const float* lw; int64_t lw_b, lw_h, lw_s; // (B, H, S, dh) f32
  const float* u;                            // (H, dh) f32 contiguous
  const float* state_in;                     // (B, H, dh, dh) or null (zero)
  float* out; int64_t o_b, o_h, o_s;         // (B, H, S, dh) f32
  float* state_out;                          // (B, H, dh, dh)
  float* st;       // (B, H, nc, dh, dh): dS, then each chunk's entering state
  float* decay;    // (B, H, nc, dh): exp(cum_T)
  int H, S, dh, chunk, nc, t64;              // t64: chunk rounded up to 64
};

// ptx:begin -- the tensor-core and async-copy statements, one each
// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// the bits below it zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// asynchronous copies global -> shared of 16 bytes, of which `bytes` are
// read (0: zero fill, nothing read); a group is committed, then waited for
// while at most N younger groups stay in flight
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// 2^x (ex2.approx: within 2^-22 relative; results below f32's normal
// range flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d += a b for a 16 x 8 (row) by 8 x 8 (col) TF32 tile, f32 accumulate.
// Lane (g, q) = (lane / 4, lane % 4) holds a: (g, q) (g + 8, q) (g, q + 4)
// (g + 8, q + 4); b: (q, g) (q + 4, g); d: (g, 2q) (g, 2q + 1) (g + 8, 2q)
// (g + 8, 2q + 1).
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// ptx:end

// cp.async copies of rows [0, rows) and columns [0, width) of a matrix of T
// with row stride ld into a 64 x 64 tile dst (row stride ldd elements, a
// multiple of 16 bytes), zero elsewhere: 16 bytes a copy where src, ld and
// width allow, else one element at a time through registers
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, int ldd, const T* src,
                                          int64_t ld, int rows, int width) {
  constexpr int kVec = 16 / sizeof(T);
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && ld % kVec == 0 &&
      width % kVec == 0) {
#pragma unroll
    for (int i = 0; i < kTileElems / (kVec * kThreads); ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int r = e / (kTile / kVec), c = kVec * (e % (kTile / kVec));
      const bool in = r < rows && c < width;
      cp_async16(dst + r * ldd + c, in ? src + r * ld + c : src, in ? 16 : 0);
    }
    return;
  }
  for (int e = threadIdx.x; e < kTileElems; e += kThreads) {
    const int r = e >> 6, c = e & 63;
    dst[r * ldd + c] = (r < rows && c < width) ? src[r * ld + c] : zero_of<T>();
  }
}

// x = hi + lo: hi rounded to TF32, lo = x - hi exact in f32 (the tensor
// core reads its top 11 significant bits: at most ~2^-22 of x is dropped)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// acc[4 j + v] += sum_{k < K} A(m, k) B(k, n) over K rounded up to 8 (the
// operands are zero there), for the warp's 16 rows from m0 and NT 8-column
// tiles from n0: value v of tile j is row m0 + g + 8 (v / 2), column n0 +
// 8 j + 2q + v % 2, the mma's d fragment. a(m, k) and b(k, n) read the
// operands' f32 values; kExactB: B's values are exact in TF32 (bf16), so
// B has no lo part and a tile takes two mmas instead of three.
template <int NT, bool kExactB, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float* acc, int m0, int n0, int K,
                                         FA a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  for (int k = 0; k < K; k += 8) {
    uint32_t ah[4], al[4];
    split_tf32(a(m0 + g, k + q), ah[0], al[0]);
    split_tf32(a(m0 + g + 8, k + q), ah[1], al[1]);
    split_tf32(a(m0 + g, k + q + 4), ah[2], al[2]);
    split_tf32(a(m0 + g + 8, k + q + 4), ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j + g;
      uint32_t bh[2], bl[2];
      if (kExactB) {
        bh[0] = __float_as_uint(b(k + q, n));
        bh[1] = __float_as_uint(b(k + q + 4, n));
      } else {
        split_tf32(b(k + q, n), bh[0], bl[0]);
        split_tf32(b(k + q + 4, n), bh[1], bl[1]);
      }
      mma_tf32(acc + 4 * j, al, bh);     // the small terms first
      if (!kExactB) mma_tf32(acc + 4 * j, ah, bl);
      mma_tf32(acc + 4 * j, ah, bh);
    }
  }
}

// the warp's 16 x 32 strip of a 64 x 64 tile: rows 16 (w % 4) + [0, 16),
// a sub-chunk; columns 32 (w / 4) + [0, 32); value v of acc[16] is row
// acc_row(v), column acc_col(v)
__device__ __forceinline__ int warp_rows() { return (threadIdx.x >> 5) & 3; }
__device__ __forceinline__ int warp_cols() { return threadIdx.x >> 7; }
__device__ __forceinline__ int acc_row(int v) {
  return 16 * warp_rows() + ((threadIdx.x & 31) >> 2) + 8 * ((v >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int v) {
  return 32 * warp_cols() + 8 * (v >> 2) + 2 * (threadIdx.x & 3) + (v & 1);
}

// a decay exp(x), x <= 0 by construction (the clamp keeps rounding from
// lifting it past 1), as ex2.approx of x log2(e): within 2^-22 + |x| 2^-24
// relative, so within 1.2e-6 of every weight above 1e-9 (the tolerance is
// 1e-4); below f32's normal range it is 0
__device__ __forceinline__ float decay_exp(float x) {
  return ex2(fminf(x, 0.0f) * 1.44269504f);
}

// cum[t][d] (row stride kLdR, rows t < t64; row -1 is zero) <- cp.async
// copies of lw, zero at rows >= valid and columns >= dh (issue_lw; the
// caller commits and waits), then their inclusive cumsum over t
// (chunk_cumsum): thread (d, part) = (tid % 64, tid / 64) sums a run of
// t64 / 4 rows of column d (a warp reads 32 columns of one row: 32 banks),
// the runs' totals meet in tot[4][64], and each run is rewritten from the
// total of the runs before it. chunk_cumsum starts and ends with a
// __syncthreads.
__device__ __forceinline__ void issue_lw(float* cum, const float* lw,
                                         int64_t ld, int valid, int dh,
                                         int t64) {
  for (int t0 = 0; t0 < t64; t0 += kTile)
    copy_tile(cum + t0 * kLdR, kLdR, lw + t0 * ld, ld, valid - t0, dh);
  if (threadIdx.x < kLdR) cum[static_cast<int>(threadIdx.x) - kLdR] = 0.0f;
}
__device__ void chunk_cumsum(float* cum, int t64, float* tot) {
  __syncthreads();
  const int d = threadIdx.x & 63, part = threadIdx.x >> 6;
  const int run = t64 / 4;
  float* col = cum + part * run * kLdR + d;
  float sum = 0.0f;
  for (int i = 0; i < run; ++i) sum += col[i * kLdR];
  tot[threadIdx.x] = sum;
  __syncthreads();
  float acc = 0.0f;                    // the runs before
  for (int p = 0; p < part; ++p) acc += tot[p * kTile + d];
  for (int i = 0; i < run; ++i) {
    acc += col[i * kLdR];
    col[i * kLdR] = acc;
  }
  __syncthreads();
}

// step 1: the chunk's exp(cum_T) and own state dS[d][e]
template <typename T>
__global__ void __launch_bounds__(kThreads, 3) wkv6_chunk_state(WkvArgs a) {
  extern __shared__ float smem[];
  float* tot = smem;                   // the scan's run totals   [4][64]
  float* cum = tot + 4 * kTile + kLdR; // [t64][kLdR], row -1 before it
  float* Kw = cum + a.t64 * kLdR;      // k o exp(cum_T - cum_s)  [s][d]
  T* Vs = reinterpret_cast<T*>(Kw + kColTile);   // v            [s][e]
  // the raw k: in Kw itself (f32; each thread then rewrites the elements
  // it read), or behind v (bf16, dense rows)
  T* Kr = sizeof(T) == 4 ? reinterpret_cast<T*>(Kw) : Vs + kColTile;
  const int ldk = sizeof(T) == 4 ? kLdC : kTile;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * a.chunk, valid = min(a.chunk, a.S - c0);
  const int64_t bhc = (static_cast<int64_t>(b) * a.H + h) * a.nc + c;
  const T* k = static_cast<const T*>(a.k) + b * a.k_b + h * a.k_h +
               static_cast<int64_t>(c0) * a.k_s;
  const T* v = static_cast<const T*>(a.v) + b * a.v_b + h * a.v_h +
               static_cast<int64_t>(c0) * a.v_s;
  auto issue = [&](int k0) {           // k and v of the key tile from k0
    const int rows = min(kTile, valid - k0);
    copy_tile(Kr, ldk, k + k0 * a.k_s, a.k_s, rows, a.dh);
    copy_tile(Vs, kLdC, v + k0 * a.v_s, a.v_s, rows, a.dh);
    cp_async_commit();
  };
  issue_lw(cum, a.lw + b * a.lw_b + h * a.lw_h +
                    static_cast<int64_t>(c0) * a.lw_s,
           a.lw_s, valid, a.dh, a.t64);
  cp_async_commit();
  issue(0);                            // in flight during the scan
  cp_async_wait<1>();
  chunk_cumsum(cum, a.t64, tot);
  const float* cum_T = cum + (a.chunk - 1) * kLdR;
  if (threadIdx.x < a.dh)
    a.decay[bhc * a.dh + threadIdx.x] = expf(cum_T[threadIdx.x]);
  float acc[16] = {};
  for (int k0 = 0; k0 < valid; k0 += kTile) {
    const int rows = min(kTile, valid - k0);
    if (k0 > 0) {
      __syncthreads();                 // the last tile is read
      issue(k0);
    }
    cp_async_wait<0>();
    __syncthreads();
    float x[kTileElems / kThreads];
#pragma unroll
    for (int i = 0; i < kTileElems / kThreads; ++i) {
      const int e = threadIdx.x + kThreads * i, s = e >> 6, d = e & 63;
      x[i] = to_f32(Kr[s * ldk + d]) *
             decay_exp(cum_T[d] - cum[(k0 + s) * kLdR + d]);
    }
#pragma unroll
    for (int i = 0; i < kTileElems / kThreads; ++i) {
      const int e = threadIdx.x + kThreads * i;
      Kw[(e >> 6) * kLdC + (e & 63)] = x[i];
    }
    __syncthreads();
    warp_mma<4, sizeof(T) == 2>(
        acc, 16 * warp_rows(), 32 * warp_cols(), rows,
        [&](int d, int s) { return Kw[s * kLdC + d]; },
        [&](int s, int e) { return to_f32(Vs[s * kLdC + e]); });
  }
  float* out = a.st + bhc * a.dh * a.dh;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int d = acc_row(i), e = acc_col(i);
    if (d < a.dh && e < a.dh) out[d * a.dh + e] = acc[i];
  }
}

// step 2: the states in chunk order, one thread per element d dh + e
__global__ void __launch_bounds__(kThreads) wkv6_state_pass(WkvArgs a) {
  const int dd = a.dh * a.dh;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= dd) return;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * a.H + blockIdx.y;
  float s = a.state_in != nullptr ? a.state_in[bh * dd + e] : 0.0f;
  float* st = a.st + bh * a.nc * dd + e;
  const float* dec = a.decay + bh * a.nc * a.dh + e / a.dh;
  for (int c0 = 0; c0 < a.nc; c0 += 16) {
    float ds[16], dk[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      ds[i] = c0 + i < a.nc ? st[static_cast<int64_t>(c0 + i) * dd] : 0.0f;
      dk[i] = c0 + i < a.nc ? dec[static_cast<int64_t>(c0 + i) * a.dh] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (c0 + i < a.nc) {
        st[static_cast<int64_t>(c0 + i) * dd] = s;  // entering chunk c0 + i
        s = dk[i] * s + ds[i];
      }
    }
  }
  a.state_out[bh * dd + e] = s;
}

// 4 values of a row from element d: f32 as one float4, bf16 as 8 bytes
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

// step 3: out of the chunk, a 64-row tile at a time, the state carried
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) wkv6_chunk_out(WkvArgs a) {
  extern __shared__ float smem[];
  float* cum = smem + kLdR;            // [t64][kLdR], row -1 before it
  float* Qh = cum + a.t64 * kLdR;      // q of the tile, then the scores P [t][d], [t][s]
  float* Kh = Qh + kRowTile;           // kk of the tile                     [s][d]
  float* R = Kh + kRowTile;            // the state entering the tile        [d][e]
  T* Vs = reinterpret_cast<T*>(R + kColTile);   // v of the tile            [s][e]
  float* Pd = reinterpret_cast<float*>(Vs + kColTile);  // pairwise [kNs][kSub][kSub]
  float* E = Pd + kNs * kSub * kSub;   // exp(B_i - cum_{q0-1})              [kNs][64]
  float* D = E + kNs * kTile;          // exp(B_i - B_j+1), j < i; else 0    [kNs][kNs][64]
  float* U = D + kNs * kNs * kTile;    // exp(cum_q1 - B_j+1)                [kNs][64]
  float* decR = U + kNs * kTile;       // exp(cum_q1 - cum_{q0-1})           [64]
  float* us = decR + kTile;            // u                                  [64]
  // the raw r and k: in Qh and Kh themselves (f32), or in the last 9 KB of
  // each (bf16, rows of 144 bytes, so the pairwise scores' reads of
  // different rows fall on different banks); read into registers before q
  // and kk overwrite them
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int kLdRaw = kF32 ? kLdR : kLdC;
  T* Rr = reinterpret_cast<T*>(Qh + (kF32 ? 0 : kRowTile - kColTile / 2));
  T* Kr = reinterpret_cast<T*>(Kh + (kF32 ? 0 : kRowTile - kColTile / 2));
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int c0 = c * a.chunk, valid = min(a.chunk, a.S - c0);
  const int64_t bhc = (static_cast<int64_t>(b) * a.H + h) * a.nc + c;
  const T* r = static_cast<const T*>(a.r) + b * a.r_b + h * a.r_h +
               static_cast<int64_t>(c0) * a.r_s;
  const T* k = static_cast<const T*>(a.k) + b * a.k_b + h * a.k_h +
               static_cast<int64_t>(c0) * a.k_s;
  const T* v = static_cast<const T*>(a.v) + b * a.v_b + h * a.v_h +
               static_cast<int64_t>(c0) * a.v_s;
  float* out = a.out + b * a.o_b + h * a.o_h + static_cast<int64_t>(c0) * a.o_s;
  auto issue = [&](int q0) {           // r, k and v of the tile from q0
    const int rows = min(kTile, valid - q0);
    copy_tile(Rr, kLdRaw, r + q0 * a.r_s, a.r_s, rows, a.dh);
    copy_tile(Kr, kLdRaw, k + q0 * a.k_s, a.k_s, rows, a.dh);
    copy_tile(Vs, kLdC, v + q0 * a.v_s, a.v_s, rows, a.dh);
    cp_async_commit();
  };
  copy_tile(R, kLdC, a.st + bhc * a.dh * a.dh, a.dh, a.dh, a.dh);
  issue_lw(cum, a.lw + b * a.lw_b + h * a.lw_h +
                    static_cast<int64_t>(c0) * a.lw_s,
           a.lw_s, valid, a.dh, a.t64);
  cp_async_commit();
  issue(0);                            // in flight during the scan
  if (threadIdx.x < kTile)
    us[threadIdx.x] = threadIdx.x < a.dh ? a.u[h * a.dh + threadIdx.x] : 0.0f;
  cp_async_wait<1>();
  chunk_cumsum(cum, a.t64, E);         // E, D, U are free until the factors
  // B_g: cum at the row before sub-chunk g (row -1: zero)
  auto bnd = [&](int g, int d) { return cum[(kSub * g - 1) * kLdR + d]; };
  const int wr = warp_rows(), wc = warp_cols();
  const int n_q = (valid + kTile - 1) / kTile;
  // out's rows take 8-byte stores of a column pair
  const bool pairs_out = (reinterpret_cast<uintptr_t>(out) & 7) == 0 &&
                         a.o_s % 2 == 0;
  const int dh8 = (a.dh + 7) & ~7;
  for (int qt = 0; qt < n_q; ++qt) {
    const int q0 = qt * kTile, q_valid = min(kTile, valid - q0);
    const int g0 = kNs * qt;           // the tile's first sub-chunk
    if (qt > 0) issue(q0);
    // the factors: rows [0, kNs) E, then kNs x kNs candidates (i, j) of D,
    // then kNs of U, then decR
    for (int e = threadIdx.x; e < (kNs * kNs + 2 * kNs + 1) * kTile;
         e += kThreads) {
      const int row = e >> 6, d = e & 63;
      if (row < kNs) {
        E[e] = decay_exp(bnd(g0 + row, d) - bnd(g0, d));
      } else if (row < kNs + kNs * kNs) {
        const int i = (row - kNs) / kNs, j = (row - kNs) % kNs;
        D[e - kNs * kTile] = j < i ? decay_exp(bnd(g0 + i, d) - bnd(g0 + j + 1, d))
                                   : 0.0f;
      } else if (row < 2 * kNs + kNs * kNs) {
        const int j = row - kNs - kNs * kNs;
        U[j * kTile + d] = decay_exp(bnd(g0 + kNs, d) - bnd(g0 + j + 1, d));
      } else {
        decR[d] = decay_exp(bnd(g0 + kNs, d) - bnd(g0, d));
      }
    }
    cp_async_wait<0>();
    __syncthreads();                   // the tile's copies and the factors
    // the bonus on the sub-chunks' diagonals, sum_d u r_t k_t, a row a
    // thread, and the pairwise scores inside them, a pair a thread: pair p
    // of sub-chunk i is (t, s) = (tl, sl) in row-major order of s < t
    if (threadIdx.x < kTile) {
      const int t = threadIdx.x, tl = t % kSub;
      const T* rt = Rr + t * kLdRaw;
      const T* kt = Kr + t * kLdRaw;
      float acc = 0.0f;
      for (int d = 0; d < dh8; d += 4) {
        const float4 rv = load4(rt + d), kv = load4(kt + d), uv = load4(us + d);
        acc = fmaf(rv.x * kv.x, uv.x, acc);
        acc = fmaf(rv.y * kv.y, uv.y, acc);
        acc = fmaf(rv.z * kv.z, uv.z, acc);
        acc = fmaf(rv.w * kv.w, uv.w, acc);
      }
      Pd[t * kSub + tl] = acc;
    }
    for (int p = threadIdx.x; p < kNs * kPairs; p += kThreads) {
      const int i = p / kPairs, pp = p - kPairs * i;
      const int tl = static_cast<int>((1.0f + sqrtf(8.0f * pp + 1.0f)) * 0.5f);
      const int sl = pp - tl * (tl - 1) / 2;
      const int t = kSub * i + tl, s = kSub * i + sl;
      const T* rt = Rr + t * kLdRaw;
      const T* ks = Kr + s * kLdRaw;
      const float* ct = cum + (q0 + t - 1) * kLdR;   // cumex_t
      const float* cs = cum + (q0 + s) * kLdR;
      float acc = 0.0f;
      for (int d = 0; d < dh8; d += 4) {
        const float4 rv = load4(rt + d), kv = load4(ks + d);
        const float4 cx = load4(ct + d), cy = load4(cs + d);
        acc = fmaf(rv.x * kv.x, decay_exp(cx.x - cy.x), acc);
        acc = fmaf(rv.y * kv.y, decay_exp(cx.y - cy.y), acc);
        acc = fmaf(rv.z * kv.z, decay_exp(cx.z - cy.z), acc);
        acc = fmaf(rv.w * kv.w, decay_exp(cx.w - cy.w), acc);
      }
      Pd[t * kSub + sl] = acc;
    }
    // q = r o exp(cumex_t - B_i) and kk = k o exp(B_j+1 - cum_s), read
    // into registers, then written over the raw values
    float xq[kTileElems / kThreads], xk[kTileElems / kThreads];
#pragma unroll
    for (int i = 0; i < kTileElems / kThreads; ++i) {
      const int e = threadIdx.x + kThreads * i, t = e >> 6, d = e & 63;
      xq[i] = to_f32(Rr[t * kLdRaw + d]) *
              decay_exp(cum[(q0 + t - 1) * kLdR + d] - bnd(g0 + t / kSub, d));
      xk[i] = to_f32(Kr[t * kLdRaw + d]) *
              decay_exp(bnd(g0 + t / kSub + 1, d) - cum[(q0 + t) * kLdR + d]);
    }
    __syncthreads();                   // every raw r and k is read
#pragma unroll
    for (int i = 0; i < kTileElems / kThreads; ++i) {
      const int e = threadIdx.x + kThreads * i, t = e >> 6, d = e & 63;
      Qh[t * kLdR + d] = xq[i];
      Kh[t * kLdR + d] = xk[i];
    }
    __syncthreads();
    // the state: (q_t o exp(B_i - cum_{q0-1})) R, the warp's rows being
    // sub-chunk wr
    float acc[16] = {};
    const float* e_i = E + wr * kTile;
    warp_mma<4, false>(acc, 16 * wr, 32 * wc, dh8,
                       [&](int t, int d) { return Qh[t * kLdR + d] * e_i[d]; },
                       [&](int d, int e) { return R[d * kLdC + e]; });
    // the scores of the warp's two key sub-chunks 2 wc, 2 wc + 1 that lie
    // before its own; held until every warp has read q
    float p[16] = {};
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 2 * wc + half;
      if (j >= wr) continue;
      const float* d_ij = D + (kNs * wr + j) * kTile;
      warp_mma<2, false>(p + 8 * half, 16 * wr, kSub * j, dh8,
                         [&](int t, int d) { return Qh[t * kLdR + d] * d_ij[d]; },
                         [&](int d, int s) { return Kh[s * kLdR + d]; });
    }
    __syncthreads();                   // every read of q is done
    float* P = Qh;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int t = acc_row(i), s = acc_col(i);
      const int j = s / kSub, tl = t % kSub, sl = s % kSub;
      P[t * kLdR + s] = j < wr ? p[i]
                               : j == wr && sl <= tl ? Pd[t * kSub + sl]
                                                     : 0.0f;
    }
    __syncthreads();
    // the scores (zero past the warp's sub-chunk) times v
    warp_mma<4, !kF32>(acc, 16 * wr, 32 * wc, kSub * (wr + 1),
                       [&](int t, int s) { return P[t * kLdR + s]; },
                       [&](int s, int e) { return to_f32(Vs[s * kLdC + e]); });
#pragma unroll
    for (int i = 0; i < 16; i += 2) {  // columns e, e + 1 of row t
      const int t = acc_row(i), e = acc_col(i);
      float* o = out + static_cast<int64_t>(q0 + t) * a.o_s + e;
      if (t >= q_valid || e >= a.dh) continue;
      if (pairs_out && e + 1 < a.dh) {
        *reinterpret_cast<float2*>(o) = make_float2(acc[i], acc[i + 1]);
      } else {
        o[0] = acc[i];
        if (e + 1 < a.dh) o[1] = acc[i + 1];
      }
    }
    if (qt + 1 == n_q) break;
    // R = diag(exp(cum_q1 - cum_{q0-1})) R + (kk o exp(cum_q1 - B_j+1))^T v;
    // every read of R (the state's product) is behind the last barrier
    float upd[16] = {};
    warp_mma<4, !kF32>(upd, 16 * wr, 32 * wc, kTile,
                       [&](int d, int s) {
                         return Kh[s * kLdR + d] * U[(s / kSub) * kTile + d];
                       },
                       [&](int s, int e) { return to_f32(Vs[s * kLdC + e]); });
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      float* rv = R + acc_row(i) * kLdC + acc_col(i);
      *rv = decR[acc_row(i)] * *rv + upd[i];
    }
    __syncthreads();                   // R is new; Qh, Kh, Vs are free
  }
}

// shared memory of each kernel, in bytes
size_t smem_state(int t64, int vbytes) {
  return (static_cast<size_t>(t64 + 1) * kLdR + kColTile + 4 * kTile) *
             sizeof(float) +
         static_cast<size_t>(kColTile) * vbytes +
         (vbytes == 2 ? static_cast<size_t>(kTileElems) * vbytes : 0);
}
size_t smem_out(int t64, int vbytes) {
  return (static_cast<size_t>(t64 + 1) * kLdR + 2 * kRowTile + kColTile +
          kNs * kSub * kSub + (2 * kNs + kNs * kNs + 2) * kTile) *
             sizeof(float) +
         static_cast<size_t>(kColTile) * vbytes;
}

// the workspace's parts, in floats, each a multiple of 64
struct Workspace {
  int64_t st, decay;
};

Workspace workspace(int B, int H, int S, int dh, int chunk) {
  const int64_t nc = (static_cast<int64_t>(S) + chunk - 1) / chunk;
  const int64_t bhc = static_cast<int64_t>(B) * H * nc;
  auto up = [](int64_t v) { return (v + 63) / 64 * 64; };
  return {up(bhc * dh * dh), up(bhc * dh)};
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch(const WkvArgs& a, int B, cudaStream_t s) {
  const size_t sm_state = smem_state(a.t64, sizeof(T));
  const size_t sm_out = smem_out(a.t64, sizeof(T));
  if (sm_state > static_cast<size_t>(kMaxSmem) ||
      sm_out > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (a.nc > 0) {
    if ((err = allow_smem(wkv6_chunk_state<T>, sm_state)) != cudaSuccess ||
        (err = allow_smem(wkv6_chunk_out<T>, sm_out)) != cudaSuccess)
      return static_cast<int>(err);
    wkv6_chunk_state<T><<<dim3(a.nc, a.H, B), kThreads, sm_state, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  wkv6_state_pass<<<dim3((a.dh * a.dh + kThreads - 1) / kThreads, a.H, B),
                    kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (a.nc > 0) {
    wkv6_chunk_out<T><<<dim3(a.nc, a.H, B), kThreads, sm_out, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of device memory repro_wkv6_chunked needs as its workspace.
size_t repro_wkv6_workspace_bytes(int B, int H, int S, int dh, int chunk) {
  if (B < 1 || H < 1 || S < 1 || dh < 1 || chunk < 1) return 0;
  const Workspace w = workspace(B, H, S, dh, chunk);
  return static_cast<size_t>(w.st + w.decay) * sizeof(float);
}

// r, k, v: (B, H, S, dh) of dtype `dtype` with element strides (b, h, s) and
// a dense last dim; lw: (B, H, S, dh) f32, the same kind of strides; u:
// (H, dh) f32 contiguous; out: (B, H, S, dh) f32, strides (b, h, s);
// state_in (or null) and state_out: (B, H, dh, dh) f32 contiguous;
// workspace: repro_wkv6_workspace_bytes(...) bytes of device memory,
// 16-byte aligned. dh at most 64; the chunk at most what the shared memory
// holds (T x 64 floats of its cumsum: a few hundred steps). Launches the
// three kernels on `stream`; returns the first cudaError_t (0 on success).
int repro_wkv6_chunked(const void* r, int64_t r_b, int64_t r_h, int64_t r_s,
                       const void* k, int64_t k_b, int64_t k_h, int64_t k_s,
                       const void* v, int64_t v_b, int64_t v_h, int64_t v_s,
                       const void* lw, int64_t lw_b, int64_t lw_h,
                       int64_t lw_s, const void* u, const void* state_in,
                       void* out, int64_t o_b, int64_t o_h, int64_t o_s,
                       void* state_out, int B, int H, int S, int dh,
                       int chunk, int dtype, void* workspace_ptr,
                       void* stream) {
  if (dh < 1 || dh > kTile || chunk < 1 || chunk > kMaxSmem || B < 0 ||
      H < 0 || S < 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  WkvArgs a;
  a.r = r; a.r_b = r_b; a.r_h = r_h; a.r_s = r_s;
  a.k = k; a.k_b = k_b; a.k_h = k_h; a.k_s = k_s;
  a.v = v; a.v_b = v_b; a.v_h = v_h; a.v_s = v_s;
  a.lw = static_cast<const float*>(lw);
  a.lw_b = lw_b; a.lw_h = lw_h; a.lw_s = lw_s;
  a.u = static_cast<const float*>(u);
  a.state_in = static_cast<const float*>(state_in);
  a.out = static_cast<float*>(out); a.o_b = o_b; a.o_h = o_h; a.o_s = o_s;
  a.state_out = static_cast<float*>(state_out);
  a.H = H; a.S = S; a.dh = dh; a.chunk = chunk;
  a.nc = (S + chunk - 1) / chunk;
  a.t64 = (chunk + kTile - 1) / kTile * kTile;
  const Workspace w = workspace(B, H, S, dh, chunk);
  a.st = static_cast<float*>(workspace_ptr);
  a.decay = a.st + w.st;
  if (a.nc > 0 && workspace_ptr == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: return launch<float>(a, B, st);
    case BF16: return launch<__nv_bfloat16>(a, B, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
