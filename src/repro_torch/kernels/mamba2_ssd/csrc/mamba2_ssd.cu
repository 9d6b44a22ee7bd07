// Mamba-2 SSD chunk scan for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (src/repro_torch/kernels/mamba2_ssd/mamba2_ssd.py).
//
// Replaces the Pallas kernel src/repro/kernels/mamba2_ssd/mamba2_ssd.py
// _ssd_kernel (K6). Per (batch b, head h), over chunks of T steps, with the
// (dh x N) f32 state S carried from chunk to chunk:
//   cum  = cumsum(lw) over the chunk                      (inclusive)
//   y_t  = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) x_s  (intra-chunk)
//        + exp(cum_t) C_t S^T                             (inter-chunk)
//   S'   = exp(cum_T) S + sum_s exp(cum_T - cum_s) x_s B_s^T
// x is already dt-weighted and lw = dt * A <= 0. A ragged last chunk is
// padded with identity steps (x = 0, lw = 0, B = C = 0), which is what the
// Pallas kernel's jnp.pad does; here the loads mask the rows past S. Unlike
// the Pallas kernel, this one starts from a given state (or zero) and writes
// the final state, which prefill hands to decode.
//
// Bound on an H100: the f32 FMAs. At zamba2-1.2b's serving shape (B 4, H 64,
// S 2,000, dh = N = 64, T 256) the chunked form below does about 9.7G
// multiply-adds (0.29 ms at the 67 TFLOP/s of f32 FMAs); chip_smoke.scan_bound
// counts what the sequential recurrence needs, 2.1G FMAs (0.125 ms), and
// its inputs and outputs, ~0.27 GB (0.081 ms at 3.35 TB/s). The four kernels
// below move ~0.53 GB (x read twice, y, the state scratch four times:
// 0.16 ms). The products run on the tensor cores in split TF32 ("3xTF32",
// CUTLASS's fast f32): each f32 operand x is hi = rna_tf32(x) plus lo =
// x - hi (exact in f32; the tensor core reads lo's top 11 significant bits),
// and a product is lo_a hi_b + hi_a lo_b + hi_a hi_b, accumulated in f32.
// What is dropped (lo_a lo_b, lo's last bits) is ~2^-21 relative, where one
// TF32 product (~1e-3) would break the 1e-4 tolerance the reference holds
// its kernel to. The decay mask and exponentials are applied in f32 before
// the split.
//
// Design: the four steps of the SSD algorithm (Mamba-2, arXiv:2405.21060,
// sec. 6-7), each a kernel, launched in order on the caller's stream, with
// their intermediates in a workspace the caller allocates
// (repro_ssd_workspace_bytes):
//  1. ssd_cb, one block per (b, chunk, 64-row tile): the tile's diagonal
//     block of C B^T, computed once for all H heads (B and C have no head
//     axis), kept transposed ([s][t]), and the tile's C^T ([n][t]).
//  2. ssd_chunk_state, one block per (b, h, chunk): the chunk's inclusive
//     cum (a block-wide scan: per-thread runs, then warp shuffles), kept
//     for step 4; exp(cum_T); and the chunk's own state
//     dS = sum_s exp(cum_T - cum_s) x_s B_s^T, kept transposed (N x dh),
//     over 64-row key tiles, the next tile's copy in flight while this one
//     is multiplied.
//  3. ssd_state_pass, one thread per (b, h, n, d): S_c = exp(cum_T,c)
//     S_{c-1} + dS_c in chunk order, from state_in or zero, 8 chunks' loads
//     in flight at a time. Each chunk's entering state overwrites its dS;
//     the last S is state_out (state_in and state_out, dh x N, are read
//     and written across their rows: 1 MB each at the serving shape).
//  4. ssd_chunk_scan, one block per (b, h, chunk): the chunk's 64-row
//     tiles in order, with the state R entering each tile carried in
//     shared memory (R_0 = S_{c-1}): with r = cum of the row before the
//     tile (0 for the first) and q1 the tile's last row,
//       y_t     = exp(cum_t - r) C_t R^T + sum_{s<=t in the tile}
//                 (C_t . B_s) exp(cum_t - cum_s) x_s
//       R_next  = exp(cum_q1 - r) R + sum_{s in the tile}
//                 exp(cum_q1 - cum_s) B_s x_s^T
//     the SSD recurrence itself at 64-step granularity (every factor <= 1:
//     cum never rises), so a tile costs three products (the carried state,
//     the causal diagonal, the update) and no tile of the chunk below the
//     diagonal is read. The next tile's C^T and C B^T are copied in while
//     the update is multiplied.
// Every product is a 64 x 64 output tile on 8 warps, each a 16 x 32 strip:
// per 8 steps of k, four mma.sync.m16n8k8 TF32 tiles, three mmas each,
// with fragments read from shared tiles stored k-major with a row stride
// of 72 floats (8 q + g: a fragment load hits 32 distinct banks; the
// inline PTX is in small functions between the ptx:begin and ptx:end
// lines, for which tools/cuda_shim stands in). Tiles are copied with
// cp.async (no registers held, zero fill past the edges, 16 bytes a copy
// where the rows allow); step 2 double-buffers its key tiles.
//
// N up to 128 (granite-4.0-h-small's d_state, at dh 64): the three tiled
// kernels are templates on kNT, the 64-wide tiles of N (1: N <= 64, the
// code zamba2 runs; 2: N <= 128), chosen once a call. The state dimension
// is a product's depth in steps 1 and 4 (C B^T, C R^T: tiles of 64 kNT
// rows, K = N) and an output width in steps 2 and 4 (dS and the tile's
// update, computed transposed as x^T diag(w) B, kNT output tiles side by
// side sharing each x fragment); so x is read once and y written once
// whatever N is, and the workspace's C^T tiles and states grow with N.
// At kNT = 2 step 4 holds 8 tiles (146 KB), one block an SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // rows of a tile; also the largest dh
constexpr int kMaxNT = 2;        // 64-wide tiles of N: N at most 128
constexpr int kLd = 72;          // row stride of a tile in shared memory
constexpr int kThreads = 256;    // 8 warps, a 16 x 32 strip of a tile each
constexpr int kTileFloats = kTile * kLd;
constexpr int kTileElems = kTile * kTile;
constexpr int kMaxSmem = 232448; // bytes a block may use on an H100

struct SsdArgs {
  const float* x;  int64_t x_b, x_h, x_s;    // (B, H, S, dh), dense last dim
  const float* lw; int64_t lw_b, lw_h, lw_s; // (B, H, S)
  const float* bm; int64_t bm_b, bm_s;       // (B, S, N), dense last dim
  const float* cm; int64_t cm_b, cm_s;       // (B, S, N), dense last dim
  const float* state_in;                     // (B, H, dh, N) or null (zero)
  float* y;        int64_t y_b, y_h, y_s;    // (B, H, S, dh), dense last dim
  float* state_out;                          // (B, H, dh, N)
  float* cb;       // (B, nc, n_tiles, 64, 64): diagonal C B^T tiles, [s][t]
  float* ct;       // (B, nc, n_tiles, 64 kNT, 64): C^T tiles, [n][t]
  float* cum;      // (B, H, nc, T): cumsum of lw in each chunk
  float* st;       // (B, H, nc, N, dh): dS, then each chunk's entering state
  float* decay;    // (B, H, nc): exp(cum_T)
  int H, S, dh, n, chunk, nc, n_tiles;
};

// element e of a tile copied transposed: a warp reads 4 columns of 8 rows,
// so its stores hit 32 distinct banks
__device__ __forceinline__ int t_row(int e) { return (e >> 2) & 63; }
__device__ __forceinline__ int t_col(int e) { return ((e >> 8) << 2) | (e & 3); }

// ptx:begin -- the tensor-core and async-copy statements, one each
// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero),
// the bits below it zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// asynchronous copies global -> shared of 4 or 16 bytes, of which `bytes`
// are read (0: zero fill, nothing read); a group is committed, then waited
// for while at most N younger groups stay in flight
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
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

// cp.async copies of a 64 x 64 tile into dst (row stride kLd): rows [0,
// rows) and columns [0, width) of src (row stride ld), zero elsewhere,
// stored as they are (copy_tile; 16 bytes a copy where src, ld and width
// allow) or transposed (copy_tile_t); or a dense 64 x 64 block of the
// workspace (copy_dense_tile, 16 bytes a copy)
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          int64_t ld, int rows, int width) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (ld & 3) == 0 &&
      (width & 3) == 0) {
#pragma unroll
    for (int i = 0; i < kTileElems / (4 * kThreads); ++i) {
      const int e = threadIdx.x + kThreads * i, r = e >> 4, c = 4 * (e & 15);
      const bool in = r < rows && c < width;
      cp_async16(dst + r * kLd + c, in ? src + r * ld + c : src, in ? 16 : 0);
    }
    return;
  }
#pragma unroll 4
  for (int i = 0; i < kTileElems / kThreads; ++i) {
    const int e = threadIdx.x + kThreads * i, r = e >> 6, c = e & 63;
    const bool in = r < rows && c < width;
    cp_async4(dst + r * kLd + c, in ? src + r * ld + c : src, in ? 4 : 0);
  }
}
__device__ __forceinline__ void copy_tile_t(float* dst, const float* src,
                                            int64_t ld, int rows, int width) {
#pragma unroll 4
  for (int i = 0; i < kTileElems / kThreads; ++i) {
    const int e = threadIdx.x + kThreads * i, r = t_row(e), c = t_col(e);
    const bool in = r < rows && c < width;
    cp_async4(dst + c * kLd + r, in ? src + r * ld + c : src, in ? 4 : 0);
  }
}
__device__ __forceinline__ void copy_dense_tile(float* dst, const float* src) {
#pragma unroll
  for (int i = 0; i < kTileElems / (4 * kThreads); ++i) {
    const int e = threadIdx.x + kThreads * i, r = e >> 4, c = 4 * (e & 15);
    cp_async16(dst + r * kLd + c, src + r * kTile + c, 16);
  }
}

// x = hi + lo: hi rounded to TF32, lo = x - hi exact in f32 (the tensor
// core reads its top 11 significant bits: at most ~2^-22 of x is dropped)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// acc += A^T diag(kscale) B over k < K (rounded up to 8; the tiles are
// zero there, kscale finite) for a 64 x 64 output tile, with A and B
// stored k-major (A[k][m], B[k][n]); kScaled false: no kscale. The scale
// goes on A's fragment, which has half as many values a lane as B's.
// kLower: A is zero at k > m (a causal diagonal tile), so a warp stops
// at k = its last row + 1. kNB: B is kNB tiles kTileFloats apart, the
// output kNB tiles side by side (acc[16 j + v]: tile j), each A fragment
// split once for all of them.
// Warp w owns rows 16 (w % 4) + [0, 16) and columns 32 (w / 4) + [0, 32):
// four m16n8 tiles, value v of a thread is row acc_row(v), column
// acc_col(v) (the mma's d fragment of tile v / 4).
__device__ __forceinline__ int acc_row(int v) {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) +
         8 * ((v >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int v) {
  return 32 * (threadIdx.x >> 7) + 8 * (v >> 2) + 2 * (threadIdx.x & 3) +
         (v & 1);
}
template <bool kScaled = false, bool kLower = false, int kNB = 1>
__device__ __forceinline__ void tile_product(float (&acc)[16 * kNB],
                                             const float* A, const float* B,
                                             int K,
                                             const float* kscale = nullptr) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (kLower) K = min(K, 16 * (w & 3) + 16);
  const float* a = A + (lane & 3) * kLd + 16 * (w & 3) + (lane >> 2);
  const float* b = B + (lane & 3) * kLd + 32 * (w >> 2) + (lane >> 2);
  for (int k = 0; k < K; k += 8) {
    const float s0 = kScaled ? kscale[k + (lane & 3)] : 1.0f;
    const float s1 = kScaled ? kscale[k + 4 + (lane & 3)] : 1.0f;
    uint32_t ah[4], al[4];
    split_tf32(a[k * kLd] * s0, ah[0], al[0]);
    split_tf32(a[k * kLd + 8] * s0, ah[1], al[1]);
    split_tf32(a[(k + 4) * kLd] * s1, ah[2], al[2]);
    split_tf32(a[(k + 4) * kLd + 8] * s1, ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < 4 * kNB; ++j) {
      const float* bj = b + (j >> 2) * kTileFloats + 8 * (j & 3);
      uint32_t bh[2], bl[2];
      split_tf32(bj[k * kLd], bh[0], bl[0]);
      split_tf32(bj[(k + 4) * kLd], bh[1], bl[1]);
      mma_tf32(acc + 4 * j, al, bh);     // the small terms first
      mma_tf32(acc + 4 * j, ah, bl);
      mma_tf32(acc + 4 * j, ah, bh);
    }
  }
}

// in-place inclusive prefix sum of v[0, T) over the block: each thread sums
// a run of ceil(T / kThreads), the runs' totals are scanned with warp
// shuffles and across the 8 warps through warp_tot, then each run is
// rewritten. Starts and ends with every thread past a __syncthreads.
__device__ void block_cumsum(float* v, int T, float* warp_tot) {
  const int per = (T + kThreads - 1) / kThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, T);
  const int hi = min(lo + per, T);
  float run = 0.0f;
  for (int i = lo; i < hi; ++i) run += v[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  float acc = incl - run;
  for (int w = 0; w < warp; ++w) acc += warp_tot[w];
  for (int i = lo; i < hi; ++i) {
    acc += v[i];
    v[i] = acc;
  }
  __syncthreads();
}

// step 1: tile qt of chunk c: its diagonal block of C B^T, transposed,
// out[s][t] = C_{q0+t} . B_{q0+s}, zero past the chunk's rows, and C^T
template <int kNT>
__global__ void __launch_bounds__(kThreads) ssd_cb(SsdArgs a) {
  extern __shared__ float smem[];
  float* Bt = smem;                // B^T of the tile's rows [n][s]
  float* Ct = Bt + kNT * kTileFloats;  // C^T of the tile's rows [n][t]
  const int qt = blockIdx.x % a.n_tiles, c = blockIdx.x / a.n_tiles;
  const int b = blockIdx.y;
  const int c0 = c * a.chunk, q0 = qt * kTile;
  const int valid = min(a.chunk, a.S - c0);
  if (q0 >= valid) return;         // rows past S: step 4 never reads them
  const int rows = min(kTile, valid - q0);
  const int64_t row0 = static_cast<int64_t>(c0 + q0);
#pragma unroll
  for (int j = 0; j < kNT; ++j) {  // columns [64 j, 64 j + 64) of B and C
    const int w = min(kTile, a.n - kTile * j);
    copy_tile_t(Bt + j * kTileFloats,
                a.bm + b * a.bm_b + row0 * a.bm_s + kTile * j, a.bm_s, rows,
                w);
    copy_tile_t(Ct + j * kTileFloats,
                a.cm + b * a.cm_b + row0 * a.cm_s + kTile * j, a.cm_s, rows,
                w);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int64_t tile = ((static_cast<int64_t>(b) * a.nc + c) * a.n_tiles + qt)
                       * kTileElems;
  float* ct = a.ct + tile * kNT;
  for (int e = threadIdx.x; e < kNT * kTileElems; e += kThreads)
    ct[e] = Ct[(e >> 6) * kLd + (e & 63)];
  float acc[16] = {};
  tile_product(acc, Bt, Ct, a.n);
#pragma unroll
  for (int v = 0; v < 16; ++v)
    a.cb[tile + acc_row(v) * kTile + acc_col(v)] = acc[v];
}

// step 2: the chunk's cum, exp(cum_T) and own state, transposed: dS[n][d]
template <int kNT>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_state(SsdArgs a) {
  extern __shared__ float smem[];
  float* Xs = smem;                // x of the key rows, two stages [s][d]
  float* Bs = Xs + 2 * kTileFloats;  // B of the key rows, two stages of kNT
                                     // tiles [s][n]
  float* warp_tot = Bs + 2 * kNT * kTileFloats;
  float* cum = warp_tot + 32;      // [T]
  float* w = cum + a.chunk;        // exp(cum_T - cum_s), zero past T
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int T = a.chunk, c0 = c * T;
  const int valid = min(T, a.S - c0);
  const int64_t bhc = (static_cast<int64_t>(b) * a.H + h) * a.nc + c;
  const float* x = a.x + b * a.x_b + h * a.x_h + static_cast<int64_t>(c0) * a.x_s;
  const float* bm = a.bm + b * a.bm_b + static_cast<int64_t>(c0) * a.bm_s;
  auto issue = [&](int k0, int stage) {
    const int rows = min(kTile, valid - k0);
    copy_tile(Xs + stage * kTileFloats, x + k0 * a.x_s, a.x_s, rows, a.dh);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      copy_tile(Bs + (stage * kNT + j) * kTileFloats,
                bm + k0 * a.bm_s + kTile * j, a.bm_s, rows,
                min(kTile, a.n - kTile * j));
    cp_async_commit();
  };
  issue(0, 0);                     // in flight during the scan
  const float* lw = a.lw + b * a.lw_b + h * a.lw_h;
  for (int t = threadIdx.x; t < T; t += kThreads)
    cum[t] = t < valid ? lw[static_cast<int64_t>(c0 + t) * a.lw_s] : 0.0f;
  __syncthreads();
  block_cumsum(cum, T, warp_tot);
  const float cum_T = cum[T - 1];
  float* cum_out = a.cum + bhc * T;
  const int T64 = (T + kTile - 1) / kTile * kTile;
  for (int t = threadIdx.x; t < T64; t += kThreads) {
    if (t < T) cum_out[t] = cum[t];
    w[t] = t < T ? expf(cum_T - cum[t]) : 0.0f;
  }
  if (threadIdx.x == 0) a.decay[bhc] = expf(cum_T);
  float acc[16 * kNT] = {};
  for (int k0 = 0, stage = 0; k0 < valid; k0 += kTile, stage ^= 1) {
    if (k0 + kTile < valid) {
      issue(k0 + kTile, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();               // this stage and w are in place
    tile_product<true, false, kNT>(acc, Xs + stage * kTileFloats,
                                   Bs + stage * kNT * kTileFloats,
                                   min(kTile, valid - k0), w + k0);
    __syncthreads();               // this stage is free again
  }
  float* out = a.st + bhc * a.n * a.dh;
#pragma unroll
  for (int v = 0; v < 16 * kNT; ++v) {
    const int d = acc_row(v & 15), nn = kTile * (v >> 4) + acc_col(v & 15);
    if (d < a.dh && nn < a.n) out[nn * a.dh + d] = acc[v];
  }
}

// step 3: the states in chunk order, one thread per element e = n dh + d
__global__ void __launch_bounds__(kThreads) ssd_state_pass(SsdArgs a) {
  const int nd = a.n * a.dh;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= nd) return;
  const int64_t bh = static_cast<int64_t>(blockIdx.z) * a.H + blockIdx.y;
  const int64_t at = bh * nd + (e % a.dh) * a.n + e / a.dh;   // (d, n)
  float s = a.state_in != nullptr ? a.state_in[at] : 0.0f;
  float* st = a.st + bh * a.nc * nd + e;
  const float* dec = a.decay + bh * a.nc;
  for (int c0 = 0; c0 < a.nc; c0 += 8) {
    float ds[8], dk[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      ds[i] = c0 + i < a.nc ? st[static_cast<int64_t>(c0 + i) * nd] : 0.0f;
      dk[i] = c0 + i < a.nc ? dec[c0 + i] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (c0 + i < a.nc) {
        st[static_cast<int64_t>(c0 + i) * nd] = s;  // entering chunk c0 + i
        s = dk[i] * s + ds[i];
      }
    }
  }
  a.state_out[at] = s;
}

// step 4: y of the chunk, a 64-row tile at a time, the state carried
template <int kNT>
__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_scan(SsdArgs a) {
  extern __shared__ float smem[];
  float* Ct = smem;                // C^T of the tile's rows         [n][t]
  float* G = Ct + kNT * kTileFloats;  // (C B^T)^T of the diagonal    [s][t]
  float* Xs = G + kTileFloats;     // x of the tile's rows            [s][d]
  float* Bs = Xs + kTileFloats;    // B of the tile's rows, kNT tiles [s][n]
  float* R = Bs + kNT * kTileFloats;  // the state entering the tile, ^T
                                      // [n][d], 64 kNT rows
  float* rowf = R + kNT * kTileFloats;  // exp(cum_t - r)             [64]
  float* wq = rowf + kTile;        // exp(cum_q1 - cum_s)             [64]
  float* cum = wq + kTile;         // [T]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int T = a.chunk, c0 = c * T;
  const int valid = min(T, a.S - c0);
  const int n_q = (valid + kTile - 1) / kTile;
  const int64_t bhc = (static_cast<int64_t>(b) * a.H + h) * a.nc + c;
  const float* x = a.x + b * a.x_b + h * a.x_h + static_cast<int64_t>(c0) * a.x_s;
  const float* bm = a.bm + b * a.bm_b + static_cast<int64_t>(c0) * a.bm_s;
  float* y = a.y + b * a.y_b + h * a.y_h + static_cast<int64_t>(c0) * a.y_s;
  const int64_t tiles = (static_cast<int64_t>(b) * a.nc + c) * a.n_tiles;
  auto issue_c = [&](int qt) {     // C^T and the diagonal's C B^T
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      copy_dense_tile(Ct + j * kTileFloats,
                      a.ct + ((tiles + qt) * kNT + j) * kTileElems);
    copy_dense_tile(G, a.cb + (tiles + qt) * kTileElems);
    cp_async_commit();
  };
  auto issue_xb = [&](int qt) {    // x and B of the tile's rows
    const int rows = min(kTile, valid - qt * kTile);
    copy_tile(Xs, x + qt * kTile * a.x_s, a.x_s, rows, a.dh);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      copy_tile(Bs + j * kTileFloats, bm + qt * kTile * a.bm_s + kTile * j,
                a.bm_s, rows, min(kTile, a.n - kTile * j));
    cp_async_commit();
  };
#pragma unroll
  for (int j = 0; j < kNT; ++j)
    copy_tile(R + j * kTileFloats, a.st + (bhc * a.n + kTile * j) * a.dh,
              a.dh, min(kTile, a.n - kTile * j), a.dh);
  issue_c(0);
  issue_xb(0);
  for (int t = threadIdx.x; t < T; t += kThreads) cum[t] = a.cum[bhc * T + t];
  __syncthreads();                 // cum is in place
  for (int qt = 0; qt < n_q; ++qt) {
    const int q0 = qt * kTile, q_valid = min(kTile, valid - q0);
    const int q1 = min(q0 + kTile, T) - 1;
    const float r = q0 > 0 ? cum[q0 - 1] : 0.0f;
    if (threadIdx.x < kTile) {
      const bool in = threadIdx.x < q_valid;
      rowf[threadIdx.x] = in ? expf(cum[q0 + threadIdx.x] - r) : 0.0f;
      wq[threadIdx.x] = in ? expf(cum[q1] - cum[q0 + threadIdx.x]) : 0.0f;
    }
    cp_async_wait<0>();
    __syncthreads();               // the tile's copies, R and the decays
#pragma unroll 4
    for (int i = 0; i < kTileElems / kThreads; ++i) {  // mask, decay
      const int e = threadIdx.x + kThreads * i, s = e >> 6, t = e & 63;
      float* g = G + s * kLd + t;
      *g = (s <= t && t < q_valid) ? *g * expf(cum[q0 + t] - cum[q0 + s])
                                   : 0.0f;
    }
    __syncthreads();
    float acc[16] = {};
    tile_product(acc, Ct, R, a.n);
#pragma unroll
    for (int v = 0; v < 16; ++v) acc[v] *= rowf[acc_row(v)];
    tile_product<false, true>(acc, G, Xs, q_valid);
#pragma unroll
    for (int v = 0; v < 16; ++v) {
      const int t = acc_row(v), d = acc_col(v);
      if (t < q_valid && d < a.dh)
        y[static_cast<int64_t>(q0 + t) * a.y_s + d] = acc[v];
    }
    if (qt + 1 == n_q) break;
    __syncthreads();               // Ct, G and R are read
    issue_c(qt + 1);
    const float decay = expf(cum[q1] - r);
    if constexpr (kNT == 1) {
      float upd[16] = {};          // B^T diag(exp(cum_q1 - cum_s)) x
      tile_product<true>(upd, Bs, Xs, q_valid, wq);
#pragma unroll
      for (int v = 0; v < 16; ++v) {
        float* rv = R + acc_row(v) * kLd + acc_col(v);
        *rv = decay * *rv + upd[v];
      }
    } else {
      float upd[16 * kNT] = {};    // its transpose, x^T diag(...) B: [d][n]
      tile_product<true, false, kNT>(upd, Xs, Bs, q_valid, wq);
#pragma unroll
      for (int v = 0; v < 16 * kNT; ++v) {
        float* rv = R + (kTile * (v >> 4) + acc_col(v & 15)) * kLd +
                    acc_row(v & 15);
        *rv = decay * *rv + upd[v];
      }
    }
    __syncthreads();               // Bs and Xs are read
    issue_xb(qt + 1);
  }
}

// the workspace's parts, in floats, each a multiple of 64
struct Workspace {
  int64_t cb, ct, cum, st, decay;
};

// 64-wide tiles of N
int n_tiles_of(int n) { return (n + kTile - 1) / kTile; }

Workspace workspace(int B, int H, int S, int dh, int n, int chunk) {
  const int64_t nc = (static_cast<int64_t>(S) + chunk - 1) / chunk;
  const int64_t tiles = (chunk + kTile - 1) / kTile;
  auto up = [](int64_t v) { return (v + 63) / 64 * 64; };
  return {up(B * nc * tiles * kTileElems),
          up(B * nc * tiles * n_tiles_of(n) * kTileElems),
          up(static_cast<int64_t>(B) * H * nc * chunk),
          up(static_cast<int64_t>(B) * H * nc * n * dh),
          up(static_cast<int64_t>(B) * H * nc)};
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// shared memory of the three tiled kernels at kNT tiles of N
struct Smem {
  size_t cb, state, scan;
};

Smem smem_bytes(int kNT, int chunk) {
  const size_t T64 = (static_cast<size_t>(chunk) + kTile - 1) / kTile * kTile;
  return {2 * kNT * kTileFloats * sizeof(float),
          (2 * (1 + kNT) * kTileFloats + 32 + chunk + T64) * sizeof(float),
          ((2 + 3 * kNT) * kTileFloats + 2 * kTile +
           static_cast<size_t>(chunk)) * sizeof(float)};
}

// the four kernels in order on stream s (a.nc > 0: steps 1, 2 and 4 too)
template <int kNT>
cudaError_t launch(const SsdArgs& a, int B, int H, int chunk,
                   cudaStream_t s) {
  const Smem m = smem_bytes(kNT, chunk);
  cudaError_t err;
  if (a.nc > 0) {
    if ((err = allow_smem(ssd_cb<kNT>, m.cb)) != cudaSuccess ||
        (err = allow_smem(ssd_chunk_state<kNT>, m.state)) != cudaSuccess ||
        (err = allow_smem(ssd_chunk_scan<kNT>, m.scan)) != cudaSuccess)
      return err;
    ssd_cb<kNT><<<dim3(a.n_tiles * a.nc, B), kThreads, m.cb, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    ssd_chunk_state<kNT><<<dim3(a.nc, H, B), kThreads, m.state, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  ssd_state_pass<<<dim3((a.n * a.dh + kThreads - 1) / kThreads, H, B),
                   kThreads, 0, s>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (a.nc > 0) {
    ssd_chunk_scan<kNT><<<dim3(a.nc, H, B), kThreads, m.scan, s>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of device memory repro_ssd_chunked needs as its workspace.
size_t repro_ssd_workspace_bytes(int B, int H, int S, int dh, int n,
                                 int chunk) {
  if (B < 1 || H < 1 || S < 1 || chunk < 1) return 0;
  const Workspace w = workspace(B, H, S, dh, n, chunk);
  return static_cast<size_t>(w.cb + w.ct + w.cum + w.st + w.decay) *
         sizeof(float);
}

// x, y: (B, H, S, dh) f32 with element strides (b, h, s) and a dense last
// dim; lw: (B, H, S) f32, strides (b, h, s); bm, cm: (B, S, N) f32, strides
// (b, s) and a dense last dim; state_in (or null) and state_out: (B, H, dh,
// N) f32 contiguous; workspace: repro_ssd_workspace_bytes(...) bytes of
// device memory, 16-byte aligned. dh at most 64, N at most 128. Launches
// the four kernels on `stream`; returns the first cudaError_t (0 on
// success).
int repro_ssd_chunked(const void* x, int64_t x_b, int64_t x_h, int64_t x_s,
                      const void* lw, int64_t lw_b, int64_t lw_h,
                      int64_t lw_s, const void* bm, int64_t bm_b,
                      int64_t bm_s, const void* cm, int64_t cm_b,
                      int64_t cm_s, const void* state_in, void* y,
                      int64_t y_b, int64_t y_h, int64_t y_s, void* state_out,
                      int B, int H, int S, int dh, int n, int chunk,
                      void* workspace_ptr, void* stream) {
  if (dh < 1 || dh > kTile || n < 1 || n > kMaxNT * kTile || chunk < 1 ||
      B < 0 || H < 0 || S < 0 || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = n_tiles_of(n);
  const Smem m = smem_bytes(nt, chunk);
  if (m.state > static_cast<size_t>(kMaxSmem) ||
      m.scan > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  const int tiles = (chunk + kTile - 1) / kTile;
  SsdArgs a;
  a.x = static_cast<const float*>(x); a.x_b = x_b; a.x_h = x_h; a.x_s = x_s;
  a.lw = static_cast<const float*>(lw);
  a.lw_b = lw_b; a.lw_h = lw_h; a.lw_s = lw_s;
  a.bm = static_cast<const float*>(bm); a.bm_b = bm_b; a.bm_s = bm_s;
  a.cm = static_cast<const float*>(cm); a.cm_b = cm_b; a.cm_s = cm_s;
  a.state_in = static_cast<const float*>(state_in);
  a.y = static_cast<float*>(y); a.y_b = y_b; a.y_h = y_h; a.y_s = y_s;
  a.state_out = static_cast<float*>(state_out);
  a.H = H; a.S = S; a.dh = dh; a.n = n; a.chunk = chunk;
  a.nc = (S + chunk - 1) / chunk;
  a.n_tiles = tiles;
  const Workspace w = workspace(B, H, S, dh, n, chunk);
  a.cb = static_cast<float*>(workspace_ptr);
  a.ct = a.cb + w.cb;
  a.cum = a.ct + w.ct;
  a.st = a.cum + w.cum;
  a.decay = a.st + w.st;
  if (a.nc > 0 && workspace_ptr == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(nt == 1 ? launch<1>(a, B, H, chunk, s)
                                  : launch<2>(a, B, H, chunk, s));
}

}  // extern "C"
