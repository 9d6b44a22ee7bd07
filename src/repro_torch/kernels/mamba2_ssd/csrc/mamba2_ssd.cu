// Mamba-2 SSD chunk scan for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (src/repro_torch/kernels/mamba2_ssd/mamba2_ssd.py).
//
// Replaces the Pallas kernel src/repro/kernels/mamba2_ssd/mamba2_ssd.py
// _ssd_kernel (K6). Per (batch b, head h), over chunks of T steps in order,
// with the (dh x N) f32 state S0 carried from chunk to chunk:
//   cum  = cumsum(lw) over the chunk                      (inclusive)
//   y_t  = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) x_s  (intra-chunk)
//        + exp(cum_t) C_t S0^T                            (inter-chunk)
//   S1   = exp(cum_T) S0 + sum_s exp(cum_T - cum_s) x_s B_s^T
// x is already dt-weighted and lw = dt * A <= 0. A ragged last chunk is
// padded with identity steps (x = 0, lw = 0, B = C = 0), which is what the
// Pallas kernel's jnp.pad does; here the loads mask the rows past S. Unlike
// the Pallas kernel, this one starts from a given state (or zero) and writes
// the final state, which prefill hands to decode.
//
// Bound on an H100: the f32 FMAs. Per chunk and head the intra-chunk term
// needs T(T+1)/2 (N + dh) FMAs and the inter-chunk term and the state
// update T dh N each; at zamba2-1.2b's widths (H 64, dh 64, N 64, T 256)
// that is 6.3M FMAs per chunk and head against 0.5 MB moved, ~25 FMAs per
// byte, above the card's f32 ridge (67 TFLOP/s over 3.35 TB/s is 10 flops
// per byte). TF32 tensor cores are not used: their ~1e-3 relative error
// would break the 1e-4 tolerance the reference holds its kernel to.
//
// Design, the simple one: one 256-thread block per (b, h), chunks in order
// inside it. The chunk's rows are cut into 64-row tiles so that a chunk of
// 256 never needs its (T x T) C B^T in shared memory (256 KB): for each
// query tile, the key tiles at or below it are loaded in turn, the
// 64 x 64 tile G = (C B^T o L) is formed in shared memory and multiplied
// into the query tile's outputs, which each thread keeps as a 4 x 4 block
// in registers (rows ty + 16 i, columns tx + 16 j). The tiles are the same
// arithmetic as the chunk-256 algorithm, only blocked. The state stays in
// shared memory across chunks. Tiles have a row stride of 65 floats so that
// the column walks of B and S0 hit 32 distinct banks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // rows of a tile; also the largest dh and N
constexpr int kLd = kTile + 1;   // row stride of a tile in shared memory
constexpr int kThreads = 256;    // 16 x 16 threads, a 4 x 4 block each
constexpr int kTileFloats = kTile * kLd;
constexpr int kMaxSmem = 232448; // bytes a block may use on an H100

struct SsdArgs {
  const float* x;  int64_t x_b, x_h, x_s;    // (B, H, S, dh), dense last dim
  const float* lw; int64_t lw_b, lw_h, lw_s; // (B, H, S)
  const float* bm; int64_t bm_b, bm_s;       // (B, S, N), dense last dim
  const float* cm; int64_t cm_b, cm_s;       // (B, S, N), dense last dim
  const float* state_in;                     // (B, H, dh, N) or null (zero)
  float* y;        int64_t y_b, y_h, y_s;    // (B, H, S, dh), dense last dim
  float* state_out;                          // (B, H, dh, N)
  int H, S, dh, n, chunk;
};

// rows of a (rows x width) matrix with row stride ld into a 64 x 64 tile,
// zero at rows >= nrows and columns >= width
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t ld, int nrows, int width) {
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int r = e >> 6, c = e & 63;
    dst[r * kLd + c] = (r < nrows && c < width) ? src[r * ld + c] : 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads) ssd_chunk_kernel(SsdArgs a) {
  extern __shared__ float smem[];
  float* Ct = smem;                // C of the query tile    [t][n]
  float* Bt = Ct + kTileFloats;    // B of the key tile      [s][n]
  float* Xt = Bt + kTileFloats;    // x of the key tile      [s][d]
  float* G = Xt + kTileFloats;     // (C B^T o L) tile       [t][s]
  float* St = G + kTileFloats;     // the state              [d][n]
  float* cum = St + kTileFloats;   // cumsum of lw over the chunk [T]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* x = a.x + b * a.x_b + h * a.x_h;
  const float* lw = a.lw + b * a.lw_b + h * a.lw_h;
  const float* bm = a.bm + b * a.bm_b;
  const float* cm = a.cm + b * a.cm_b;
  float* y = a.y + b * a.y_b + h * a.y_h;
  const int64_t s_off = (static_cast<int64_t>(b) * a.H + h) * a.dh * a.n;

  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int d = e >> 6, c = e & 63;
    St[d * kLd + c] = (a.state_in != nullptr && d < a.dh && c < a.n)
                          ? a.state_in[s_off + d * a.n + c] : 0.0f;
  }
  const int T = a.chunk;
  const int n_tiles = (T + kTile - 1) / kTile;
  const int n_chunks = (a.S + T - 1) / T;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * T;
    __syncthreads();               // the last chunk is done with cum and St
    for (int t = threadIdx.x; t < T; t += kThreads)
      cum[t] = (c0 + t < a.S) ? lw[static_cast<int64_t>(c0 + t) * a.lw_s]
                              : 0.0f;
    __syncthreads();
    if (threadIdx.x == 0) {        // in order, as a sequential cumsum
      float acc = 0.0f;
      for (int t = 0; t < T; ++t) {
        acc += cum[t];
        cum[t] = acc;
      }
    }
    for (int qt = 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile;
      const int q_rows = min(kTile, T - q0);            // rows in the chunk
      const int q_valid = min(q_rows, a.S - (c0 + q0)); // rows before S
      float acc[4][4] = {};
      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * kTile;
        const int k_rows = min(kTile, T - k0);
        const int k_valid = min(k_rows, a.S - (c0 + k0));
        __syncthreads();           // the last tile is done with Bt, Xt, G
        if (kt == 0)
          load_tile(Ct, cm + static_cast<int64_t>(c0 + q0) * a.cm_s, a.cm_s,
                    q_valid, a.n);
        load_tile(Bt, bm + static_cast<int64_t>(c0 + k0) * a.bm_s, a.bm_s,
                  k_valid, a.n);
        load_tile(Xt, x + static_cast<int64_t>(c0 + k0) * a.x_s, a.x_s,
                  k_valid, a.dh);
        __syncthreads();
        // G[t][s] = (C_t . B_s) exp(cum_t - cum_s) for s <= t, else 0
        float g[4][4] = {};
        for (int nn = 0; nn < a.n; ++nn) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Ct[(ty + 16 * i) * kLd + nn];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bt[(tx + 16 * j) * kLd + nn];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ti = ty + 16 * i, sj = tx + 16 * j;
            const bool keep = ti < q_rows && sj < k_rows && k0 + sj <= q0 + ti;
            G[ti * kLd + sj] =
                keep ? g[i][j] * expf(cum[q0 + ti] - cum[k0 + sj]) : 0.0f;
          }
        }
        __syncthreads();
        for (int s = 0; s < kTile; ++s) {
          float gv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) gv[i] = G[(ty + 16 * i) * kLd + s];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = Xt[s * kLd + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(gv[i], xv[j], acc[i][j]);
        }
      }
      // inter-chunk: y_t += exp(cum_t) (C_t S0^T)
      float z[4][4] = {};
      for (int nn = 0; nn < a.n; ++nn) {
        float cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Ct[(ty + 16 * i) * kLd + nn];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = St[(tx + 16 * j) * kLd + nn];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) z[i][j] = fmaf(cv[i], sv[j], z[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ti = ty + 16 * i;
        if (ti >= q_valid) continue;
        const float e = expf(cum[q0 + ti]);
        float* yr = y + static_cast<int64_t>(c0 + q0 + ti) * a.y_s;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int d = tx + 16 * j;
          if (d < a.dh) yr[d] = acc[i][j] + e * z[i][j];
        }
      }
    }
    // S1[d][n] = exp(cum_T) S0[d][n] + sum_s x_s[d] exp(cum_T - cum_s) B_s[n]
    const float cum_t = cum[T - 1];
    float sacc[4][4] = {};
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * kTile;
      const int k_valid = min(min(kTile, T - k0), a.S - (c0 + k0));
      __syncthreads();             // every reader of Bt, Xt and St is done
      load_tile(Bt, bm + static_cast<int64_t>(c0 + k0) * a.bm_s, a.bm_s,
                k_valid, a.n);
      for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
        const int r = e >> 6, c = e & 63;
        Xt[r * kLd + c] =
            (r < k_valid && c < a.dh)
                ? x[static_cast<int64_t>(c0 + k0 + r) * a.x_s + c] *
                      expf(cum_t - cum[k0 + r])
                : 0.0f;
      }
      __syncthreads();
      for (int s = 0; s < kTile; ++s) {
        float xv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = Xt[s * kLd + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bt[s * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sacc[i][j] = fmaf(xv[i], bv[j], sacc[i][j]);
      }
    }
    const float p_t = expf(cum_t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* sp = St + (ty + 16 * i) * kLd + tx + 16 * j;
        *sp = p_t * *sp + sacc[i][j];
      }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int d = e >> 6, c = e & 63;
    if (d < a.dh && c < a.n) a.state_out[s_off + d * a.n + c] = St[d * kLd + c];
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, y: (B, H, S, dh) f32 with element strides (b, h, s) and a dense last
// dim; lw: (B, H, S) f32, strides (b, h, s); bm, cm: (B, S, N) f32, strides
// (b, s) and a dense last dim; state_in (or null) and state_out: (B, H, dh,
// N) f32 contiguous. dh and N at most 64. Launches on `stream`; returns the
// launch's cudaError_t (0 on success).
int repro_ssd_chunked(const void* x, int64_t x_b, int64_t x_h, int64_t x_s,
                      const void* lw, int64_t lw_b, int64_t lw_h,
                      int64_t lw_s, const void* bm, int64_t bm_b,
                      int64_t bm_s, const void* cm, int64_t cm_b,
                      int64_t cm_s, const void* state_in, void* y,
                      int64_t y_b, int64_t y_h, int64_t y_s, void* state_out,
                      int B, int H, int S, int dh, int n, int chunk,
                      void* stream) {
  if (dh < 1 || dh > kTile || n < 1 || n > kTile || chunk < 1 || B < 0 ||
      H < 0 || S < 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (5 * kTileFloats + chunk) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
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
  ssd_chunk_kernel<<<dim3(H, B), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
