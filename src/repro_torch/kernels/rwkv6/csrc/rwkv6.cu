// RWKV-6 chunked WKV for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (src/repro_torch/kernels/rwkv6/rwkv6.py).
//
// Replaces the Pallas kernel src/repro/kernels/rwkv6/rwkv6.py _wkv_kernel
// (K7). Per (batch b, head h), over chunks of T steps in order, with the
// (dh x dh) f32 state S0 carried from chunk to chunk and per-channel
// log-decays lw < 0:
//   cum   = cumsum(lw) over the chunk (inclusive), cumex = cum - lw
//   out_t = sum_{s<t} [sum_d r_t[d] k_s[d] exp(cumex_t[d] - cum_s[d])] v_s
//         + (sum_d u[d] r_t[d] k_t[d]) v_t                  (the bonus)
//         + (r_t o exp(cumex_t)) S0                         (inter-chunk)
//   S1    = diag(exp(cum_T)) S0 + sum_s (k_s o exp(cum_T - cum_s))^T v_s
// r, k, v are read in their dtype (f32 or bf16) and widened to f32, as the
// Pallas kernel's astype(f32) does. A ragged last chunk is padded with
// identity steps (r = k = v = 0, lw = 0); here the loads mask the rows past
// S. Unlike the Pallas kernel, this one starts from a given state (or zero)
// and writes the final state, which prefill hands to decode.
//
// The pairwise decay is kept as one exponential of a difference,
// exp(cumex_t - cum_s) <= 1 for s < t. Splitting it into exp(cumex_t) and
// exp(-cum_s) overflows: lw reaches -20 per step, so exp(-cum_s) passes
// f32's range within five steps. The Pallas kernel materialises the
// (T, T, dh) decay tensor (4 MB at T 128, dh 64); here it never exists:
// each score is summed over d as its factors are formed.
//
// Bound on an H100: the exponentials, T(T-1)/2 dh per chunk and head (0.52M
// at T 128, dh 64), against ~2.6M flops of products and 0.06 MB moved per
// chunk and head. Each uses the accurate expf (the reference's tolerance is
// 1e-4 relative; the MUFU's ex2.approx alone would be a later trade).
//
// Design, the simple one: one 256-thread block per (b, h), chunks in order
// inside it; the chunk's cumsum, the state and 64-row tiles of r, cumex, k,
// v and the scores sit in shared memory (row stride 65 floats, so column
// walks hit distinct banks); each thread keeps a 4 x 4 block of a 64 x 64
// output tile in registers (rows ty + 16 i, columns tx + 16 j). For each
// query tile the key tiles at or below it come in turn; a score tile is
// formed whole (its upper triangle on the diagonal tile is computed and
// then dropped by a select, so an overflowing exponent there is harmless)
// and multiplied into the outputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // rows of a tile; also the largest dh
constexpr int kLd = kTile + 1;   // row stride of a tile in shared memory
constexpr int kThreads = 256;    // 16 x 16 threads, a 4 x 4 block each
constexpr int kTileFloats = kTile * kLd;
constexpr int kMaxSmem = 232448; // bytes a block may use on an H100

// value dtype codes, mirrored by _DTYPE_CODES in rwkv6.py
enum DType : int { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
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
  int H, S, dh, chunk;
};

// rows of a (rows x width) matrix with row stride ld into a 64 x 64 f32
// tile, zero at rows >= nrows and columns >= width
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t ld, int nrows, int width) {
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int r = e >> 6, c = e & 63;
    dst[r * kLd + c] = (r < nrows && c < width) ? to_f32(src[r * ld + c])
                                                : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) wkv6_chunk_kernel(WkvArgs a) {
  extern __shared__ float smem[];
  float* Rq = smem;                // r of the query tile, then r o exp(cumex)
  float* Eq = Rq + kTileFloats;    // cumex of the query tile       [t][d]
  float* Kk = Eq + kTileFloats;    // k of the key tile             [s][d]
  float* Vk = Kk + kTileFloats;    // v of the key tile             [s][e]
  float* P = Vk + kTileFloats;     // scores                        [t][s]
  float* St = P + kTileFloats;     // the state                     [d][e]
  float* cum = St + kTileFloats;   // cumsum of lw over the chunk   [t][d]

  const int h = blockIdx.x, b = blockIdx.y;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* r = static_cast<const T*>(a.r) + b * a.r_b + h * a.r_h;
  const T* k = static_cast<const T*>(a.k) + b * a.k_b + h * a.k_h;
  const T* v = static_cast<const T*>(a.v) + b * a.v_b + h * a.v_h;
  const float* lw = a.lw + b * a.lw_b + h * a.lw_h;
  const float* u = a.u + static_cast<int64_t>(h) * a.dh;
  float* out = a.out + b * a.o_b + h * a.o_h;
  const int64_t s_off = (static_cast<int64_t>(b) * a.H + h) * a.dh * a.dh;

  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int d = e >> 6, c = e & 63;
    St[d * kLd + c] = (a.state_in != nullptr && d < a.dh && c < a.dh)
                          ? a.state_in[s_off + d * a.dh + c] : 0.0f;
  }
  const int T_ = a.chunk;
  const int n_tiles = (T_ + kTile - 1) / kTile;
  const int n_chunks = (a.S + T_ - 1) / T_;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * T_;
    __syncthreads();               // the last chunk is done with cum and St
    // lw of the chunk, zero past S and in the rows that round it up to tiles
    for (int e = threadIdx.x; e < n_tiles * kTile * kTile; e += kThreads) {
      const int t = e >> 6, d = e & 63;
      cum[t * kLd + d] = (t < T_ && c0 + t < a.S && d < a.dh)
                             ? lw[static_cast<int64_t>(c0 + t) * a.lw_s + d]
                             : 0.0f;
    }
    __syncthreads();
    if (threadIdx.x < a.dh) {      // one column each, in order
      float acc = 0.0f;
      for (int t = 0; t < T_; ++t) {
        acc += cum[t * kLd + threadIdx.x];
        cum[t * kLd + threadIdx.x] = acc;
      }
    }
    for (int qt = 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kTile;
      const int q_rows = min(kTile, T_ - q0);             // rows in the chunk
      const int q_valid = min(q_rows, a.S - (c0 + q0));   // rows before S
      float acc[4][4] = {};
      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * kTile;
        const int k_rows = min(kTile, T_ - k0);
        const int k_valid = min(k_rows, a.S - (c0 + k0));
        __syncthreads();           // the last tile is done with Kk, Vk, P
        if (kt == 0) {
          load_tile(Rq, r + static_cast<int64_t>(c0 + q0) * a.r_s, a.r_s,
                    q_valid, a.dh);
          for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
            const int t = e >> 6, d = e & 63;
            Eq[t * kLd + d] =
                (t < q_valid && d < a.dh)
                    ? cum[(q0 + t) * kLd + d] -
                          lw[static_cast<int64_t>(c0 + q0 + t) * a.lw_s + d]
                    : 0.0f;
          }
        }
        load_tile(Kk, k + static_cast<int64_t>(c0 + k0) * a.k_s, a.k_s,
                  k_valid, a.dh);
        load_tile(Vk, v + static_cast<int64_t>(c0 + k0) * a.v_s, a.v_s,
                  k_valid, a.dh);
        __syncthreads();
        // P[t][s] = sum_d r_t[d] k_s[d] exp(cumex_t[d] - cum_s[d]), s < t
        float p[4][4] = {};
        const float* ck = cum + k0 * kLd;
        for (int d = 0; d < a.dh; ++d) {
          float rv[4], ev[4], kv[4], cv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            rv[i] = Rq[(ty + 16 * i) * kLd + d];
            ev[i] = Eq[(ty + 16 * i) * kLd + d];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            kv[j] = Kk[(tx + 16 * j) * kLd + d];
            cv[j] = ck[(tx + 16 * j) * kLd + d];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              p[i][j] = fmaf(rv[i] * kv[j], expf(ev[i] - cv[j]), p[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int ti = ty + 16 * i, sj = tx + 16 * j;
            const bool keep = ti < q_rows && sj < k_rows && k0 + sj < q0 + ti;
            P[ti * kLd + sj] = keep ? p[i][j] : 0.0f;
          }
        }
        __syncthreads();
        for (int s = 0; s < kTile; ++s) {
          float pv[4], vv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[i] = P[(ty + 16 * i) * kLd + s];
#pragma unroll
          for (int j = 0; j < 4; ++j) vv[j] = Vk[s * kLd + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
        }
      }
      // the bonus: Kk and Vk now hold the query tile's own rows
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ti = ty + 16 * i;
        float du = 0.0f;
        for (int d = 0; d < a.dh; ++d)
          du = fmaf(u[d] * Rq[ti * kLd + d], Kk[ti * kLd + d], du);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(du, Vk[ti * kLd + tx + 16 * j], acc[i][j]);
      }
      __syncthreads();             // every reader of the raw Rq is done
      for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
        const int t = e >> 6, d = e & 63;
        Rq[t * kLd + d] *= expf(Eq[t * kLd + d]);
      }
      __syncthreads();
      // inter-chunk: out_t += (r_t o exp(cumex_t)) S0
      float z[4][4] = {};
      for (int d = 0; d < a.dh; ++d) {
        float rv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) rv[i] = Rq[(ty + 16 * i) * kLd + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = St[d * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) z[i][j] = fmaf(rv[i], sv[j], z[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ti = ty + 16 * i;
        if (ti >= q_valid) continue;
        float* orow = out + static_cast<int64_t>(c0 + q0 + ti) * a.o_s;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = tx + 16 * j;
          if (e < a.dh) orow[e] = acc[i][j] + z[i][j];
        }
      }
    }
    // S1[d][e] = exp(cum_T[d]) S0[d][e] + sum_s k_s[d] exp(cum_T[d] - cum_s[d]) v_s[e]
    const float* cum_t = cum + (T_ - 1) * kLd;
    float sacc[4][4] = {};
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * kTile;
      const int k_valid = min(min(kTile, T_ - k0), a.S - (c0 + k0));
      __syncthreads();             // every reader of Kk, Vk and St is done
      for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
        const int s = e >> 6, d = e & 63;
        Kk[s * kLd + d] =
            (s < k_valid && d < a.dh)
                ? to_f32(k[static_cast<int64_t>(c0 + k0 + s) * a.k_s + d]) *
                      expf(cum_t[d] - cum[(k0 + s) * kLd + d])
                : 0.0f;
      }
      load_tile(Vk, v + static_cast<int64_t>(c0 + k0) * a.v_s, a.v_s,
                k_valid, a.dh);
      __syncthreads();
      for (int s = 0; s < kTile; ++s) {
        float kv[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) kv[i] = Kk[s * kLd + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) vv[j] = Vk[s * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sacc[i][j] = fmaf(kv[i], vv[j], sacc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = ty + 16 * i;
      const float p_t = expf(cum_t[d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* sp = St + d * kLd + tx + 16 * j;
        *sp = p_t * *sp + sacc[i][j];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int d = e >> 6, c = e & 63;
    if (d < a.dh && c < a.dh)
      a.state_out[s_off + d * a.dh + c] = St[d * kLd + c];
  }
}

template <typename T>
int launch(const WkvArgs& a, int B, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_chunk_kernel<T><<<dim3(a.H, B), kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// r, k, v: (B, H, S, dh) of dtype `dtype` with element strides (b, h, s) and
// a dense last dim; lw: (B, H, S, dh) f32, the same kind of strides; u:
// (H, dh) f32 contiguous; out: (B, H, S, dh) f32, strides (b, h, s);
// state_in (or null) and state_out: (B, H, dh, dh) f32 contiguous. dh at
// most 64. Launches on `stream`; returns the launch's cudaError_t.
int repro_wkv6_chunked(const void* r, int64_t r_b, int64_t r_h, int64_t r_s,
                       const void* k, int64_t k_b, int64_t k_h, int64_t k_s,
                       const void* v, int64_t v_b, int64_t v_h, int64_t v_s,
                       const void* lw, int64_t lw_b, int64_t lw_h,
                       int64_t lw_s, const void* u, const void* state_in,
                       void* out, int64_t o_b, int64_t o_h, int64_t o_s,
                       void* state_out, int B, int H, int S, int dh,
                       int chunk, int dtype, void* stream) {
  if (dh < 1 || dh > kTile || chunk < 1 || B < 0 || H < 0 || S < 0 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (chunk + kTile - 1) / kTile;
  const size_t smem = (6 * kTileFloats + n_tiles * kTile * kLd) *
                      sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem))
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32: return launch<float>(a, B, smem, st);
    case BF16: return launch<__nv_bfloat16>(a, B, smem, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
