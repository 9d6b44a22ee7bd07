// The Mamba-2 layer's elementwise glue around the SSD scan (K6), for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (src/repro_torch/kernels/mamba2_glue/mamba2_glue.py).
//
// Replaces no TPU kernel: the reference leaves this glue to XLA, which fuses
// it (src/repro/models/mamba2.py, mamba_block). The port ran it as some 30
// PyTorch elementwise, cat and copy kernels a layer, each reading and
// writing whole rows; these two kernels run the serving prefill's glue of a
// bf16 layer in one pass each, rounding to bf16 exactly where those torch
// ops round, so their outputs are the torch ops' bit for bit.
//
// conv_in_kernel, before K6. Per token t of batch row b and channel c of
// the conv input (d_inner x channels, then B's N, then C's N):
//   y   = x[t-K+1] w0, + x[t-K+2] w1, ..., + x[t] w_{K-1}, + bias
//         (each product and each partial sum rounded to bf16, in this
//         order; rows before the sequence come from the conv state)
//   act = bf16(silu(y)) = bf16(y / (1 + expf(-y)))
// and per head h:
//   dt  = softplus(f32(dt_raw) + f32(dt_bias)), x itself above 20
//   lw  = dt * (-expf(f32(A_log)))
// It writes xs = f32(act) * dt (x channels, f32), xh = act (x channels,
// bf16, for the D skip), B and C as f32, lw, and the new conv state (the
// last K-1 rows of [state; x]). A thread takes 4 channels (one 8-byte load
// a row) and a tile of consecutive tokens, and slides the conv's window down
// the tile in registers: each input row is read once, plus a (K-1)-row halo
// a tile. (8 channels a thread, with 16-byte loads, held 136 registers and
// 12 warps an SM and ran at 40 % of the byte bound on an H100; 4 channels,
// 80 registers, at 52 %: PERF.md's kernel table.)
//
// gate_norm_kernel, after K6. Per row of d_inner values:
//   v = bf16(y + D_h f32(xh)),  g = bf16(v * bf16(silu(z)))
// then RMSNorm (K4, kernels/rmsnorm/csrc/rmsnorm.cu) of g with its order of
// the sum of squares (each 16-byte group left to right, then a halving tree
// over the groups padded to a power of two) and its two roundings, so the
// output is K4's of g bit for bit. It writes only the normed bf16 row. The
// row's groups stay in registers (K4's many-rows layout: `team` threads a
// row, K groups a thread), the scale is staged once a block.
//
// Bound on an H100 (3.35 TB/s HBM3): memory. At zamba2's widths (d_inner
// 4,096, N 64, 64 heads) a token of a layer reads 8.6 KB and writes 25.3 KB
// in conv_in, reads 32.8 KB and writes 8.2 KB in gate_norm: 74.9 KB, against
// ~460 KB for the torch ops. Each has its loads in flight before the
// arithmetic. No fast math: expf, log1pf, the division and sqrtf are the
// accurate ones, as in the torch kernels they replace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 4;        // channels a conv_in thread (8 bytes)
constexpr int kConvThreads = 128;   // a conv_in block: 128 x 4 channels
constexpr int kTile = 64;           // tokens a conv_in block slides over
constexpr int kUnroll = 2;          // rows a thread loads before computing
constexpr int kNormThreads = 256;   // a gate_norm block
constexpr int kMaxK = 8;            // groups a gate_norm thread, at most
constexpr int kMaxTeam = 512;

// ptx:begin -- streamed loads: read once, not kept in L1
__device__ __forceinline__ uint4 load_stream16(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
// ptx:end

// bf16 bits -> float; float -> bf16 bits (to nearest even); a float rounded
// to bf16
__device__ __forceinline__ float bf(uint32_t bits) {
  return __uint_as_float((bits & 0xffffu) << 16);
}
__device__ __forceinline__ uint32_t to_bf(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float rnd(float v) { return bf(to_bf(v)); }

// value i (0..7) of 8 bf16 packed in a 16-byte group
__device__ __forceinline__ uint32_t half_of(const uint4& u, int i) {
  const uint32_t w = i < 2 ? u.x : i < 4 ? u.y : i < 6 ? u.z : u.w;
  return (w >> (16 * (i & 1))) & 0xffffu;
}

// torch's silu and softplus (beta 1, threshold 20) on float
__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}
__device__ __forceinline__ float softplus(float x) {
  return x > 20.0f ? x : log1pf(expf(x));
}

// a small parameter vector in f32 or bf16
struct Vec {
  const void* p;
  int is_bf16;
  __device__ float at(int64_t i) const {
    return is_bf16 ? bf(static_cast<const uint16_t*>(p)[i])
                   : static_cast<const float*>(p)[i];
  }
};

__device__ __forceinline__ uint4 pack_bf16x8(const uint32_t (&b)[8]) {
  uint4 u;
  u.x = b[0] | (b[1] << 16);
  u.y = b[2] | (b[3] << 16);
  u.z = b[4] | (b[5] << 16);
  u.w = b[6] | (b[7] << 16);
  return u;
}

// 4 bf16 of an 8-byte group: value i (0..3); 4 floats stored at once
__device__ __forceinline__ uint32_t quarter_of(const uint2& u, int i) {
  return ((i < 2 ? u.x : u.y) >> (16 * (i & 1))) & 0xffffu;
}
__device__ __forceinline__ void store_f32x4(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// Grid: (channel groups of 4 / kConvThreads, tiles of kTile tokens, batch).
// The conv input row (b, t) starts at conv + b * sb + t * st, its dt values
// at dt_raw + b * sb + t * st (both bf16, proj's columns in place).
template <int K>
__global__ void __launch_bounds__(kConvThreads)
conv_in_kernel(const uint16_t* __restrict__ conv,
               const uint16_t* __restrict__ dt_raw, int64_t sb, int64_t st,
               const uint16_t* __restrict__ state, Vec w, Vec bias,
               Vec dt_bias, Vec a_log, float* __restrict__ xs,
               float* __restrict__ lw, float* __restrict__ Bo,
               float* __restrict__ Co, uint16_t* __restrict__ xh,
               uint16_t* __restrict__ new_state, int S, int di, int N,
               int H) {
  const int C = di + 2 * N;
  const int c0 = kChannels *
                 static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x);
  if (c0 >= C) return;
  const int b = static_cast<int>(blockIdx.z);
  const int t0 = static_cast<int>(blockIdx.y) * kTile;
  const int t1 = t0 + kTile < S ? t0 + kTile : S;
  const int dh = di / H;
  const bool is_x = c0 < di;
  const int h = is_x ? c0 / dh : 0;

  // the taps and the bias, rounded to bf16 (torch's w.to(x.dtype))
  float wt[K][kChannels], bs[kChannels];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < kChannels; ++i)
      wt[k][i] = rnd(w.at(static_cast<int64_t>(k) * C + c0 + i));
#pragma unroll
  for (int i = 0; i < kChannels; ++i) bs[i] = rnd(bias.at(c0 + i));
  const float dtb = is_x ? dt_bias.at(h) : 0.0f;
  const float A = is_x ? -expf(a_log.at(h)) : 0.0f;

  // the window: rows t0 - K + 1 .. t0 - 1 of [state; x], as bits
  const uint16_t* xrow = conv + b * sb + static_cast<int64_t>(c0);
  uint2 win[K - 1];
#pragma unroll
  for (int j = 0; j < K - 1; ++j) {
    const int t = t0 + j - (K - 1);      // < 0: row K - 1 + t of the state
    if (t >= 0) {
      win[j] = *reinterpret_cast<const uint2*>(xrow + t * st);
    } else if (state != nullptr) {
      win[j] = *reinterpret_cast<const uint2*>(
          state + (static_cast<int64_t>(b) * (K - 1) + (K - 1) + t) * C + c0);
    } else {
      win[j] = make_uint2(0u, 0u);
    }
  }

  for (int t = t0; t < t1; t += kUnroll) {
    uint2 cur[kUnroll];
    float dtv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t + u < t1) {
        cur[u] = *reinterpret_cast<const uint2*>(xrow + (t + u) * st);
        dtv[u] = is_x ? bf(dt_raw[b * sb + (t + u) * st + h]) : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t + u >= t1) break;
      const int64_t row = static_cast<int64_t>(b) * S + t + u;
      float act[kChannels];
#pragma unroll
      for (int i = 0; i < kChannels; ++i) {
        float y = rnd(__fmul_rn(bf(quarter_of(win[0], i)), wt[0][i]));
#pragma unroll
        for (int k = 1; k < K - 1; ++k)
          y = rnd(__fadd_rn(y, rnd(__fmul_rn(bf(quarter_of(win[k], i)),
                                             wt[k][i]))));
        y = rnd(__fadd_rn(y, rnd(__fmul_rn(bf(quarter_of(cur[u], i)),
                                           wt[K - 1][i]))));
        y = rnd(__fadd_rn(y, bs[i]));
        act[i] = rnd(silu(y));
      }
#pragma unroll
      for (int j = 0; j < K - 2; ++j) win[j] = win[j + 1];
      win[K - 2] = cur[u];
      if (is_x) {
        const float dt = softplus(__fadd_rn(dtv[u], dtb));
        uint32_t bits[kChannels];
        float v[kChannels];
#pragma unroll
        for (int i = 0; i < kChannels; ++i) {
          bits[i] = to_bf(act[i]);
          v[i] = __fmul_rn(act[i], dt);
        }
        *reinterpret_cast<uint2*>(xh + row * di + c0) =
            make_uint2(bits[0] | (bits[1] << 16), bits[2] | (bits[3] << 16));
        store_f32x4(xs + row * di + c0, v);
        if (c0 % dh == 0) lw[row * H + h] = __fmul_rn(dt, A);
      } else if (c0 < di + N) {
        store_f32x4(Bo + row * N + (c0 - di), act);
      } else {
        store_f32x4(Co + row * N + (c0 - di - N), act);
      }
    }
  }

  // the last tile leaves the window: rows S .. S + K - 2 of [state; x]
  if (t1 == S) {
#pragma unroll
    for (int j = 0; j < K - 1; ++j)
      *reinterpret_cast<uint2*>(
          new_state + (static_cast<int64_t>(b) * (K - 1) + j) * C + c0) =
          win[j];
  }
}

// One 16-byte group of g (8 values from column c) of a row: y (f32), xh and
// z (bf16), D_h; zero past d.
__device__ __forceinline__ void gate_group(uint32_t (&g)[4],
                                           const float* yr,
                                           const uint16_t* xr,
                                           const uint16_t* zr, const Vec& Dv,
                                           int c, int d, int dh) {
  g[0] = g[1] = g[2] = g[3] = 0u;
  if (c >= d) return;
  const uint4 y0 = load_stream16(yr + c), y1 = load_stream16(yr + c + 4);
  const uint4 xv = load_stream16(xr + c), zv = load_stream16(zr + c);
  const float yv[8] = {__uint_as_float(y0.x), __uint_as_float(y0.y),
                       __uint_as_float(y0.z), __uint_as_float(y0.w),
                       __uint_as_float(y1.x), __uint_as_float(y1.y),
                       __uint_as_float(y1.z), __uint_as_float(y1.w)};
  const float D = Dv.at(c / dh);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float v = rnd(__fadd_rn(yv[i], __fmul_rn(D, bf(half_of(xv, i)))));
    const float sz = rnd(silu(bf(half_of(zv, i))));
    g[i >> 1] |= to_bf(__fmul_rn(v, sz)) << (16 * (i & 1));
  }
}

// Rows of d values, `team` threads a row (a power of two, 16..512),
// blockDim.x / team rows a block, K groups a thread (team * K >= the row's
// groups). Dynamic shared memory: team * K groups of the scale as bf16,
// then, when team > 32, one float a thread for the tree's middle levels.
template <int K>
__global__ void __launch_bounds__(kMaxTeam)
gate_norm_kernel(const float* __restrict__ y, const uint16_t* __restrict__ xh,
                 const uint16_t* __restrict__ z, int64_t zb, int64_t zs,
                 Vec Dv, Vec scale, uint16_t* __restrict__ out, int64_t rows,
                 int S, int d, int dh, float eps, int team) {
  extern __shared__ uint4 smem[];
  uint4* sc = smem;
  float* tree = reinterpret_cast<float*>(smem + team * K);
  const int tid = static_cast<int>(threadIdx.x);
  const int t = tid & (team - 1);
  const int64_t row = static_cast<int64_t>(blockIdx.x) *
                          (static_cast<int>(blockDim.x) / team) + tid / team;
  const bool live = row < rows;   // a dead row loads nothing, stores nothing
  const int64_t r = live ? row : 0;
  const float* yr = y + r * d;
  const uint16_t* xr = xh + r * d;
  const uint16_t* zr = z + (r / S) * zb + (r % S) * zs;
  const int dl = live ? d : 0;

  uint32_t g[K][4];
#pragma unroll
  for (int j = 0; j < K; ++j)
    gate_group(g[j], yr, xr, zr, Dv, (t + team * j) * 8, dl, dh);

  // the scale rounded to bf16, once a block: its groups in turn
  for (int q = tid; q < team * K; q += static_cast<int>(blockDim.x)) {
    uint32_t bits[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      bits[i] = q * 8 + i < d ? to_bf(scale.at(q * 8 + i)) : 0u;
    sc[q] = pack_bf16x8(bits);
  }

  // K4's order: each group left to right, then the tree: K groups in
  // registers ...
  float s[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    float a = bf(g[j][0]);
    a = __fmul_rn(a, a);
#pragma unroll
    for (int i = 1; i < 8; ++i) {
      const float v = bf(g[j][i >> 1] >> (16 * (i & 1)));
      a = __fadd_rn(a, __fmul_rn(v, v));
    }
    s[j] = a;
  }
#pragma unroll
  for (int hh = K / 2; hh > 0; hh >>= 1)
#pragma unroll
    for (int j = 0; j < hh; ++j) s[j] = __fadd_rn(s[j], s[j + hh]);
  float ss = s[0];
  // ... the levels team/2 .. 32 through shared memory ...
  if (team > 32) {
    tree[tid] = ss;
    __syncthreads();
    for (int hh = team / 2; hh >= 32; hh >>= 1) {
      if (t < hh) tree[tid] = __fadd_rn(tree[tid], tree[tid + hh]);
      __syncthreads();
    }
    ss = tree[tid - t + (t & 31)];   // every warp of the row takes them
  }
  // ... and the last levels across a warp's lanes
  for (int off = (team < 32 ? team : 32) / 2; off > 0; off >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));

  const float var = ss / static_cast<float>(d);
  const float rr = rnd(1.0f / sqrtf(var + eps));
  __syncthreads();   // the staged scale

#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = (t + team * j) * 8;
    if (!live || c >= d) continue;
    const uint4 su = sc[t + team * j];
    uint32_t bits[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float xr_r = rnd(__fmul_rn(bf(g[j][i >> 1] >> (16 * (i & 1))),
                                       rr));
      bits[i] = to_bf(__fmul_rn(xr_r, bf(half_of(su, i))));
    }
    *reinterpret_cast<uint4*>(out + row * d + c) = pack_bf16x8(bits);
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <int K>
int launch_conv(const void* conv, const void* dt_raw, int64_t sb, int64_t st,
                const void* state, Vec w, Vec bias, Vec dt_bias, Vec a_log,
                void* xs, void* lw, void* Bo, void* Co, void* xh,
                void* new_state, int B, int S, int di, int N, int H,
                cudaStream_t stream) {
  const int groups = (di + 2 * N) / kChannels;
  const dim3 grid((groups + kConvThreads - 1) / kConvThreads,
                  (S + kTile - 1) / kTile, B);
  conv_in_kernel<K><<<grid, kConvThreads, 0, stream>>>(
      static_cast<const uint16_t*>(conv), static_cast<const uint16_t*>(dt_raw),
      sb, st, static_cast<const uint16_t*>(state), w, bias, dt_bias, a_log,
      static_cast<float*>(xs), static_cast<float*>(lw),
      static_cast<float*>(Bo), static_cast<float*>(Co),
      static_cast<uint16_t*>(xh), static_cast<uint16_t*>(new_state), S, di,
      N, H);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_norm(const void* y, const void* xh, const void* z, int64_t zb,
                int64_t zs, Vec Dv, Vec scale, void* out, int64_t rows, int S,
                int d, int dh, float eps, int team, cudaStream_t stream) {
  const int rpb = kNormThreads / team > 0 ? kNormThreads / team : 1;
  const int threads = team * rpb;
  const int64_t blocks = (rows + rpb - 1) / rpb;
  const size_t smem = static_cast<size_t>(team) * K * 16 +
                      (team > 32 ? static_cast<size_t>(threads) * 4 : 0);
  gate_norm_kernel<K><<<static_cast<unsigned>(blocks), threads, smem,
                        stream>>>(
      static_cast<const float*>(y), static_cast<const uint16_t*>(xh),
      static_cast<const uint16_t*>(z), zb, zs, Dv, scale,
      static_cast<uint16_t*>(out), rows, S, d, dh, eps, team);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The glue before K6 for a (B, S) bf16 batch with d_inner `di`, `N` B and C
// channels, `H` heads and a K-tap conv (K 2..4). conv, dt_raw: bf16, row
// (b, t) at b * sb + t * st values from each (proj's conv and dt columns
// in place); state: (B, K-1, di + 2N) bf16, contiguous, or null (zero);
// w: (K, di + 2N), bias: (di + 2N,), dt_bias, a_log: (H,), each f32 or
// bf16 as its flag says. Writes xs (B, S, di) f32, lw (B, S, H) f32, Bo and
// Co (B, S, N) f32, xh (B, S, di) bf16 and new_state (B, K-1, di + 2N)
// bf16, all contiguous. N and di / H multiples of 4; conv, state, sb and
// st 8-byte aligned, the outputs 16-byte aligned. Returns the launch's
// cudaError_t.
int repro_mamba2_conv_in(const void* conv, const void* dt_raw, int64_t sb,
                         int64_t st, const void* state, const void* w,
                         int w_bf16, const void* bias, int bias_bf16,
                         const void* dt_bias, int dt_bias_bf16,
                         const void* a_log, int a_log_bf16, void* xs,
                         void* lw, void* Bo, void* Co, void* xh,
                         void* new_state, int B, int S, int di, int N, int H,
                         int K, void* stream) {
  if (B < 1 || S < 1) return 0;
  if (H < 1 || di % H || N % kChannels || (di / H) % kChannels || K < 2 ||
      K > 4 || sb % 4 || st % 4 || !aligned(conv, 8) || !aligned(xs, 16) ||
      !aligned(Bo, 16) || !aligned(Co, 16) || !aligned(xh, 8) ||
      !aligned(new_state, 8) || (state != nullptr && !aligned(state, 8)) ||
      B > 65535 || (S + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Vec wv{w, w_bf16}, bv{bias, bias_bf16}, dtb{dt_bias, dt_bias_bf16},
      al{a_log, a_log_bf16};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 2: return launch_conv<2>(conv, dt_raw, sb, st, state, wv, bv, dtb,
                                  al, xs, lw, Bo, Co, xh, new_state, B, S, di,
                                  N, H, s);
    case 3: return launch_conv<3>(conv, dt_raw, sb, st, state, wv, bv, dtb,
                                  al, xs, lw, Bo, Co, xh, new_state, B, S, di,
                                  N, H, s);
    default: return launch_conv<4>(conv, dt_raw, sb, st, state, wv, bv, dtb,
                                   al, xs, lw, Bo, Co, xh, new_state, B, S,
                                   di, N, H, s);
  }
}

// The glue after K6 for a (B, S) batch of d_inner `d` in `H` heads: y
// (B, S, d) f32 and xh (B, S, d) bf16, contiguous; z bf16, row (b, t) at
// b * zb + t * zs values (proj's z columns in place); D (H,) and scale
// (d,), each f32 or bf16 as its flag says. Writes out (B, S, d) bf16,
// contiguous: K4 of bf16(bf16(y + D xh) * bf16(silu(z))). d and d / H
// multiples of 8, d at most 8 x 512 x 8 values; y, xh, z, zb, zs and out
// 16-byte aligned. Returns the launch's cudaError_t.
int repro_mamba2_gate_norm(const void* y, const void* xh, const void* z,
                           int64_t zb, int64_t zs, const void* D, int D_bf16,
                           const void* scale, int scale_bf16, void* out,
                           int B, int S, int d, int H, float eps,
                           void* stream) {
  if (B < 1 || S < 1) return 0;
  if (H < 1 || d % H || d % 8 || (d / H) % 8 || zb % 8 || zs % 8 ||
      !aligned(y, 16) || !aligned(xh, 16) || !aligned(z, 16) ||
      !aligned(out, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  int n = 1;                          // the row's groups, a power of two
  while (n < d / 8) n <<= 1;
  // K4's many-rows layout: 16 threads a row up to 16 groups, 32 up to 256,
  // then 8 groups a thread
  const int team = n <= 16 ? 16 : n <= 32 * kMaxK ? 32 : n / kMaxK;
  if (team > kMaxTeam) return static_cast<int>(cudaErrorInvalidValue);
  const int K = n > team ? n / team : 1;
  const Vec Dv{D, D_bf16}, sv{scale, scale_bf16};
  const int64_t rows = static_cast<int64_t>(B) * S;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch_norm<1>(y, xh, z, zb, zs, Dv, sv, out, rows, S, d,
                                  d / H, eps, team, s);
    case 2: return launch_norm<2>(y, xh, z, zb, zs, Dv, sv, out, rows, S, d,
                                  d / H, eps, team, s);
    case 4: return launch_norm<4>(y, xh, z, zb, zs, Dv, sv, out, rows, S, d,
                                  d / H, eps, team, s);
    default: return launch_norm<8>(y, xh, z, zb, zs, Dv, sv, out, rows, S, d,
                                   d / H, eps, team, s);
  }
}

}  // extern "C"
