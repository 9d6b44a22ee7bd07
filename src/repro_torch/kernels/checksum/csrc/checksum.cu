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
//   * each step of blk_v values is summed by the exact halving tree of
//     ref.tree_sum_f32 (element j pairs with j + n/2 at each level); the
//     step sums are then added SEQUENTIALLY in step order by one thread,
//     starting from 0.0f (K1) or the carry (K2) -- the reference's
//     cross-step order;
//   * min/max/count are order-free; min/max compare by value;
//   * built without --use_fast_math and without -ftz: subnormals are kept.
//
// K1 and K2 are one kernel, qa_kernel, one launch a call. A warp sums one
// step at a time with the tree in registers: lane l holds the step's
// 16-byte groups l, l + 32, ... (V values each), so the tree's levels fall
// in the lane (pairs 32 V or more apart), across lanes (__shfl_down_sync by
// 16 .. 1) and inside a group (pairs closer than V), each level pairing as
// the reference does. One 16-byte load feeds the words and the values. A
// row whose start is not 16-byte aligned, or whose steps hold fewer than 32
// groups, takes a scalar path with the same pairs. Each step's sum goes to
// scratch; each block reduces its order-free partials; the last block of a
// row to finish (a ticket after __threadfence) folds the row: the step
// sums through shared memory in pieces, chained by one thread at FADD
// latency while the other warps load the next piece.
//
// The tickets live in a buffer that the caller zeroes once and keeps, one
// per stream (checksum.py keeps one per device and stream); the last block
// resets its row's ticket, so every call leaves the buffer as it found it
// and calls in flight on two streams never share one. Zeroing them in the
// per-call scratch would need a second launch (a memset), or a zeroing
// that every block could see before any block counts, which blocks that
// run in no order cannot give.
//
// Bound on an H100 (3.35 TB/s HBM3, 700 W part): the larger of the bytes
// (each input byte read once: 13.8 us for a 256x256x176 f32 volume) and the
// chain of nsteps dependent f32 adds that the contract fixes (11,264 at ~4
// cycles: ~23 us at 1.98 GHz). The fold runs after the last step is read,
// so this design takes about their sum.
//
// K3 (transfer_kernel) has only the two word sums, which are order-free, so
// it is bound by the bytes alone (13.8 us for the same volume). It is one
// launch a call on a persistent grid (SMs x kK3BlocksPerSM blocks): a warp
// takes spans of 32 x kK3R 16-byte groups round the grid, lane l the
// groups l + 32 r, all kK3R loads of a span issued before any is used (64
// bytes a lane in flight), indices clamped and masked rather than branched
// on. A lane's word positions come from one modulo at its start, advanced
// by the grid's stride mod 65521 with a compare-and-subtract; a span that
// does not wrap adds s2 += p S + sum_r (128 r S_r + w1 + 2 w2 + 3 w3), the
// rest word by word. The groups are those of the data rounded down to 16
// bytes: the words before the first whole group and after the last (at
// most 8) go bytewise, so a start at any word boundary reads nothing before
// its first byte and nothing past its last byte's 16-byte group. A start
// 1-3 bytes past a word boundary (each word straddling two aligned ones)
// has no body: all its words go bytewise, round the grid, at a fraction of
// the aligned rate; the port's callers hash whole tensors, which torch
// allocates aligned. Each block's partial goes to scratch, and the last
// block to take a ticket (an acq_rel atomic, so no separate fence) adds
// them up and resets the ticket. At a T1w's bytes it reads at ~3 TB/s and
// spends ~1 us after its last read on the ticket and that sum (tools/
// k12_ab.py; PERF.md).

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
constexpr unsigned kFull = 0xffffffffu;
// resident qa_kernel blocks an SM that the grid is sized for: 256 threads
// at <= 64 registers (ptxas) and 17 KB of shared memory fit 4
constexpr int kBlocksPerSM = 4;
// step sums a fold piece holds; two pieces in shared memory
constexpr int kPiece = 2048;
// qa_kernel's shared memory, in words: per-warp partials, the last-block
// flag, then the fold's two pieces (16-byte aligned)
constexpr int kRedWords = 128;
constexpr int kQASmemBytes = (kRedWords + 2 * kPiece) * 4;

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

// A value's bits (its low `itemsize` bytes) cast to f32 with
// round-to-nearest (numpy's astype).
__device__ __forceinline__ float to_f32(uint32_t b, int dtype) {
  switch (dtype) {
    case F32: return __uint_as_float(b);
    case F16:
      return __half2float(__ushort_as_half(static_cast<unsigned short>(b)));
    case BF16: return __uint_as_float(b << 16);
    case I8: return static_cast<float>(static_cast<int8_t>(b));
    case U8: return static_cast<float>(static_cast<uint8_t>(b));
    case I16: return static_cast<float>(static_cast<int16_t>(b));
    case U16: return static_cast<float>(static_cast<uint16_t>(b));
    case I32: return __int2float_rn(static_cast<int32_t>(b));
    case U32: return __uint2float_rn(b);
    default: return 0.0f;
  }
}

__device__ __forceinline__ uint32_t word_pos(int64_t gw) {
  // (i mod 65521) from a 64-bit index; the 32-bit modulo is the cheap path
  return gw < 4294967296LL ? static_cast<uint32_t>(gw) % kMPos
                           : static_cast<uint32_t>(gw % kMPos);
}

struct MinF {
  __device__ float operator()(float a, float b) const { return b < a ? b : a; }
};
struct MaxF {
  __device__ float operator()(float a, float b) const { return b > a ? b : a; }
};

// The order-free partials of one thread, a warp, a block or a row.
struct Stats {
  uint32_t s1 = 0, s2 = 0;
  int32_t cnt = 0;
  float mn = INFINITY, mx = -INFINITY;

  __device__ __forceinline__ void word(uint32_t w, uint32_t pos) {
    s1 += w;
    s2 += w * pos;
  }
  // counts `v` if it is inside the array and finite; otherwise the tree
  // gets 0.0f in its place. No branch; min/max by value (no NaN reaches
  // fminf/fmaxf, and -0.0 == +0.0)
  __device__ __forceinline__ void value(float& v, bool inside) {
    const bool f = inside && isfinite(v);
    cnt += f;
    mn = fminf(mn, f ? v : INFINITY);
    mx = fmaxf(mx, f ? v : -INFINITY);
    v = f ? v : 0.0f;
  }
  __device__ __forceinline__ void add(const Stats& o) {
    s1 += o.s1;
    s2 += o.s2;
    cnt += o.cnt;
    mn = MinF()(mn, o.mn);
    mx = MaxF()(mx, o.mx);
  }
  __device__ __forceinline__ void warp_reduce() {
    for (int o = 16; o > 0; o >>= 1) {
      Stats p;
      p.s1 = __shfl_xor_sync(kFull, s1, o);
      p.s2 = __shfl_xor_sync(kFull, s2, o);
      p.cnt = __shfl_xor_sync(kFull, cnt, o);
      p.mn = __shfl_xor_sync(kFull, mn, o);
      p.mx = __shfl_xor_sync(kFull, mx, o);
      add(p);
    }
  }
  __device__ __forceinline__ void store(uint32_t* p) const {
    p[0] = s1;
    p[1] = s2;
    p[2] = static_cast<uint32_t>(cnt);
    p[3] = __float_as_uint(mn);
    p[4] = __float_as_uint(mx);
  }
  // from shared memory, or (`global`) another block's, past L1
  __device__ __forceinline__ static Stats load(const uint32_t* p,
                                               bool global = false) {
    uint32_t w[5];
    for (int k = 0; k < 5; ++k) w[k] = global ? __ldcg(p + k) : p[k];
    Stats s;
    s.s1 = w[0];
    s.s2 = w[1];
    s.cnt = static_cast<int32_t>(w[2]);
    s.mn = __uint_as_float(w[3]);
    s.mx = __uint_as_float(w[4]);
    return s;
  }
};

__device__ __forceinline__ int bitrev(int t, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((t >> b) & 1) << (bits - 1 - b);
  return r;
}

template <int V>
struct Vec {
  float v[V];
};

template <int V>
__device__ __forceinline__ Vec<V> operator+(const Vec<V>& a, const Vec<V>& b) {
  Vec<V> c;
#pragma unroll
  for (int k = 0; k < V; ++k) c.v[k] = a.v[k] + b.v[k];
  return c;
}

// The halving tree of ref.tree_sum_f32 over a sequence y of 2^L values,
// fed in bit-reversed order: leaf t is y[bitrev(t)]. The tree's last add
// is T(y[even]) + T(y[odd]), and so inside each half, so neighbouring
// leaves of that order pair exactly as the tree pairs them: a binary
// counter of partial sums runs it, with L + 1 of them live (the scalar
// path's run-time form, in local memory; the vector path's is ptree).
struct Tree {
  float st[8];

  __device__ __forceinline__ void push(float x, int t) {
    int top = __popc(t);  // partials live before leaf t
    for (int u = t; u & 1; u >>= 1) x = st[--top] + x;
    st[top] = x;
  }
};

// The limits of one step inside its row: bytes, words and values of it
// that lie inside the row's bytes / the array, and the position of its
// first word mod 65521.
struct Step {
  const uint8_t* p;
  int bytes, words, vals;
  uint32_t pos;
};

struct QAArgs {
  const uint8_t* data;
  int64_t row_stride, row_bytes;
  int dtype, itemsize, blk_v, blk_w;
  int64_t nsteps, w0, v0, nw, nv;
  int64_t spb;                            // steps per block
  const uint32_t* carry_sums;             // (G, 2) or null
  const float* carry_qa;                  // (G, 3) or null
  const int32_t* carry_cnt;               // (G, 1) or null
  uint32_t* out_sums;
  float* out_qa;
  int32_t* out_cnt;
  float* sums;                            // (G, nsteps) step sums
  uint32_t* part;                         // (G, B, 8) block partials
  uint32_t* sync;                         // (G) tickets, zero between calls
};

__device__ __forceinline__ int clamp_to(int64_t v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : static_cast<int>(v));
}

__device__ __forceinline__ Step step_at(const QAArgs& a, const uint8_t* row,
                                        int64_t i) {
  const int blk_bytes = a.blk_v * a.itemsize;
  Step s;
  s.p = row + i * blk_bytes;
  s.bytes = clamp_to(a.row_bytes - i * blk_bytes, blk_bytes);
  s.words = clamp_to(a.nw - a.w0 - i * a.blk_w, a.blk_w);
  s.vals = clamp_to(a.nv - a.v0 - i * a.blk_v, a.blk_v);
  s.pos = word_pos(a.w0 + i * a.blk_w);
  return s;
}

// 16 bytes at `off` of a 16-byte aligned step, zero past its `bytes`.
__device__ __forceinline__ uint4 load_group(const Step& s, int off) {
  if (off + 16 <= s.bytes)
    return *reinterpret_cast<const uint4*>(s.p + off);
  uint4 r;
  r.x = load_word(s.p, off, s.bytes);
  r.y = load_word(s.p, off + 4, s.bytes);
  r.z = load_word(s.p, off + 8, s.bytes);
  r.w = load_word(s.p, off + 12, s.bytes);
  return r;
}

// The V values of a 16-byte group of dtype D, in memory order.
template <int V, int D>
__device__ __forceinline__ void decode_as(const uint32_t (&w)[4],
                                          float (&x)[V]) {
  constexpr int kPer = V / 4;             // values a word
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      x[q * kPer + e] = to_f32(kPer == 1 ? w[q] : w[q] >> (32 / kPer * e), D);
}

// One branch a group (the whole warp takes the same one).
template <int V>
__device__ __forceinline__ void decode(const uint32_t (&w)[4], int dtype,
                                       float (&x)[V]) {
  if constexpr (V == 4) {
    if (dtype == F32) decode_as<V, F32>(w, x);
    else if (dtype == I32) decode_as<V, I32>(w, x);
    else decode_as<V, U32>(w, x);
  } else if constexpr (V == 8) {
    if (dtype == F16) decode_as<V, F16>(w, x);
    else if (dtype == BF16) decode_as<V, BF16>(w, x);
    else if (dtype == I16) decode_as<V, I16>(w, x);
    else decode_as<V, U16>(w, x);
  } else {
    if (dtype == I8) decode_as<V, I8>(w, x);
    else decode_as<V, U8>(w, x);
  }
}

// What a lane carries through a step: pl, the position of its first word
// (not yet reduced), and on a full step the step's word sum and its
// sum of w c (c: a word's offset from the lane's first), from which
// s2 += pl s1 + sum w c, the positions not wrapping there.
struct LaneAcc {
  uint32_t pl, s1 = 0, wc = 0;
};

// The lane's group r of the step, loaded as `raw`: its words into s1/s2,
// its values into the partials; returns the values the tree adds. kFull:
// every byte, word and value of the step inside the row and the array,
// and the lane's positions below 65521 (no masks, no reduction).
template <int V, bool kFull>
__device__ __forceinline__ Vec<V> leaf(const Step& s, const uint4& raw, int r,
                                       int dtype, LaneAcc& la, Stats& st) {
  const int g = (threadIdx.x & 31) + 32 * r;
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if constexpr (kFull) {
      la.s1 += w[q];
      la.wc += w[q] * static_cast<uint32_t>(128 * r + q);
    } else {
      uint32_t p = la.pl + 128 * r + q;   // < 2 * 65521: one subtraction
      p = p >= kMPos ? p - kMPos : p;
      st.word(4 * g + q < s.words ? w[q] : 0u, p);
    }
  }
  Vec<V> x;
  decode<V>(w, dtype, x.v);
#pragma unroll
  for (int k = 0; k < V; ++k) st.value(x.v[k], kFull || V * g + k < s.vals);
  return x;
}

// The in-lane levels: the halving tree over the lane's groups r in
// [0, 2^L), as the pairwise tree of leaves in bit-reversed order (leaf t =
// group bitrev(t); see Tree). Leaves [T0, T0 + N) are one subtree; a batch
// of them (32 values) is loaded before any is added, so those loads are in
// flight together. Every index is known at compile time.
template <int V, bool kFull, int L, int T0, int N>
__device__ __forceinline__ Vec<V> ptree(const Step& s, int dtype, LaneAcc& la,
                                        Stats& st) {
  if constexpr (N > 32 / V) {
    const Vec<V> a = ptree<V, kFull, L, T0, N / 2>(s, dtype, la, st);
    const Vec<V> b = ptree<V, kFull, L, T0 + N / 2, N / 2>(s, dtype, la, st);
    return a + b;
  } else {
    const int lane = threadIdx.x & 31;
    uint4 raw[N];
    if (s.bytes == 512 << L) {            // the whole step inside the row:
#pragma unroll                            // loads with no branch between
      for (int u = 0; u < N; ++u)
        raw[u] = *reinterpret_cast<const uint4*>(
            s.p + 16 * (lane + 32 * bitrev(T0 + u, L)));
    } else {
#pragma unroll
      for (int u = 0; u < N; ++u)
        raw[u] = load_group(s, 16 * (lane + 32 * bitrev(T0 + u, L)));
    }
    Vec<V> x[N];
#pragma unroll
    for (int u = 0; u < N; ++u)
      x[u] = leaf<V, kFull>(s, raw[u], bitrev(T0 + u, L), dtype, la, st);
#pragma unroll
    for (int w = 1; w < N; w *= 2)
#pragma unroll
      for (int u = 0; u < N; u += 2 * w) x[u] = x[u] + x[u + w];
    return x[0];
  }
}

// One step by one warp, vector path: lane l holds the step's 16-byte
// groups l + 32 r, r < R. Returns the step's tree sum in lane 0.
template <int V, int R>
__device__ __forceinline__ float step_vec(const Step& s, int dtype,
                                          Stats& st) {
  constexpr int L = R >= 32 ? 5 : R >= 16 ? 4 : R >= 8 ? 3 : R >= 4 ? 2
                    : R >= 2 ? 1 : 0;
  LaneAcc la;
  la.pl = s.pos + 4 * (threadIdx.x & 31);
  Vec<V> x;
  if (s.bytes == 512 * R && s.words == 128 * R && s.vals == 32 * V * R &&
      la.pl + 128 * R <= kMPos) {
    x = ptree<V, true, L, 0, R>(s, dtype, la, st);
    st.s1 += la.s1;
    st.s2 += la.pl * la.s1 + la.wc;
  } else {
    x = ptree<V, false, L, 0, R>(s, dtype, la, st);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)         // lanes: pairs 16 V .. V apart
#pragma unroll
    for (int k = 0; k < V; ++k)
      x.v[k] += __shfl_down_sync(kFull, x.v[k], d);
#pragma unroll
  for (int h = V / 2; h > 0; h >>= 1)      // inside the group
#pragma unroll
    for (int k = 0; k < h; ++k) x.v[k] += x.v[k + h];
  return x.v[0];
}

// One step by one warp, scalar path (any alignment, any blk_v): value j of
// the step is leaf m of lane j % 32, m = j / 32, so the tree runs over m in
// the lane and then across lanes, with the reference's pairs.
__device__ __forceinline__ float step_scalar(const QAArgs& a, const Step& s,
                                             Stats& st) {
  const int lane = threadIdx.x & 31;
  for (int j = lane; j < a.blk_w; j += 32) {
    uint32_t p = s.pos + j;                // < 65521 + 4096
    p = p >= kMPos ? p - kMPos : p;
    st.word(j < s.words ? load_word(s.p, 4 * j, s.bytes) : 0u, p);
  }
  const int n = a.blk_v < 32 ? 1 : a.blk_v / 32;   // leaves a lane
  const int L = 31 - __clz(n);
  Tree tree;
  for (int t = 0; t < n; ++t) {
    const int j = lane + 32 * bitrev(t, L);
    float x = 0.0f;
    if (j < a.blk_v) {
      const int off = j * a.itemsize;
      uint32_t b = 0;
      for (int e = 0; e < a.itemsize; ++e)
        if (off + e < s.bytes) b |= static_cast<uint32_t>(s.p[off + e]) << (8 * e);
      x = to_f32(b, a.dtype);
      st.value(x, j < s.vals);
    }
    tree.push(x, t);
  }
  float v = tree.st[0];
  for (int d = (a.blk_v < 32 ? a.blk_v : 32) / 2; d > 0; d >>= 1)
    v += __shfl_down_sync(kFull, v, d);
  return v;
}

// Each warp of the block takes the block's steps i0 + warp, + kWarps, ...
// on the vector path (R > 0 and a 16-byte aligned row) or the scalar one.
template <int V, int R>
__device__ __forceinline__ void run_steps(const QAArgs& a, const uint8_t* row,
                                          int64_t g, int64_t i0, int64_t i1,
                                          Stats& st) {
  bool vec = false;
  if constexpr (R > 0) vec = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  for (int64_t i = i0 + (threadIdx.x >> 5); i < i1; i += kWarps) {
    const Step s = step_at(a, row, i);
    float v;
    if constexpr (R > 0)
      v = vec ? step_vec<V, R>(s, a.dtype, st) : step_scalar(a, s, st);
    else
      v = step_scalar(a, s, st);
    if ((threadIdx.x & 31) == 0) a.sums[g * a.nsteps + i] = v;
  }
}

// acc + s[0] + s[1] + ... + s[n-1], one add at a time in this order; `s` is
// 16-byte aligned shared memory. Batches of 16 go into two register sets
// in turn, each loaded a batch ahead of its adds and without a branch (the
// index clamped), so ptxas issues the loads before the other set's adds
// and the chain waits on the adds, not on the loads.
__device__ __forceinline__ float add16(float acc, const float4 (&x)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    acc += x[u].x;
    acc += x[u].y;
    acc += x[u].z;
    acc += x[u].w;
  }
  return acc;
}

__device__ __forceinline__ float chain(float acc, const float* s, int n) {
  const float4* s4 = reinterpret_cast<const float4*>(s);
  const int nb = n / 16;                  // batches of 16
  if (nb > 0) {
    float4 x[4], y[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = s4[u];
    int b = 0;
    for (; b + 1 < nb; b += 2) {
      const int bx = b + 2 < nb ? b + 2 : nb - 1;
#pragma unroll
      for (int u = 0; u < 4; ++u) y[u] = s4[4 * (b + 1) + u];
      acc = add16(acc, x);
#pragma unroll
      for (int u = 0; u < 4; ++u) x[u] = s4[4 * bx + u];
      acc = add16(acc, y);
    }
    if (b < nb) acc = add16(acc, x);      // an odd count: batch nb - 1
  }
  for (int j = 16 * nb; j < n; ++j) acc += s[j];
  return acc;
}

// src[0, len) to shared dst by nt threads (this one the lt-th), each
// thread's kMax loads in flight together.
template <int kMax>
__device__ __forceinline__ void stage(float* dst, const float* src, int len,
                                      int lt, int nt) {
  float v[kMax];
#pragma unroll
  for (int u = 0; u < kMax; ++u) {
    const int j = lt + u * nt;
    v[u] = j < len ? __ldcg(src + j) : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < kMax; ++u)
    if (lt + u * nt < len) dst[lt + u * nt] = v[u];
}

// The fold of row g by the last of its B blocks: the block partials and the
// carry, and the step sums in step order.
__device__ void fold_row(const QAArgs& a, int64_t g, int B, uint32_t* smem) {
  float* buf = reinterpret_cast<float*>(smem + kRedWords);
  const float* sums = a.sums + g * a.nsteps;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int64_t n = a.nsteps;
  const int64_t np = (n + kPiece - 1) / kPiece;
  // the carry first: its loads fly beside the first piece's
  Stats carry;
  float acc = 0.0f;
  if (t == 0 && a.carry_qa) {
    carry.s1 = a.carry_sums[g * 2];
    carry.s2 = a.carry_sums[g * 2 + 1];
    carry.cnt = a.carry_cnt[g];
    carry.mn = a.carry_qa[g * 3];
    carry.mx = a.carry_qa[g * 3 + 1];
    acc = a.carry_qa[g * 3 + 2];
  }
  stage<kPiece / kThreads>(buf, sums, static_cast<int>(n < kPiece ? n : kPiece),
                          t, kThreads);
  __syncthreads();
  Stats st;
  for (int64_t p = 0; p < np; ++p) {
    if (t == 0) {
      acc = chain(acc, buf + (p & 1) * kPiece,
                  static_cast<int>(n - p * kPiece < kPiece ? n - p * kPiece
                                                           : kPiece));
    } else if (warp > 0) {                // the next piece, meanwhile
      if (p + 1 < np) {
        const int64_t base = (p + 1) * kPiece;
        stage<(kPiece + kThreads - 33) / (kThreads - 32)>(
            buf + ((p + 1) & 1) * kPiece, sums + base,
            static_cast<int>(n - base < kPiece ? n - base : kPiece), t - 32,
            kThreads - 32);
      }
      if (p == 0) {                       // and the block partials
        for (int b = t - 32; b < B; b += kThreads - 32)
          st.add(Stats::load(a.part + (g * B + b) * 8, true));
        st.warp_reduce();
        if (lane == 0) st.store(smem + 8 * warp);
      }
    }
    __syncthreads();
  }
  if (t == 0) {                          // the carry's min/max first
    for (int w = 1; w < kWarps; ++w) carry.add(Stats::load(smem + 8 * w));
    a.out_sums[g * 2] = carry.s1;
    a.out_sums[g * 2 + 1] = carry.s2;
    a.out_qa[g * 3] = carry.mn;
    a.out_qa[g * 3 + 1] = carry.mx;
    a.out_qa[g * 3 + 2] = acc;
    a.out_cnt[g] = carry.cnt;
    a.sync[g] = 0;                        // the row's ticket, for the next call
  }
}

// Grid (B, G): block b of row g sums steps [b spb, (b + 1) spb), publishes
// the step sums and its partials, and takes a ticket; the last one folds.
// One instance per (V, R): V values a 16-byte group (16 / itemsize), R
// groups a lane a step (blk_v / (32 V)); R = 0 is the scalar path alone
// (steps of fewer than 32 groups). Each instance has its own registers.
template <int V, int R>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
qa_kernel(const QAArgs a) {
  extern __shared__ uint32_t smem[];
  const int64_t g = blockIdx.y;
  const int B = gridDim.x;
  const uint8_t* row = a.data + g * a.row_stride;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * a.spb;
  const int64_t i1 = i0 + a.spb < a.nsteps ? i0 + a.spb : a.nsteps;
  Stats st;
  run_steps<V, R>(a, row, g, i0, i1, st);

  const int warp = threadIdx.x >> 5;
  st.warp_reduce();
  if ((threadIdx.x & 31) == 0) st.store(smem + 8 * warp);
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) st.add(Stats::load(smem + 8 * w));
    st.store(a.part + (g * B + blockIdx.x) * 8);
  }
  // threadFenceReduction: the step sums (lane 0s) and the partials
  // (thread 0) are visible before the ticket, and the last block reads them
  // after it
  if ((threadIdx.x & 31) == 0) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    smem[kRedWords - 1] = atomicAdd(&a.sync[g], 1u) == static_cast<unsigned>(B - 1);
  __syncthreads();
  if (!smem[kRedWords - 1]) return;
  __threadfence();
  fold_row(a, g, B, smem);
}

// ---------------------------------------------------------------------------
// K3: the transfer checksum alone
// ---------------------------------------------------------------------------

constexpr int kK3R = 4;              // 16-byte groups a lane a span
constexpr int kK3Span = 32 * kK3R;   // groups a warp a span
constexpr int kK3Threads = 256;
constexpr int kK3Warps = kK3Threads / 32;
// resident transfer_kernel blocks an SM that the grid is sized for (at
// <= 64 registers a thread): 64 KB an SM in flight
constexpr int kK3BlocksPerSM = 4;
// block partials a thread of the last block loads at once
constexpr int kK3Fold = 4;

// ptx:begin -- K3's loads: read-only, not kept in L1 (each byte is read once)
__device__ __forceinline__ uint4 load_stream16(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
// a ticket: the block's earlier writes released with it, and the writes
// released with the tickets before it acquired
__device__ __forceinline__ uint32_t ticket_acq_rel(uint32_t* p) {
  uint32_t v;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
// ptx:end

struct K3Args {
  const uint8_t* data;        // the first byte
  const uint8_t* base;        // data rounded down to 16 bytes
  int64_t nbytes, nw;         // bytes, and words (the last zero-padded)
  int k;                      // data - base, 0..15
  int64_t gh, gb;             // the body: 16-byte groups [gh, gb) of base;
                              // none if data is not word-aligned
  int64_t nh, wt;             // the bytewise words: [0, nh) and [wt, nw)
  uint32_t pos_step;          // a lane's position step a span, mod 65521
  uint32_t* part;             // (gridDim.x, 2) block partials
  uint32_t* sync;             // the ticket: zero before and after a call
  uint32_t* out;              // (s1, s2)
};

// Group g's word c is data word 4 g + c - k / 4 (k % 4 == 0 in the body).
__global__ void __launch_bounds__(kK3Threads, kK3BlocksPerSM)
transfer_kernel(const K3Args a) {
  extern __shared__ uint32_t red3[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t s1 = 0, s2 = 0;
  const int64_t ntail = a.nw > a.wt ? a.nw - a.wt : 0;
  const int64_t nthr = static_cast<int64_t>(gridDim.x) * kK3Threads;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * kK3Threads +
                   threadIdx.x;
       t < a.nh + ntail; t += nthr) {     // the bytewise words
    const int64_t i = t < a.nh ? t : a.wt + (t - a.nh);
    const uint32_t w = load_word(a.data, 4 * i, a.nbytes);
    s1 += w;
    s2 += w * word_pos(i);
  }
  const int q = a.k >> 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kK3Warps * kK3Span;
  const int64_t hi = a.gb - 1;            // the last group a load reads
  int64_t b = a.gh + (static_cast<int64_t>(blockIdx.x) * kK3Warps + warp) *
                         kK3Span;
  uint32_t p = word_pos(4 * (b + lane) - q);
  for (; b < a.gb; b += stride) {         // the warp's spans
    uint4 x[kK3R];
#pragma unroll
    for (int r = 0; r < kK3R; ++r) {
      const int64_t g = b + lane + 32 * r;
      x[r] = load_stream16(a.base + 16 * (g < hi ? g : hi));
    }
    uint32_t w[kK3R][4];
#pragma unroll
    for (int r = 0; r < kK3R; ++r) {
      w[r][0] = x[r].x;
      w[r][1] = x[r].y;
      w[r][2] = x[r].z;
      w[r][3] = x[r].w;
      const bool in = b + lane + 32 * r < a.gb;
#pragma unroll
      for (int c = 0; c < 4; ++c) w[r][c] = in ? w[r][c] : 0u;
    }
    if (p + (128 * (kK3R - 1) + 3) < kMPos) {   // no position wraps
      uint32_t S = 0, wc = 0;
#pragma unroll
      for (int r = 0; r < kK3R; ++r) {
        const uint32_t sr = w[r][0] + w[r][1] + w[r][2] + w[r][3];
        S += sr;
        wc += 128u * r * sr + w[r][1] + 2u * w[r][2] + 3u * w[r][3];
      }
      s1 += S;
      s2 += p * S + wc;
    } else {
#pragma unroll
      for (int r = 0; r < kK3R; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          uint32_t pw = p + 128 * r + c;      // < 2 * 65521
          pw = pw >= kMPos ? pw - kMPos : pw;
          s1 += w[r][c];
          s2 += w[r][c] * pw;
        }
    }
    p += a.pos_step;
    p = p >= kMPos ? p - kMPos : p;
  }
  // the block's partial to scratch, then a ticket; the last block adds
  // every partial
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(kFull, s1, o);
    s2 += __shfl_xor_sync(kFull, s2, o);
  }
  if (lane == 0) {
    red3[2 * warp] = s1;
    red3[2 * warp + 1] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int v = 1; v < kK3Warps; ++v) {
      s1 += red3[2 * v];
      s2 += red3[2 * v + 1];
    }
    a.part[2 * blockIdx.x] = s1;
    a.part[2 * blockIdx.x + 1] = s2;
    red3[2 * kK3Warps] = ticket_acq_rel(a.sync) == gridDim.x - 1;
  }
  __syncthreads();
  if (!red3[2 * kK3Warps]) return;
  s1 = s2 = 0;
  const int nb = static_cast<int>(gridDim.x);
  for (int j0 = 0; j0 < nb; j0 += kK3Fold * kK3Threads) {
    uint2 v[kK3Fold];                     // loads in flight together
#pragma unroll
    for (int u = 0; u < kK3Fold; ++u) {
      const int j = j0 + u * kK3Threads + static_cast<int>(threadIdx.x);
      v[u] = __ldcg(reinterpret_cast<const uint2*>(a.part) + (j < nb ? j : 0));
      if (j >= nb) v[u] = make_uint2(0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kK3Fold; ++u) {
      s1 += v[u].x;
      s2 += v[u].y;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(kFull, s1, o);
    s2 += __shfl_xor_sync(kFull, s2, o);
  }
  if (lane == 0) {
    red3[2 * warp] = s1;
    red3[2 * warp + 1] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int v = 1; v < kK3Warps; ++v) {
      s1 += red3[2 * v];
      s2 += red3[2 * v + 1];
    }
    a.out[0] = s1;
    a.out[1] = s2;
    *a.sync = 0;                          // the ticket, for the next call
  }
}

using QAKernel = void (*)(QAArgs);

// The instance for V values a group and r groups a lane (0: scalar).
QAKernel pick_kernel(int V, int r) {
  if (V == 4) {
    switch (r) {
      case 1: return qa_kernel<4, 1>;
      case 2: return qa_kernel<4, 2>;
      case 4: return qa_kernel<4, 4>;
      case 8: return qa_kernel<4, 8>;
      case 16: return qa_kernel<4, 16>;
      case 32: return qa_kernel<4, 32>;
    }
  } else if (V == 8) {
    switch (r) {
      case 1: return qa_kernel<8, 1>;
      case 2: return qa_kernel<8, 2>;
      case 4: return qa_kernel<8, 4>;
      case 8: return qa_kernel<8, 8>;
      case 16: return qa_kernel<8, 16>;
    }
  } else {
    switch (r) {
      case 1: return qa_kernel<16, 1>;
      case 2: return qa_kernel<16, 2>;
      case 4: return qa_kernel<16, 4>;
      case 8: return qa_kernel<16, 8>;
    }
  }
  return qa_kernel<4, 0>;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms < 1)
    sms = 1;
  return sms;
}

// Blocks a row: enough for every SM, at most one a warp's step.
int64_t blocks_per_row(int64_t G, int64_t nsteps, int64_t* spb) {
  const int64_t want =
      (static_cast<int64_t>(sm_count()) * kBlocksPerSM + G - 1) / G;
  int64_t b = (nsteps + kWarps - 1) / kWarps;
  if (b > want) b = want;
  int64_t s = (nsteps + b - 1) / b;
  if (s > kWarps) s = (s + kWarps - 1) / kWarps * kWarps;
  *spb = s;
  return (nsteps + s - 1) / s;
}

int launch_qa(const void* data, int64_t row_stride, int64_t row_bytes,
              int dtype, int itemsize, int64_t blk_v, int64_t nsteps,
              int64_t G, int64_t w0, int64_t v0, int64_t nw, int64_t nv,
              const void* carry_sums, const void* carry_qa,
              const void* carry_cnt, void* out_sums, void* out_qa,
              void* out_cnt, void* scratch, void* sync, void* stream) {
  if (blk_v < 8 || blk_v > kMaxBlkV || (blk_v & (blk_v - 1)) != 0 ||
      (itemsize != 1 && itemsize != 2 && itemsize != 4) ||
      (blk_v * itemsize) % 4 != 0 || nsteps < 1 || nsteps > 0x7fffffffLL ||
      G < 1 || G > 65535 || dtype < F32 || dtype > U32 || sync == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  QAArgs a;
  a.data = static_cast<const uint8_t*>(data);
  a.row_stride = row_stride;
  a.row_bytes = row_bytes;
  a.dtype = dtype;
  a.itemsize = itemsize;
  a.blk_v = static_cast<int>(blk_v);
  a.blk_w = static_cast<int>(blk_v * itemsize / 4);
  a.nsteps = nsteps;
  a.w0 = w0;
  a.v0 = v0;
  a.nw = nw;
  a.nv = nv;
  const int64_t B = blocks_per_row(G, nsteps, &a.spb);
  a.carry_sums = static_cast<const uint32_t*>(carry_sums);
  a.carry_qa = static_cast<const float*>(carry_qa);
  a.carry_cnt = static_cast<const int32_t*>(carry_cnt);
  a.out_sums = static_cast<uint32_t*>(out_sums);
  a.out_qa = static_cast<float*>(out_qa);
  a.out_cnt = static_cast<int32_t*>(out_cnt);
  a.sums = static_cast<float*>(scratch);
  a.part = static_cast<uint32_t*>(scratch) + G * nsteps;
  a.sync = static_cast<uint32_t*>(sync);
  QAKernel kernel = pick_kernel(16 / itemsize, static_cast<int>(
      blk_v / (32 * (16 / itemsize))));
  kernel<<<dim3(static_cast<unsigned>(B), static_cast<unsigned>(G)),
           kThreads, kQASmemBytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K3's grid: a block for every kK3Warps spans of the bytes, at most the
// blocks that are resident at once.
int64_t k3_blocks(int64_t nbytes) {
  const int64_t per = static_cast<int64_t>(kK3Warps) * kK3Span;
  const int64_t most = static_cast<int64_t>(sm_count()) * kK3BlocksPerSM;
  const int64_t b = (nbytes / 16 + per - 1) / per;
  return b < 1 ? 1 : (b > most ? most : b);
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of the scratch that K1 and K2 take for G rows of nsteps steps: the
// step sums and, at most one block a warp's step, 8 words a block.
int64_t repro_qa_scratch_bytes(int64_t G, int64_t nsteps) {
  return 4 * G * nsteps + 32 * G * ((nsteps + kWarps - 1) / kWarps);
}

// Words of the ticket buffer that K1 and K2 take for G rows: zero before
// the first call, and every call leaves it zero. Calls that may run at
// once (other streams) need buffers of their own.
int64_t repro_qa_sync_words(int64_t G) { return G; }

// K1: G rows of `row_bytes` bytes each, `row_stride` apart; nv values and nw
// words per row. Outputs uint32 (G,2), f32 (G,3), int32 (G,1).
int repro_qa_checksum(const void* data, int64_t row_stride, int64_t row_bytes,
                      int dtype, int itemsize, int64_t blk_v, int64_t nsteps,
                      int64_t G, int64_t nw, int64_t nv, void* out_sums,
                      void* out_qa, void* out_cnt, void* scratch, void* sync,
                      void* stream) {
  return launch_qa(data, row_stride, row_bytes, dtype, itemsize, blk_v, nsteps,
                   G, 0, 0, nw, nv, nullptr, nullptr, nullptr, out_sums,
                   out_qa, out_cnt, scratch, sync, stream);
}

// K2: `nbytes` bytes (a whole number of values) of one array starting at
// global word w0 / value v0, folded as `nsteps` blocks into the carry; the
// new carry goes to out_*.
int repro_qa_chunk(const void* data, int64_t nbytes, int dtype, int itemsize,
                   int64_t blk_v, int64_t nsteps, int64_t w0, int64_t v0,
                   int64_t nw, int64_t nv, const void* carry_sums,
                   const void* carry_qa, const void* carry_cnt, void* out_sums,
                   void* out_qa, void* out_cnt, void* scratch, void* sync,
                   void* stream) {
  if (carry_sums == nullptr || carry_qa == nullptr || carry_cnt == nullptr ||
      itemsize < 1 || nbytes % itemsize != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_qa(data, nbytes, nbytes, dtype, itemsize, blk_v, nsteps, 1, w0,
                   v0, nw, nv, carry_sums, carry_qa, carry_cnt, out_sums,
                   out_qa, out_cnt, scratch, sync, stream);
}

// Bytes of the scratch that K3 takes for `nbytes` bytes: a block's partial.
int64_t repro_device_checksum_scratch_bytes(int64_t nbytes) {
  return 8 * k3_blocks(nbytes);
}

// K3: s1/s2 over the words of the `nbytes` bytes at `data` (any alignment)
// into out[2], in one launch. `sync`: a ticket buffer of
// repro_qa_sync_words(1) words, zero before the call and left zero.
int repro_device_checksum(const void* data, int64_t nbytes, void* out,
                          void* scratch, void* sync, void* stream) {
  if (nbytes < 0 || sync == nullptr || scratch == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  K3Args a;
  a.data = static_cast<const uint8_t*>(data);
  a.k = static_cast<int>(reinterpret_cast<uintptr_t>(data) & 15);
  a.base = a.data - a.k;
  a.nbytes = nbytes;
  a.nw = (nbytes + 3) / 4;
  const int q = a.k >> 2;
  if (a.k & 3) {                          // no body: every word bytewise
    a.gh = a.gb = 0;
    a.nh = a.wt = a.nw;
  } else {
    a.gh = a.k ? 1 : 0;
    // the last group whose words lie wholly inside the bytes
    a.gb = (a.k + nbytes) / 16;
    if (a.gb < a.gh) a.gb = a.gh;
    a.nh = 4 * a.gh - q < a.nw ? 4 * a.gh - q : a.nw;
    a.wt = 4 * a.gb - q;
  }
  const int64_t blocks = k3_blocks(nbytes);
  a.pos_step = static_cast<uint32_t>(4 * blocks * kK3Warps * kK3Span % kMPos);
  a.part = static_cast<uint32_t*>(scratch);
  a.sync = static_cast<uint32_t*>(sync);
  a.out = static_cast<uint32_t*>(out);
  transfer_kernel<<<static_cast<unsigned>(blocks), kK3Threads,
                     (2 * kK3Warps + 1) * sizeof(uint32_t),
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
