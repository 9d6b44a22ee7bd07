// The latency of a chain of dependent f32 adds on one thread, for
// tools/k12_ab.py: the floor under the sequential fold of K1 and K2
// (src/repro_torch/kernels/checksum/csrc/checksum.cu), which adds one step
// sum at a time in step order.
//
//   repro_fadd_chain(in, n, reps, variant, out, stream)
//
// One block stages n floats in shared memory; then they are added into one
// accumulator `reps` times over, one add after another, in one of these
// ways (out[0] the sum, out[1] the cycles, as doubles):
//   0  thread 0, the fold's form (checksum.cu's chain): float4 reads of 16
//      into two register sets in turn, each a batch ahead, no branch
//   1  thread 0, one float read an add, unrolled 32
//   2  thread 0, float4 reads of 32 into two register sets in turn, each
//      load behind a branch (ptxas issues it after the other set's adds)
//   3  warp 0, each lane holding a float, lane 0 adding the lanes' floats
//      in order through __shfl_sync
//   4  thread 0, one value held in a register (the add's own latency)
//   5  thread 0, float4 reads of 32 a batch ahead behind a branch, then
//      moved into the batch being added (ptxas issues them after the adds)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ float add_batch(float acc, const float4 (&x)[8]) {
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    acc += x[u].x;
    acc += x[u].y;
    acc += x[u].z;
    acc += x[u].w;
  }
  return acc;
}

template <int kVar>
__global__ void fadd_chain_kernel(const float* in, int n, int reps,
                                  double* out) {
  extern __shared__ float s[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = in[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= (kVar == 3 ? 32 : 1)) return;
  const float4* s4 = reinterpret_cast<const float4*>(s);
  const int nb = n / 32;
  float acc = 0.0f;
  const long long t0 = clock64();
  for (int r = 0; r < reps; ++r) {
    if (kVar == 0) {
      const int nb16 = n / 16;
      float4 x[4], y[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) x[u] = s4[u];
      int b = 0;
      for (; b + 1 < nb16; b += 2) {
        const int bx = b + 2 < nb16 ? b + 2 : nb16 - 1;
#pragma unroll
        for (int u = 0; u < 4; ++u) y[u] = s4[4 * (b + 1) + u];
        acc = add16(acc, x);
#pragma unroll
        for (int u = 0; u < 4; ++u) x[u] = s4[4 * bx + u];
        acc = add16(acc, y);
      }
      if (b < nb16) acc = add16(acc, x);
    } else if (kVar == 1) {
#pragma unroll 32
      for (int j = 0; j < n; ++j) acc += s[j];
    } else if (kVar == 2) {
      float4 x[8], y[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) x[u] = s4[u];
      for (int b = 0; b < nb; b += 2) {
        if (b + 1 < nb)
#pragma unroll
          for (int u = 0; u < 8; ++u) y[u] = s4[8 * (b + 1) + u];
        acc = add_batch(acc, x);
        if (b + 2 < nb)
#pragma unroll
          for (int u = 0; u < 8; ++u) x[u] = s4[8 * (b + 2) + u];
        if (b + 1 < nb) acc = add_batch(acc, y);
      }
    } else if (kVar == 3) {
      for (int b = 0; b < nb; b += 8) {
        float v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) v[u] = s[32 * (b + u) + lane];
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int j = 0; j < 32; ++j)
            acc += __shfl_sync(0xffffffffu, v[u], j);
      }
    } else if (kVar == 5) {
      float4 cur[8], nxt[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) cur[u] = s4[u];
      for (int b = 0; b < nb; ++b) {
        if (b + 1 < nb)
#pragma unroll
          for (int u = 0; u < 8; ++u) nxt[u] = s4[8 * (b + 1) + u];
        acc = add_batch(acc, cur);
#pragma unroll
        for (int u = 0; u < 8; ++u) cur[u] = nxt[u];
      }
    } else {
      const float v = s[r & 31];
      for (int b = 0; b < nb; ++b)
#pragma unroll
        for (int u = 0; u < 32; ++u) acc += v;
    }
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0) {
    out[0] = acc;
    out[1] = static_cast<double>(t1 - t0);
  }
}

}  // namespace

extern "C" {

const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// n: a multiple of 256, at most 12,288 (48 KB of shared memory).
int repro_fadd_chain(const void* in, int n, int reps, int variant, void* out,
                     void* stream) {
  if (n < 256 || n % 256 != 0 || n > 12288 || reps < 1 || variant < 0 ||
      variant > 5)
    return static_cast<int>(cudaErrorInvalidValue);
  void (*k)(const float*, int, int, double*) =
      variant == 0 ? fadd_chain_kernel<0> : variant == 1 ? fadd_chain_kernel<1>
      : variant == 2 ? fadd_chain_kernel<2> : variant == 3 ? fadd_chain_kernel<3>
      : variant == 4 ? fadd_chain_kernel<4> : fadd_chain_kernel<5>;
  k<<<1, 256, n * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), n, reps, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
