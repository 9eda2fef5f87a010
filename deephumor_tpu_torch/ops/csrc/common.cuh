// Shared helpers for the deephumor_tpu_torch kernels: element loads in
// either storage type, warp/block reductions, and the dtype codes the
// Python wrappers pass (0 = float32, 1 = bfloat16).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dh {

enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide reductions over blockDim.x threads (a multiple of 32, at most
// 1024). `scratch` holds 32 ints; every thread gets the result. Both end
// with a barrier, so `scratch` may be reused by the next call.
__device__ __forceinline__ int block_sum(int v, int* scratch) {
  v = __reduce_add_sync(0xffffffffu, v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int t = lane < nwarps ? scratch[lane] : 0;
  t = __reduce_add_sync(0xffffffffu, t);
  __syncthreads();
  return t;
}
__device__ __forceinline__ int block_max(int v, int* scratch) {
  v = __reduce_max_sync(0xffffffffu, v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int t = lane < nwarps ? scratch[lane] : INT32_MIN;
  t = __reduce_max_sync(0xffffffffu, t);
  __syncthreads();
  return t;
}

// Softmax of one row of `n` f32 energies in place, by one warp. Each
// weight is rounded to the value storage type T (the attention kernels
// cast their weights to the cache dtype before the AV product).
template <typename T>
__device__ __forceinline__ void warp_softmax_round(float* e, int n) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int i = lane; i < n; i += 32) m = fmaxf(m, e[i]);
  m = warp_max(m);
  float s = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float w = expf(e[i] - m);
    e[i] = w;
    s += w;
  }
  s = warp_sum(s);
  for (int i = lane; i < n; i += 32) e[i] = to_f32(from_f32<T>(e[i] / s));
}

// Copies `rows` rows of `vecs` 16-byte vectors each into shared memory
// at a row stride of `ld` 4-byte words (odd, so that threads reading one
// column of consecutive rows hit distinct banks). `src(r)` is row r's
// first vector in device memory. Each thread issues up to kUnroll loads
// before it stores any, so the copy is not one memory latency per vector.
template <typename Src>
__device__ __forceinline__ void stage_rows(uint32_t* dst, int ld, int rows,
                                           int vecs, const Src& src) {
  constexpr int kUnroll = 8;
  const int total = rows * vecs;
  for (int base = threadIdx.x; base < total; base += kUnroll * blockDim.x) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * blockDim.x;
      if (t < total) v[u] = src(t / vecs)[t % vecs];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * blockDim.x;
      if (t < total) {
        uint32_t* d = dst + (t / vecs) * ld + 4 * (t % vecs);
        d[0] = v[u].x;
        d[1] = v[u].y;
        d[2] = v[u].z;
        d[3] = v[u].w;
      }
    }
  }
}

// Dot product of `n` f32 values in shared memory with `n` values of T.
template <typename T>
__device__ __forceinline__ float dot(const float* a, const T* b, int n) {
  float acc = 0.f;
  for (int d = 0; d < n; ++d) acc = fmaf(a[d], to_f32(b[d]), acc);
  return acc;
}

}  // namespace dh
