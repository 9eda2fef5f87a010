// The expert layer's memory-bound steps around its grouped products
// (ops/moe.py, models/mla_moe.py): the gather of the held pairs' token
// rows into expert order, the SwiGLU between the two grouped products, and
// the weighted combine of the held pairs' outputs with the shared experts'.
//
// A layer that holds some of the routed experts sorts every (token, expert)
// pair, the held pairs first in expert order, and sizes its buffers for
// every pair held, so that a captured step has static shapes. How many
// pairs are held is a count in device memory (the last of the grouped
// products' offsets), read by each kernel: the gather and the SwiGLU touch
// only the held rows (about a quarter at four cards' experts), and the
// combine reads only the held pairs' outputs. The combine sums in f32 in a
// fixed order (the token's pairs in routing order, after the shared
// experts' row), so a replay is bit-equal to an eager call.
//
// bf16 rows of D values (a multiple of 8: 16-byte vectors); grid-stride
// loops over the worst case's vectors, each thread a 16-byte vector.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

// dst row r < count: src row order[r] / k (the token of sorted pair r).
__global__ void moe_gather_kernel(const uint4* __restrict__ src,
                                  const long long* __restrict__ order,
                                  uint4* __restrict__ dst,
                                  const int* __restrict__ count, int k,
                                  int vecs) {
  const long long n = (long long)__ldg(count) * vecs;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / vecs, v = i - r * vecs;
    dst[i] = __ldg(src + __ldg(order + r) / k * vecs + v);
  }
}

// a row r < count: silu(gate) * up of gu's row [gate | up] (`vecs` vectors
// each half), in f32, rounded once.
__global__ void moe_swiglu_kernel(const uint4* __restrict__ gu,
                                  uint4* __restrict__ a,
                                  const int* __restrict__ count, int vecs) {
  const long long n = (long long)__ldg(count) * vecs;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / vecs, v = i - r * vecs;
    float g[8], u[8];
    unpack(__ldg(gu + 2 * r * vecs + v), g);
    unpack(__ldg(gu + (2 * r + 1) * vecs + v), u);
#pragma unroll
    for (int e = 0; e < 8; ++e) g[e] = g[e] / (1.f + expf(-g[e])) * u[e];
    a[i] = pack(g);
  }
}

// out row t: base row t + the sum over its k pairs p (in order) that are
// held of w[p] * y row inv[p], in f32.
__global__ void moe_combine_kernel(const uint4* __restrict__ base,
                                   const uint4* __restrict__ y,
                                   const long long* __restrict__ inv,
                                   const float* __restrict__ w,
                                   const bool* __restrict__ held,
                                   uint4* __restrict__ out, long long tokens,
                                   int k, int vecs) {
  const long long n = tokens * vecs;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long t = i / vecs, v = i - t * vecs;
    float acc[8], f[8];
    unpack(__ldg(base + i), acc);
    for (int j = 0; j < k; ++j) {
      const long long p = t * k + j;
      if (!held[p]) continue;
      const float wp = __ldg(w + p);
      unpack(__ldg(y + __ldg(inv + p) * vecs + v), f);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += wp * f[e];
    }
    out[i] = pack(acc);
  }
}

int grid_for(long long vectors) {
  const long long want = (vectors + 255) / 256;
  const long long most = 16LL * dh::sm_count();
  return (int)(want < 1 ? 1 : want < most ? want : most);
}

}  // namespace

// dst [P, D] rows r < *count: src [T, D] row order[r] / k.
extern "C" int dh_moe_gather(const void* src, const void* order, void* dst,
                             const void* count, int pairs, int k, int D,
                             void* stream) {
  const int vecs = D / 8;
  moe_gather_kernel<<<grid_for((long long)pairs * vecs), 256, 0,
                      (cudaStream_t)stream>>>(
      (const uint4*)src, (const long long*)order, (uint4*)dst,
      (const int*)count, k, vecs);
  return cudaGetLastError();
}

// a [P, I] rows r < *count: silu(gu[r, :I]) * gu[r, I:].
extern "C" int dh_moe_swiglu(const void* gu, void* a, const void* count,
                             int pairs, int I, void* stream) {
  const int vecs = I / 8;
  moe_swiglu_kernel<<<grid_for((long long)pairs * vecs), 256, 0,
                      (cudaStream_t)stream>>>(
      (const uint4*)gu, (uint4*)a, (const int*)count, vecs);
  return cudaGetLastError();
}

// out [T, D] = base + sum of the held pairs' w * y rows (inv: each pair's
// row of y; w f32, held bool, both [T * k]).
extern "C" int dh_moe_combine(const void* base, const void* y,
                              const void* inv, const void* w,
                              const void* held, void* out, int tokens, int k,
                              int D, void* stream) {
  const int vecs = D / 8;
  moe_combine_kernel<<<grid_for((long long)tokens * vecs), 256, 0,
                       (cudaStream_t)stream>>>(
      (const uint4*)base, (const uint4*)y, (const long long*)inv,
      (const float*)w, (const bool*)held, (uint4*)out, tokens, k, vecs);
  return cudaGetLastError();
}
