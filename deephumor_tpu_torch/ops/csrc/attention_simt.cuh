// The CUDA-core body of the ancestry attention kernels in f32, and in bf16
// at a head_dim the tensor-core bodies do not take (K1 in
// ancestry_attention.cu; K6 and K7 in ancestry_attention_ids.cu): exact f32
// arithmetic (TF32 tensor cores would round q and K to 10 bits), one
// (item, head) per block.
//
// The rows cannot all be staged (beam 7 x p_eff 128 in f32 is ~460 KB), so
// they go through shared memory a tile of `tile` rows at a time, in two
// passes: pass 1 stages K tile by tile and leaves every energy (f32, the
// only buffer that grows with the prefix) in shared memory; one softmax per
// branch follows, weights normalised and then rounded to T; pass 2 stages
// V tile by tile and each thread adds its own (branch, column) sums in
// shared memory. Rows come from a `Rows` source as in attention_mma.cuh
// (index, k, v, bias).
#pragma once

#include "common.cuh"

namespace dh {
namespace simt {

constexpr int kThreads = 256;
constexpr int kTileRows = 256;

// The staged tile's rows (at most kTileRows) and the dynamic shared memory
// of a block over `n` rows of `beam` queries.
__host__ __device__ inline int tile_rows(int n) {
  return n < kTileRows ? n : kTileRows;
}
inline size_t smem_bytes(int n, int beam, int hd, int elt) {
  return 4 * ((size_t)tile_rows(n) * (hd * elt / 4 + 1)
              + 2 * (size_t)beam * hd + (size_t)beam * n);
}

// Attention of the queries q[j * ldq + d] (j < beam, d < hd) over the `n`
// rows of `rows`; writes out[j * ldo + d]. Called by all threads of the
// block with smem_bytes(n, beam, hd, sizeof(T)) bytes at `smem`.
template <typename T, typename Rows>
__device__ __forceinline__ void attend(const Rows& rows, const T* q, int ldq,
                                       T* out, int ldo, int n, int beam,
                                       int hd, float inv_scale,
                                       uint32_t* smem) {
  const int tile = tile_rows(n);
  const int wpr = hd * (int)sizeof(T) / 4;  // 4-byte words per row
  const int ld = wpr + 1;                    // odd: conflict-free columns
  uint32_t* ts = smem;                                     // [tile][ld]
  float* qs = reinterpret_cast<float*>(ts + tile * ld);    // [beam][hd]
  float* acc = qs + beam * hd;                             // [beam][hd]
  float* e = acc + beam * hd;                              // [beam][n]
  auto row = [&](int r) { return reinterpret_cast<const T*>(ts + r * ld); };

  for (int t = threadIdx.x; t < beam * hd; t += blockDim.x) {
    qs[t] = to_f32(q[(size_t)(t / hd) * ldq + t % hd]);
    acc[t] = 0.f;
  }
  for (int r0 = 0; r0 < n; r0 += tile) {
    const int nt = min(tile, n - r0);
    __syncthreads();  // the previous tile is consumed; q is staged
    stage_rows(ts, ld, nt, wpr / 4, [&](int r) {
      return reinterpret_cast<const uint4*>(rows.k(rows.index(r0 + r)));
    });
    __syncthreads();
    for (int t = threadIdx.x; t < beam * nt; t += blockDim.x) {
      const int j = t / nt, r = r0 + t % nt;
      e[j * n + r] = dot(qs + j * hd, row(t % nt), hd) * inv_scale
                     + *rows.bias(j, r, rows.index(r));
    }
  }
  __syncthreads();

  for (int j = threadIdx.x >> 5; j < beam; j += blockDim.x >> 5)
    warp_softmax_round<T>(e + j * n, n);

  for (int r0 = 0; r0 < n; r0 += tile) {
    const int nt = min(tile, n - r0);
    __syncthreads();  // weights are final; the previous tile is consumed
    stage_rows(ts, ld, nt, wpr / 4, [&](int r) {
      return reinterpret_cast<const uint4*>(rows.v(rows.index(r0 + r)));
    });
    __syncthreads();
    for (int t = threadIdx.x; t < beam * hd; t += blockDim.x) {
      const int j = t / hd, d = t % hd;
      const float* wt = e + j * n + r0;
      float a = acc[t];
      for (int r = 0; r < nt; ++r) a = fmaf(wt[r], to_f32(row(r)[d]), a);
      acc[t] = a;
    }
  }
  // each thread wrote only its own acc entries
  for (int t = threadIdx.x; t < beam * hd; t += blockDim.x)
    out[(size_t)(t / hd) * ldo + t % hd] = from_f32<T>(acc[t]);
}

}  // namespace simt
}  // namespace dh
